// SDF evaluators for the sphere tracer on the bf16 tensor cores: the coarse
// K1 and K2, bf16 operands with f32 accumulation (the JAX package's coarse
// precision class), and the accurate K4, three bf16 passes on split operands.
//
// K2, iron_sdf_only_bf16, replaces the TPU kernel of
//   iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_only_bf16_fn (_sdf_only_kernel_bf16):
//   x [N,3] -> sdf [N].
// K1, iron_coarse_march_bf16, replaces
//   iron_tpu/kernels/fused_sdf.py::make_pallas_coarse_march_fn (_march_kernel_bf16):
//   the whole masked coarse march, acc += sdf(ro + rd*acc) until |sdf| <= thr or
//   acc >= max_dis, for at most n_iters steps.
// K4, iron_sdf_only_3pass, replaces
//   iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_only_3pass_fn
//   (_sdf_only_kernel_3pass, _fused_sdf_panel_3pass): x [N,3] -> sdf [N] at
//   f32-class accuracy, every product hi*Whi + hi*Wlo + lo*Whi (mlp_eval<3>).
//   Three times K2's tensor-core work, 3 x 459,008 MACs a point, against the
//   same 16 bytes a point, so it is bound by tensor-core operations as K2 is;
//   it reads twice K2's weights (hi and lo, about 2.2 MB) from L2.  Not ported
//   from the TPU kernel: its 128-lane PE panel and lane masks, which exist for
//   Mosaic's layouts.
//
// What bounds them on an H100: the chain is 9 dense layers of 256 per point,
// about 0.92 MFLOP a point (459,008 MACs to the sdf column) against 12-40
// bytes of input and output, so both are bound by tensor-core operations, not
// by device memory.  The bf16 weights (about 1.1 MB) do not fit in a block's
// shared memory; each block keeps only
// its 64-row activation tile on chip (two 33 KB bf16 buffers and the PE tile)
// and streams every layer's weights from L2 as pre-packed mma fragments.  K1
// keeps the ray state in shared memory and registers for all iterations and
// leaves its loop when no ray of the block is active (__syncthreads_or), the
// counterpart of the TPU kernel's per-tile early exit.
#include "sdf_mlp_bf16.cuh"

using namespace iron;

namespace {

// y[r] = x[row0 + r] * scale for the block's 64 rows (zero past n).
__device__ __forceinline__ void load_scaled(float (*y)[3], const float* __restrict__ x, int n,
                                            int row0, float scale) {
  for (int i = threadIdx.x; i < ROWS * 3; i += THREADS) {
    const int r = i / 3, j = i % 3;
    y[r][j] = (row0 + r < n) ? x[(size_t)(row0 + r) * 3 + j] * scale : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
sdf_only_bf16_kernel(const float* __restrict__ x, int n,
                     const uint2* __restrict__ wpack, const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ wlast, int n_layers, int skip,
                     int d_embed, float scale, float inv_scale, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MlpSmem<1>& sm = *reinterpret_cast<MlpSmem<1>*>(smem_raw);
  const int row0 = blockIdx.x * ROWS;
  load_scaled(sm.y, x, n, row0, scale);
  __syncthreads();
  fill_pe(sm, d_embed);
  __syncthreads();
  mlp_eval(sm, wpack, nullptr, bias, wlast, nullptr, n_layers, skip);
  if (threadIdx.x < ROWS && row0 + threadIdx.x < n)
    out[row0 + threadIdx.x] = sm.out[threadIdx.x] * inv_scale;
}

__global__ void __launch_bounds__(THREADS)
sdf_only_3pass_kernel(const float* __restrict__ x, int n, const uint2* __restrict__ whi,
                      const uint2* __restrict__ wlo, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ wlast_hi,
                      const __nv_bfloat16* __restrict__ wlast_lo, int n_layers, int skip,
                      int d_embed, float scale, float inv_scale, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MlpSmem<3>& sm = *reinterpret_cast<MlpSmem<3>*>(smem_raw);
  const int row0 = blockIdx.x * ROWS;
  load_scaled(sm.y, x, n, row0, scale);
  __syncthreads();
  fill_pe(sm, d_embed);
  __syncthreads();
  mlp_eval(sm, whi, wlo, bias, wlast_hi, wlast_lo, n_layers, skip);
  if (threadIdx.x < ROWS && row0 + threadIdx.x < n)
    out[row0 + threadIdx.x] = sm.out[threadIdx.x] * inv_scale;
}

__global__ void __launch_bounds__(THREADS)
coarse_march_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                    const float* __restrict__ acc0, const uint8_t* __restrict__ work,
                    const float* __restrict__ max_dis, int n, int n_iters, float thr,
                    const uint2* __restrict__ wpack, const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ wlast, int n_layers, int skip,
                    int d_embed, float scale, float inv_scale,
                    float* __restrict__ acc_out, float* __restrict__ sdf_out,
                    uint8_t* __restrict__ act_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MlpSmem<1>& sm = *reinterpret_cast<MlpSmem<1>*>(smem_raw);
  const int row0 = blockIdx.x * ROWS;
  const int r = threadIdx.x;              // ray owned by threads 0..63
  const bool owner = r < ROWS;
  const bool valid = owner && (row0 + r < n);
  float acc = 0.0f, s = 0.0f, md = 0.0f;
  bool wk = false, act = false;
  if (owner) {
    for (int j = 0; j < 3; ++j) {
      sm.ro[r][j] = valid ? ray_o[(size_t)(row0 + r) * 3 + j] : 0.0f;
      sm.rd[r][j] = valid ? ray_d[(size_t)(row0 + r) * 3 + j] : 0.0f;
    }
    if (valid) {
      acc = acc0[row0 + r];
      md = max_dis[row0 + r];
      wk = work[row0 + r] != 0;
    }
  }

  // sdf at ro + rd*acc for every row of the block -> returned to the owners
  auto eval = [&](float a) -> float {
    if (owner)
      for (int j = 0; j < 3; ++j) sm.y[r][j] = (sm.ro[r][j] + sm.rd[r][j] * a) * scale;
    __syncthreads();
    fill_pe(sm, d_embed);
    __syncthreads();
    mlp_eval(sm, wpack, nullptr, bias, wlast, nullptr, n_layers, skip);
    return owner ? sm.out[r] * inv_scale : 0.0f;
  };

  s = eval(acc);
  act = wk && fabsf(s) > thr && acc < md;
  for (int i = 0; i < n_iters; ++i) {
    if (!__syncthreads_or(act ? 1 : 0)) break;
    const float acc2 = acc + (act ? s : 0.0f);
    const float s_new = eval(acc2);
    const float s2 = act ? s_new : s;
    act = act && fabsf(s2) > thr && acc2 < md;
    acc = acc2;
    s = s2;
  }
  if (valid) {
    acc_out[row0 + r] = acc;
    sdf_out[row0 + r] = s;
    act_out[row0 + r] = act ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int iron_mlp_smem_bytes() { return (int)sizeof(MlpSmem<1>); }

const char* iron_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int iron_sdf_only_bf16(const float* x, int n, const void* wpack, const float* bias,
                       const void* wlast, int n_layers, int skip, int d_embed,
                       float scale, float* out, void* stream) {
  if (n <= 0) return 0;
  const int smem = (int)sizeof(MlpSmem<1>);
  cudaError_t e = cudaFuncSetAttribute(sdf_only_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + ROWS - 1) / ROWS;
  sdf_only_bf16_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, n, (const uint2*)wpack, bias, (const __nv_bfloat16*)wlast, n_layers, skip,
      d_embed, scale, 1.0f / scale, out);
  return (int)cudaGetLastError();
}

int iron_coarse_march_bf16(const float* ray_o, const float* ray_d, const float* acc0,
                           const void* work, const float* max_dis, int n, int n_iters,
                           float threshold, const void* wpack, const float* bias,
                           const void* wlast, int n_layers, int skip, int d_embed,
                           float scale, float* acc_out, float* sdf_out, void* act_out,
                           void* stream) {
  if (n <= 0) return 0;
  const int smem = (int)sizeof(MlpSmem<1>);
  cudaError_t e = cudaFuncSetAttribute(coarse_march_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + ROWS - 1) / ROWS;
  coarse_march_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      ray_o, ray_d, acc0, (const uint8_t*)work, max_dis, n, n_iters, threshold,
      (const uint2*)wpack, bias, (const __nv_bfloat16*)wlast, n_layers, skip, d_embed,
      scale, 1.0f / scale, acc_out, sdf_out, (uint8_t*)act_out);
  return (int)cudaGetLastError();
}

int iron_sdf_only_3pass(const float* x, int n, const void* whi, const void* wlo,
                        const float* bias, const void* wlast_hi, const void* wlast_lo,
                        int n_layers, int skip, int d_embed, float scale, float* out,
                        void* stream) {
  if (n <= 0) return 0;
  const int smem = (int)sizeof(MlpSmem<3>);
  cudaError_t e = cudaFuncSetAttribute(sdf_only_3pass_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + ROWS - 1) / ROWS;
  sdf_only_3pass_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, n, (const uint2*)whi, (const uint2*)wlo, bias, (const __nv_bfloat16*)wlast_hi,
      (const __nv_bfloat16*)wlast_lo, n_layers, skip, d_embed, scale, 1.0f / scale, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
