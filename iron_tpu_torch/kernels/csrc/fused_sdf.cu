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
//   f32-class accuracy, every product hi*Whi + hi*Wlo + lo*Whi (split3.cuh).
//   See the note above sdf_only_3pass_kernel.
//
// What bounds K1 and K2 on an H100: the chain is 9 dense layers of 256 per
// point, about 0.92 MFLOP a point (459,008 MACs to the sdf column) against
// 12-40 bytes of input and output, so both are bound by tensor-core
// operations, not by device memory.  The bf16 weights (about 1.1 MB) do not
// fit in a block's shared memory; each block keeps only its 64-row activation
// tile on chip (two 33 KB bf16 buffers and the PE tile) and streams every
// layer's weights from L2 as pre-packed mma fragments (sdf_mlp_bf16.cuh).  K1
// keeps the ray state in shared memory and registers for all iterations and
// leaves its loop when no ray of the block is active (__syncthreads_or), the
// counterpart of the TPU kernel's per-tile early exit.
#include "sdf_mlp_bf16.cuh"
#include "split3.cuh"

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
  MlpSmem& sm = *reinterpret_cast<MlpSmem*>(smem_raw);
  const int row0 = blockIdx.x * ROWS;
  load_scaled(sm.y, x, n, row0, scale);
  __syncthreads();
  fill_pe(sm, d_embed);
  __syncthreads();
  mlp_eval(sm, wpack, bias, wlast, n_layers, skip);
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
  MlpSmem& sm = *reinterpret_cast<MlpSmem*>(smem_raw);
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
    mlp_eval(sm, wpack, bias, wlast, n_layers, skip);
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


// ---------------------------------------------------------------------------
// K4.  A call of the training step's tracer holds about 1,850 points (29
// tiles of 64), so one 64-row tile a block would run 29 blocks on 132 SMs.
// Here a thread block cluster of CS CTAs takes each 64-row tile and splits
// every hidden layer by its columns: CTA r computes the 256 / CS output
// columns from 256 r / CS, 4 m-tiles x 32 / CS n-tiles of m16n8k16 (each
// warp 4 / CS m-tiles x 4 n-tiles), and its epilogue writes the
// bf16 hi and lo halves of softplus(z) for those columns into its next
// activation tile, then copies that block into the other CTAs' tiles in
// 16-byte stores (distributed shared memory, sm90.cuh::cluster_spread); the
// cluster meets at one barrier a layer.  That exchange, the barrier and the
// epilogue cost a CTA about as much a layer whatever its width, as much as
// the mma of a 64-column layer (scripts/trace_kernels_torch.py), so the
// cluster is as narrow as the call allows: CS is the smallest of 1, 2, 4 for which the
// call's CS x tiles CTAs cover the SMs (kernels/fused_sdf.py::k4_width).  The step's
// calls of ~1,850 points run CS = 4, 116 CTAs; 262,144 points run CS = 1,
// one CTA a tile, 4,096 CTAs.
//
// Per tile the product rate is set by how the operands reach the tensor
// cores.  A fragments come from the activation tile with ldmatrix (two per
// k-tile, m-tile and warp, hi and lo).  B fragments, hi and lo, go from L2
// straight into registers with __ldg, PF = 4 k-tiles ahead of their use,
// in one stream through every layer in the order of the packed matrices, so
// that the first k-tiles of a layer are in flight during the epilogue of the
// layer before.  On an H100 this beats staging the weights in shared
// memory: a CTA streams L2 faster with __ldg than with cp.async into a ring,
// and a 64 KB cp.async ring completed on mbarriers made the 262,144-point
// call 24% slower than __ldg (PERF.md; scripts/ablate_k4_torch.py also
// times PF = 2 and 8).  Each warp issues its mma pass by pass
// (split3.cuh::mma3_bf16).  wgmma (M = 64 from shared memory) is not used:
// it needs B in shared memory, and the three passes read the A tile twice
// and B twice.  The epilogue's softplus uses the SFU's exp and log
// (softplus100_fast): the precise libm pair took a third of a width-1 layer.
//
// Shared memory 150 KB a CTA (activation tiles 2 buffers x hi/lo 135 KB, PE
// hi/lo 14 KB), one CTA an SM; 124, 151 and 200 registers at CS = 4, 2, 1
// (ptxas, no spills).  The final layer (the sdf column, 3 x 256
// MACs a row) runs on the CUDA cores: CTA r takes rows [64 r / CS,
// 64 (r + 1) / CS).
namespace k4 {

constexpr int KT_WORDS = N_TILES * 32;   // uint2 in a packed k-tile (256 columns)
constexpr int PF = 4;                    // k-tiles of B fragments in flight

template <int CS>
struct Cfg {
  static constexpr int OWN_NT = N_TILES / CS;                 // n-tiles a CTA owns
  static constexpr int MTW = 4 / CS;                          // m-tiles a warp computes
  static constexpr int WM = 4 / MTW;                          // warps along the rows
  static constexpr int NTW = OWN_NT / (THREADS / 32 / WM);    // n-tiles a warp computes (4)
};

struct Smem {
  __nv_bfloat16 act[2][2][ROWS * H_STRIDE];   // [buffer][hi, lo] activation tiles
  __nv_bfloat16 pe[2][ROWS * P_STRIDE];       // PE tile, hi and lo
  float y[ROWS][3];
};

// The m16n8k16 A fragment of rows [16 mt, 16 mt + 16) and columns
// [16 kt, 16 kt + 16) of a bf16 tile (row stride `stride`), by ldmatrix.
__device__ __forceinline__ void load_a_ldm(const __nv_bfloat16* A, int stride, int mt, int kt,
                                           uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, A + (mt * 16 + (lane & 15)) * stride + kt * 16 + (lane >> 4) * 8);
}

// softplus(100 z) / 100 = max(t, 0) + log(1 + e^-|t|), t = 100 z, with the
// SFU's exp and log: within 1e-8 (and an ulp) of softplus100, far below the
// 2^-17 of v that the hi/lo split keeps.
__device__ __forceinline__ float softplus100_fast(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + __logf(1.0f + __expf(-fabsf(t)))) * 0.01f;
}

}  // namespace k4

template <int CS>
__global__ void __launch_bounds__(THREADS, 1)
sdf_only_3pass_kernel(const float* __restrict__ x, int n, const uint2* __restrict__ whi,
                      const uint2* __restrict__ wlo, int n_ktiles,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ wlast_hi,
                      const __nv_bfloat16* __restrict__ wlast_lo, int n_layers, int skip,
                      int d_embed, float scale, float inv_scale, float* __restrict__ out) {
  using namespace k4;
  using C = Cfg<CS>;
  constexpr int MTW = C::MTW, NTW = C::NTW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = CS == 1 ? 0 : cluster_rank();
  const int row0 = (blockIdx.x / CS) * ROWS;
  // this warp's first m-tile and first n-tile (of the CTA's own)
  const int mt0 = MTW * (warp % C::WM), nt0 = NTW * (warp / C::WM);

  // The weight stream: k-tile c of the packed matrices in layer order.  Slot
  // c % PF of bh / bl holds this lane's B fragments of k-tile c, hi and lo,
  // for the warp's NTW n-tiles, loaded PF k-tiles before their use.
  const size_t lane_off = (size_t)(rank * C::OWN_NT + nt0) * 32 + lane;
  uint2 bh[PF][NTW], bl[PF][NTW];
  auto fetch = [&](int c, uint2 (&h)[NTW], uint2 (&l)[NTW]) {
    if (c >= n_ktiles) return;
    const size_t o = (size_t)c * KT_WORDS + lane_off;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      h[j] = __ldg(whi + o + j * 32);
      l[j] = __ldg(wlo + o + j * 32);
    }
  };
#pragma unroll
  for (int i = 0; i < PF; ++i) fetch(i, bh[i], bl[i]);

  load_scaled(sm.y, x, n, row0, scale);
  __syncthreads();
  for (int i = tid; i < ROWS * PE_W / 2; i += THREADS) {
    const int r = i / (PE_W / 2), c = 2 * (i % (PE_W / 2)), o = r * P_STRIDE + c;
    store_split_bf16(pe_value(sm.y[r], c, d_embed), pe_value(sm.y[r], c + 1, d_embed),
                     sm.pe[0] + o, sm.pe[1] + o);
  }
  if (CS > 1) cluster_sync();   // every CTA of the cluster runs, the PE tile is ready
  else __syncthreads();

  int c = 0;   // the next k-tile of the weight stream
  float acc[MTW][NTW][4];
  // acc += A[:, 16 kt] @ W for the next KT k-tiles of the stream, k-tile
  // c0 + i from slot i
  auto consume = [&](const __nv_bfloat16* Ahi, const __nv_bfloat16* Alo, int stride, int KT) {
    const int c_end = c + KT;
    for (int c0 = c - c % PF; c0 < c_end; c0 += PF) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int ck = c0 + i;
        if (ck < c || ck >= c_end) continue;
        uint32_t ah[MTW][4], al[MTW][4];
#pragma unroll
        for (int m = 0; m < MTW; ++m) {
          load_a_ldm(Ahi, stride, mt0 + m, ck - c, ah[m]);
          load_a_ldm(Alo, stride, mt0 + m, ck - c, al[m]);
        }
        uint2 h[NTW], l[NTW];
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          h[j] = bh[i][j];
          l[j] = bl[i][j];
        }
        fetch(ck + PF, bh[i], bl[i]);
        mma3_bf16(acc, ah, al, h, l);
      }
    }
    c = c_end;
  };

  int cur = 0;
  for (int l = 0; l < n_layers - 1; ++l) {
#pragma unroll
    for (int m = 0; m < MTW; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[m][j][k] = 0.0f;
    int nxt = 0;
    if (l == 0) {
      consume(sm.pe[0], sm.pe[1], P_STRIDE, PE_W / 16);
    } else {
      consume(sm.act[cur][0], sm.act[cur][1], H_STRIDE, HID / 16);
      if (l == skip) consume(sm.pe[0], sm.pe[1], P_STRIDE, PE_W / 16);
      nxt = cur ^ 1;
    }
    // z = acc * post + b; softplus, split, into act[nxt], then spread to
    // every CTA
    const float post = (l == skip) ? INV_SQRT2 : 1.0f;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = rank * (C::OWN_NT * 8) + (nt0 + j) * 8 + 2 * t;
      const float b0 = __ldg(bias + l * HID + col), b1 = __ldg(bias + l * HID + col + 1);
#pragma unroll
      for (int m = 0; m < MTW; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = ((mt0 + m) * 16 + g + 8 * half) * H_STRIDE + col;
          store_split_bf16(softplus100_fast(acc[m][j][2 * half] * post + b0),
                           softplus100_fast(acc[m][j][2 * half + 1] * post + b1),
                           sm.act[nxt][0] + o, sm.act[nxt][1] + o);
        }
    }
    if (CS > 1) {
      __syncthreads();
      for (int hl = 0; hl < 2; ++hl)
        cluster_spread(sm.act[nxt][hl] + rank * C::OWN_NT * 8, H_STRIDE * 2, ROWS,
                       C::OWN_NT * 16, CS);
      cluster_sync();
    } else {
      __syncthreads();
    }
    cur = nxt;
  }

  // final layer, sdf column: rows [64 rank / CS, ...), TPR threads a row
  {
    constexpr int TPR = THREADS / (ROWS / CS), KPT = HID / TPR;
    const int r = rank * (ROWS / CS) + tid / TPR, q = tid % TPR;
    const int o = r * H_STRIDE + q * KPT;
    const __nv_bfloat16 *hh = sm.act[cur][0] + o, *hl = sm.act[cur][1] + o;
    const __nv_bfloat16 *wh = wlast_hi + q * KPT, *wl = wlast_lo + q * KPT;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < KPT; k += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hh + k));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hl + k));
      const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wh + k));
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wl + k));
      s = fmaf(a.x, u.x, s);
      s = fmaf(a.x, v.x, s);
      s = fmaf(b.x, u.x, s);
      s = fmaf(a.y, u.y, s);
      s = fmaf(a.y, v.y, s);
      s = fmaf(b.y, u.y, s);
    }
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (q == 0 && row0 + r < n) out[row0 + r] = (s + __ldg(bias + (n_layers - 1) * HID)) * inv_scale;
  }
}

template <int CS>
cudaError_t launch_3pass(const float* x, int n, const void* whi, const void* wlo, int n_ktiles,
                         const float* bias, const void* wlast_hi, const void* wlast_lo,
                         int n_layers, int skip, int d_embed, float scale, float* out,
                         cudaStream_t st) {
  const int smem = (int)sizeof(k4::Smem);
  cudaError_t e = cudaFuncSetAttribute(sdf_only_3pass_kernel<CS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((n + ROWS - 1) / ROWS * CS, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;   // width 1: a plain grid of CTAs
  return cudaLaunchKernelEx(&cfg, sdf_only_3pass_kernel<CS>, x, n, (const uint2*)whi,
                            (const uint2*)wlo, n_ktiles, bias, (const __nv_bfloat16*)wlast_hi,
                            (const __nv_bfloat16*)wlast_lo, n_layers, skip, d_embed, scale,
                            1.0f / scale, out);
}

}  // namespace

extern "C" {

int iron_mlp_smem_bytes() { return (int)sizeof(MlpSmem); }

const char* iron_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int iron_sdf_only_bf16(const float* x, int n, const void* wpack, const float* bias,
                       const void* wlast, int n_layers, int skip, int d_embed,
                       float scale, float* out, void* stream) {
  if (n <= 0) return 0;
  const int smem = (int)sizeof(MlpSmem);
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
  const int smem = (int)sizeof(MlpSmem);
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

// whi, wlo: the packed hi and lo matrices, n_ktiles k-tiles of 16 x 256 in
// all (the weight stream); width: CTAs a tile, 1, 2 or 4
// (kernels/fused_sdf.py::k4_width).
int iron_sdf_only_3pass(const float* x, int n, const void* whi, const void* wlo, int n_ktiles,
                        const float* bias, const void* wlast_hi, const void* wlast_lo,
                        int n_layers, int skip, int d_embed, float scale, float* out, int width,
                        void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (width) {
    case 1: e = launch_3pass<1>(x, n, whi, wlo, n_ktiles, bias, wlast_hi, wlast_lo, n_layers,
                                skip, d_embed, scale, out, st); break;
    case 2: e = launch_3pass<2>(x, n, whi, wlo, n_ktiles, bias, wlast_hi, wlast_lo, n_layers,
                                skip, d_embed, scale, out, st); break;
    case 4: e = launch_3pass<4>(x, n, whi, wlo, n_ktiles, bias, wlast_hi, wlast_lo, n_layers,
                                skip, d_embed, scale, out, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
