// Shared device body of the coarse bf16 SDF kernels (fused_sdf.cu, K1 and
// K2): the positional encoding in f32 and the weight-normed softplus(100) MLP
// with its skip, as bf16 tensor-core products (mma.sync m16n8k16) with f32
// accumulation.
//
// Layout chosen for Hopper (not the TPU's lane panel): the PE keeps the
// reference column order [x, sin(2^0 x), cos(2^0 x), ...] padded to 48
// columns (three k-tiles of 16); hidden layers are 256 wide; the layer that
// feeds the skip is padded to 256 outputs whose rows in the skip matrix are
// zero; the final layer keeps only the sdf column.  Each weight matrix is
// packed on the host (kernels/fused_sdf.py::pack_mma_b) so that one lane's
// B fragment of one k-tile x n-tile is a single 8-byte load, coalesced over
// the warp; weights are read from L2 and never staged in shared memory.
#pragma once

#include "sm90.cuh"

namespace iron {

constexpr int ROWS = 64;            // points (rays) per block
constexpr int HID = 256;            // hidden width
constexpr int PE_W = 48;            // PE width, padded to 3 k-tiles of 16
constexpr int THREADS = 256;        // 8 warps; warp w owns output columns [32w, 32w+32)
constexpr int H_STRIDE = HID + 8;   // bf16 row strides: +8 spreads rows over the banks
constexpr int P_STRIDE = PE_W + 8;
constexpr int N_TILES = HID / 8;    // n-tiles of 8 columns per 256-wide layer
constexpr float INV_SQRT2 = 0.70710678118654752f;

struct MlpSmem {
  __nv_bfloat16 act[2][ROWS * H_STRIDE];           // double-buffered activation tile
  __nv_bfloat16 pe[ROWS * P_STRIDE];               // PE tile, read by layer 0 and the skip
  float y[ROWS][3];                                // scaled input points
  float out[ROWS];                                 // final-layer output (sdf * scale)
  // coarse-march ray state
  float ro[ROWS][3];
  float rd[ROWS][3];
};

__device__ __forceinline__ float softplus100(float z) {
  // softplus(100 z) / 100 as max(t,0) + log1p(exp(-|t|)), precise libm calls
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) / 100.0f;
}

// PE column c of scaled point y (d_in = 3): identity, then per frequency k
// one sin block and one cos block of 3 columns; zero past d_embed.
__device__ __forceinline__ float pe_value(const float* y, int c, int d_embed) {
  if (c >= d_embed) return 0.0f;
  if (c < 3) return y[c];
  const int q = (c - 3) / 3;
  const float a = ldexpf(y[(c - 3) % 3], q >> 1);   // exact: y * 2^k
  return (q & 1) ? cosf(a) : sinf(a);
}

// Store the pair (v0, v1) in bf16 at p[0..1].
__device__ __forceinline__ void store_pair(float v0, float v1, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void fill_pe(MlpSmem& sm, int d_embed) {
  for (int i = threadIdx.x; i < ROWS * PE_W / 2; i += THREADS) {
    const int r = i / (PE_W / 2), c = 2 * (i % (PE_W / 2)), o = r * P_STRIDE + c;
    store_pair(pe_value(sm.y[r], c, d_embed), pe_value(sm.y[r], c + 1, d_embed), sm.pe + o);
  }
}

// The m16n8k16 A fragment of rows [16 mt, 16 mt + 16) and columns
// [16 kt, 16 kt + 16) of a bf16 tile in shared memory, for this lane.
__device__ __forceinline__ void load_a(const __nv_bfloat16* A, int a_stride, int mt, int kt,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = A + (mt * 16 + g) * a_stride + kt * 16 + t * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * a_stride);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * a_stride + 8);
}

// acc[mt][nt] += A[64 x 16*KT] @ W[16*KT x 256] restricted to this warp's 32
// columns.  A is a bf16 tile in shared memory; w holds packed matrices
// [KT][N_TILES][32 lanes] of uint2, this one at offset off.
template <int KT>
__device__ __forceinline__ void mma_layer(const __nv_bfloat16* A, int a_stride,
                                          const uint2* __restrict__ w, size_t off,
                                          float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint2* wh = w + off;
#pragma unroll 4
  for (int kt = 0; kt < KT; ++kt) {
    uint2 bh[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bh[nt] = __ldg(&wh[(kt * N_TILES + warp * 4 + nt) * 32 + lane]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t ah[4];
      load_a(A, a_stride, mt, kt, ah);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], ah, bh[nt].x, bh[nt].y);
    }
  }
}

// z = acc * post + bias; h = softplus100(z) into the next activation tile (bf16).
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[4][4][4], float post,
                                                const float* __restrict__ bias,
                                                __nv_bfloat16* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = warp * 32 + nt * 8 + t * 2;
      const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = (mt * 16 + g + half * 8) * H_STRIDE + c;
        store_pair(softplus100(acc[mt][nt][2 * half] * post + b0),
                   softplus100(acc[mt][nt][2 * half + 1] * post + b1), dst + o);
      }
    }
  }
}

// The whole MLP on the 64-row PE tile in sm.pe; writes sm.out[r] (the sdf
// column times scale, f32).  n_layers counts linear layers (9 for the default
// SDF); skip is the layer that consumes concat(h, pe).  w holds the packed
// 256-wide matrices in layer order (skip layer: W_h then W_pe); bias holds
// (n_layers - 1) x 256 f32 hidden biases then the final sdf bias; wlast is
// the final layer's sdf column (256 bf16).  Ends with a block barrier.
__device__ void mlp_eval(MlpSmem& sm, const uint2* __restrict__ w, const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ wlast, int n_layers, int skip) {
  size_t off = 0;   // of the current matrix in the packed set
  int cur = 0;
  for (int l = 0; l < n_layers - 1; ++l) {
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
    int nxt;
    if (l == 0) {
      mma_layer<PE_W / 16>(sm.pe, P_STRIDE, w, off, acc);
      off += (PE_W / 16) * N_TILES * 32;
      nxt = 0;
    } else {
      mma_layer<HID / 16>(sm.act[cur], H_STRIDE, w, off, acc);
      off += (HID / 16) * N_TILES * 32;
      if (l == skip) {
        mma_layer<PE_W / 16>(sm.pe, P_STRIDE, w, off, acc);
        off += (PE_W / 16) * N_TILES * 32;
      }
      nxt = cur ^ 1;
    }
    hidden_epilogue(acc, l == skip ? INV_SQRT2 : 1.0f, bias + l * HID, sm.act[nxt]);
    __syncthreads();
    cur = nxt;
  }
  // final layer, sdf column only: four threads per row, 64 products each
  {
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    const __nv_bfloat16* hh = sm.act[cur] + r * H_STRIDE + q * 64;
    const __nv_bfloat16* wh = wlast + q * 64;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < 64; k += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hh + k));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wh + k));
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) sm.out[r] = s + __ldg(bias + (n_layers - 1) * HID);
  }
  __syncthreads();
}

}  // namespace iron
