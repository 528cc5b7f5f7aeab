// Shared device body of the bf16 SDF kernels (fused_sdf.cu): the positional
// encoding in f32 and the weight-normed softplus(100) MLP with its skip, as
// bf16 tensor-core products (mma.sync m16n8k16) with f32 accumulation, in
// one pass (K1, K2: mlp_eval<1>) or in three on split operands (K4:
// mlp_eval<3>).
//
// Layout chosen for Hopper (not the TPU's lane panel): the PE keeps the
// reference column order [x, sin(2^0 x), cos(2^0 x), ...] padded to 48
// columns (three k-tiles of 16); hidden layers are 256 wide; the layer that
// feeds the skip is padded to 256 outputs whose rows in the skip matrix are
// zero; the final layer keeps only the sdf column.  Each weight matrix is
// packed on the host (kernels/fused_sdf.py::pack_mma_b) so that one lane's
// B fragment of one k-tile x n-tile is a single 8-byte load, coalesced over
// the warp; weights are read from L2 and never staged in shared memory.
//
// The 3-pass body: every operand is split into bf16 halves, hi = bf16(v) and
// lo = bf16(v - hi) (v - hi is exact in f32), and each k-tile x n-tile issues
// three mmas into one f32 accumulator: A_hi B_hi + A_hi B_lo + A_lo B_hi.  An
// activation is split once, by the epilogue that writes it: each of the 8
// warps reads the whole A tile, so a split at the fragment load would be
// repeated 8 times.  The hi and lo tiles are double-buffered as the 1-pass
// tile is (4 x 33 KB), beside the PE halves (2 x 7 KB): 149 KB of shared
// memory, one block an SM.  B fragments of both halves stream from L2 in the
// same packed layout.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace iron {

constexpr int ROWS = 64;            // points (rays) per block
constexpr int HID = 256;            // hidden width
constexpr int PE_W = 48;            // PE width, padded to 3 k-tiles of 16
constexpr int THREADS = 256;        // 8 warps; warp w owns output columns [32w, 32w+32)
constexpr int H_STRIDE = HID + 8;   // bf16 row strides: +8 spreads rows over the banks
constexpr int P_STRIDE = PE_W + 8;
constexpr int N_TILES = HID / 8;    // n-tiles of 8 columns per 256-wide layer
constexpr float INV_SQRT2 = 0.70710678118654752f;

// P = 1: one bf16 tile per operand; P = 3: its hi ([0]) and lo ([1]) halves.
template <int P>
struct MlpSmem {
  static constexpr int HALVES = P == 3 ? 2 : 1;
  __nv_bfloat16 act[2][HALVES][ROWS * H_STRIDE];   // double-buffered activation tile
  __nv_bfloat16 pe[HALVES][ROWS * P_STRIDE];       // PE tile, read by layer 0 and the skip
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

// Store the pair (v0, v1) in bf16 at hi[0..1]; for P = 3 also the lo halves
// at lo[0..1].
template <int P>
__device__ __forceinline__ void store_pair(float v0, float v1, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  if constexpr (P == 3) {
    const float2 hf = __bfloat1622float2(h);
    *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  }
}

template <int P>
__device__ __forceinline__ void fill_pe(MlpSmem<P>& sm, int d_embed) {
  constexpr int LO = MlpSmem<P>::HALVES - 1;
  for (int i = threadIdx.x; i < ROWS * PE_W / 2; i += THREADS) {
    const int r = i / (PE_W / 2), c = 2 * (i % (PE_W / 2)), o = r * P_STRIDE + c;
    store_pair<P>(pe_value(sm.y[r], c, d_embed), pe_value(sm.y[r], c + 1, d_embed),
                  sm.pe[0] + o, sm.pe[LO] + o);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// columns.  A[0] is a bf16 tile in shared memory, A[1] its lo half (P = 3);
// whi and wlo (P = 3) hold packed matrices [KT][N_TILES][32 lanes] of uint2,
// this one at offset off.
template <int P, int KT>
__device__ __forceinline__ void mma_layer(const __nv_bfloat16* const (&A)[2], int a_stride,
                                          const uint2* __restrict__ whi,
                                          const uint2* __restrict__ wlo, size_t off,
                                          float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint2* wh = whi + off;
  const uint2* wl = P == 3 ? wlo + off : nullptr;
#pragma unroll(P == 3 ? 2 : 4)
  for (int kt = 0; kt < KT; ++kt) {
    uint2 bh[4], bl[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = (kt * N_TILES + warp * 4 + nt) * 32 + lane;
      bh[nt] = __ldg(&wh[i]);
      if constexpr (P == 3) bl[nt] = __ldg(&wl[i]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t ah[4], al[4];
      load_a(A[0], a_stride, mt, kt, ah);
      if constexpr (P == 3) load_a(A[1], a_stride, mt, kt, al);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_bf16(acc[mt][nt], ah, bh[nt].x, bh[nt].y);
        if constexpr (P == 3) {
          mma_bf16(acc[mt][nt], ah, bl[nt].x, bl[nt].y);
          mma_bf16(acc[mt][nt], al, bh[nt].x, bh[nt].y);
        }
      }
    }
  }
}

// z = acc * post + bias; h = softplus100(z) into the next activation tile
// (bf16, split into its hi and lo tiles for P = 3).
template <int P>
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[4][4][4], float post,
                                                const float* __restrict__ bias,
                                                __nv_bfloat16* dst_hi, __nv_bfloat16* dst_lo) {
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
        store_pair<P>(softplus100(acc[mt][nt][2 * half] * post + b0),
                      softplus100(acc[mt][nt][2 * half + 1] * post + b1), dst_hi + o,
                      dst_lo + o);
      }
    }
  }
}

// The whole MLP on the 64-row PE tile in sm.pe; writes sm.out[r] (the sdf
// column times scale, f32).  n_layers counts linear layers (9 for the default
// SDF); skip is the layer that consumes concat(h, pe).  whi holds the
// packed 256-wide matrices in layer order (skip layer: W_h then W_pe); bias
// holds (n_layers - 1) x 256 f32 hidden biases then the final sdf bias;
// wlast_hi is the final layer's sdf column (256 bf16).  For P = 3, wlo and
// wlast_lo are the lo halves of whi and wlast_hi (unused for P = 1).  Ends
// with a block barrier.
template <int P>
__device__ void mlp_eval(MlpSmem<P>& sm, const uint2* __restrict__ whi,
                         const uint2* __restrict__ wlo, const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ wlast_hi,
                         const __nv_bfloat16* __restrict__ wlast_lo, int n_layers, int skip) {
  constexpr int LO = MlpSmem<P>::HALVES - 1;
  const __nv_bfloat16* const pe[2] = {sm.pe[0], sm.pe[LO]};
  size_t off = 0;   // of the current matrix in the packed set(s)
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
      mma_layer<P, PE_W / 16>(pe, P_STRIDE, whi, wlo, off, acc);
      off += (PE_W / 16) * N_TILES * 32;
      nxt = 0;
    } else {
      const __nv_bfloat16* const h[2] = {sm.act[cur][0], sm.act[cur][LO]};
      mma_layer<P, HID / 16>(h, H_STRIDE, whi, wlo, off, acc);
      off += (HID / 16) * N_TILES * 32;
      if (l == skip) {
        mma_layer<P, PE_W / 16>(pe, P_STRIDE, whi, wlo, off, acc);
        off += (PE_W / 16) * N_TILES * 32;
      }
      nxt = cur ^ 1;
    }
    hidden_epilogue<P>(acc, l == skip ? INV_SQRT2 : 1.0f, bias + l * HID, sm.act[nxt][0],
                       sm.act[nxt][LO]);
    __syncthreads();
    cur = nxt;
  }
  // final layer, sdf column only: four threads per row, 64 products each
  {
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    const int o = r * H_STRIDE + q * 64;
    const __nv_bfloat16 *hh = sm.act[cur][0] + o, *hl = sm.act[cur][LO] + o;
    const __nv_bfloat16 *wh = wlast_hi + q * 64, *wl = wlast_lo + q * 64;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < 64; k += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hh + k));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wh + k));
      float2 b, d;
      if constexpr (P == 3) {
        b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hl + k));
        d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wl + k));
      }
      s = fmaf(a.x, c.x, s);
      if constexpr (P == 3) {
        s = fmaf(a.x, d.x, s);
        s = fmaf(b.x, c.x, s);
      }
      s = fmaf(a.y, c.y, s);
      if constexpr (P == 3) {
        s = fmaf(a.y, d.y, s);
        s = fmaf(b.y, c.y, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) sm.out[r] = s + __ldg(bias + (n_layers - 1) * HID);
  }
  __syncthreads();
}

}  // namespace iron
