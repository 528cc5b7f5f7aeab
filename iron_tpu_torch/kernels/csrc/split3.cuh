// The 3-pass split arithmetic of the accurate tensor-core kernels: every
// operand v is split into a high and a low part, hi = round(v) and
// lo = round(v - hi) (v - hi is exact in f32), and every product issues
// a_hi b_hi + a_hi b_lo + a_lo b_hi into one f32 accumulator; the
// a_lo b_lo term, below the rounding of the lo parts, is dropped.
//
//   bf16 (K4, sdf_only_3pass): 8 significant bits a part, v ~ hi + lo to
//     2^-17 of v; an activation is split once, by the epilogue that writes it,
//     into a hi and a lo bf16 tile (store_split_bf16).
//   tf32 (K3-bwd): 11 significant bits a part, v ~ hi + lo to 2^-22 of v;
//     operands stay f32 in shared memory and are split in registers as a
//     fragment is loaded (split_tf32: integer add, mask and one subtraction,
//     no conversion instruction).  The backward needs this class: with bf16
//     parts its parameter gradients miss the JAX kernel's 1e-4 hold
//     (tests/test_torch_kernels.py).
#pragma once

#include "sm90.cuh"

namespace iron {

// ---- bf16 ----

// Store (v0, v1) as bf16 pairs: hi[0..1] = bf16(v), lo[0..1] = bf16(v - hi).
__device__ __forceinline__ void store_split_bf16(float v0, float v1, __nv_bfloat16* hi,
                                                 __nv_bfloat16* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
}

// d[m][j] += A_m b_j for MT m-tiles and NT n-tiles, each in three m16n8k16
// passes (hi hi, hi lo, lo hi), issued pass by pass: MT NT - 1 independent
// mma lie between two on one accumulator.
template <int MT, int NT>
__device__ __forceinline__ void mma3_bf16(float (&d)[MT][NT][4], const uint32_t (&ah)[MT][4],
                                          const uint32_t (&al)[MT][4], const uint2 (&bh)[NT],
                                          const uint2 (&bl)[NT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(d[m][j], ah[m], bh[j].x, bh[j].y);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(d[m][j], ah[m], bl[j].x, bl[j].y);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(d[m][j], al[m], bh[j].x, bh[j].y);
}

// ---- tf32 ----

// v rounded to tf32 (11 significant bits, nearest, ties away from zero).
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(v);
  lo = round_tf32(v - __uint_as_float(hi));
}

// The four A (or two B) values of a fragment, split.
__device__ __forceinline__ void split_tf32(const float (&v)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// d[i] += a[i] b in three m16n8k8 passes, hi hi, hi lo, lo hi (b: hi0,
// hi1, lo0, lo1), for N independent products (m-tiles): issued pass by pass,
// so that N - 1 other mma lie between two on one accumulator.
template <int N>
__device__ __forceinline__ void mma3_tf32(float (&d)[N][4], const uint32_t (&ah)[N][4],
                                          const uint32_t (&al)[N][4], const uint32_t (&b)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ah[i], b[0], b[1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ah[i], b[2], b[3]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], al[i], b[0], b[1]);
}

}  // namespace iron
