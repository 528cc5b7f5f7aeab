// What the bf16 SDF kernels of fused_sdf.cu (K1, K2, K4) share: the layout
// constants of the SDF MLP and the positional encoding.
//
// Layout chosen for Hopper (not the TPU's lane panel): the PE keeps the
// reference column order [x, sin(2^0 x), cos(2^0 x), ...] padded to 48
// columns (three k-tiles of 16); hidden layers are 256 wide; the layer that
// feeds the skip is padded to 256 outputs whose rows in the skip matrix are
// zero; the final layer keeps only the sdf column.  Weights are packed on the
// host (kernels/fused_sdf.py): mma.sync B fragments for K1 and K4
// (pack_mma_b), swizzled wgmma k-tiles for K2 (pack_wgmma_b).
#pragma once

#include "sm90.cuh"

namespace iron {

constexpr int ROWS = 64;            // points (rays) per tile of K1 and K4
constexpr int HID = 256;            // hidden width
constexpr int PE_W = 48;            // PE width, padded to 3 k-tiles of 16
constexpr int THREADS = 256;        // 8 warps
constexpr int H_STRIDE = HID + 8;   // bf16 row strides: +8 spreads rows over the banks
constexpr int P_STRIDE = PE_W + 8;
constexpr int N_TILES = HID / 8;    // n-tiles of 8 columns per 256-wide layer
constexpr float INV_SQRT2 = 0.70710678118654752f;

// PE column c of scaled point y (d_in = 3): identity, then per frequency k
// one sin block and one cos block of 3 columns; zero past d_embed.
__device__ __forceinline__ float pe_value(const float* y, int c, int d_embed) {
  if (c >= d_embed) return 0.0f;
  if (c < 3) return y[c];
  const int q = (c - 3) / 3;
  const float a = ldexpf(y[(c - 3) % 3], q >> 1);   // exact: y * 2^k
  return (q & 1) ? cosf(a) : sinf(a);
}

// The bf16 PE tile of `rows` scaled points y (row stride P_STRIDE), filled
// by the threads i0, i0 + step, ...: sin and cos of an angle from one
// sincosf (the reference column order: x, then sin(2^k x) and cos(2^k x)
// blocks of 3), the identity columns and the zero padding.  The caller
// orders the writes before the reads.
__device__ __forceinline__ void fill_pe_sincos(__nv_bfloat16* pe, const float (*y)[3], int rows,
                                               int d_embed, int i0, int step) {
  const int n_freq = (d_embed - 3) / 6;
  for (int i = i0; i < rows * 3 * n_freq; i += step) {
    const int r = i / (3 * n_freq), k = (i / 3) % n_freq, j = i % 3;
    float sn, cs;
    sincosf(ldexpf(y[r][j], k), &sn, &cs);   // exact: y * 2^k
    __nv_bfloat16* row = pe + r * P_STRIDE + 3 + 6 * k + j;
    row[0] = __float2bfloat16_rn(sn);
    row[3] = __float2bfloat16_rn(cs);
  }
  for (int i = i0; i < rows * (PE_W - d_embed + 3); i += step) {
    const int r = i / (PE_W - d_embed + 3), c = i % (PE_W - d_embed + 3);
    pe[r * P_STRIDE + (c < 3 ? c : d_embed + c - 3)] = __float2bfloat16_rn(c < 3 ? y[r][c] : 0.0f);
  }
}

// Store the pair (v0, v1) in bf16 at p[0..1].
__device__ __forceinline__ void store_pair(float v0, float v1, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace iron
