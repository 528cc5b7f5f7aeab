// K3 forward, iron_sdf_value_feat_grad: SDF value, the feature vector and the
// input gradient of the weight-normed softplus(100) SDF MLP in one forward
// and one reverse sweep, at f32 class.
//
// Replaces the forward TPU kernel of
//   iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn
//   (_fwd_kernel, _forward_chain, _u_chain, _pe_value_d1_d2): see the note
//   above sdf_grad_fwd_kernel.
// K3 backward, iron_sdf_value_feat_grad_bwd, replaces its backward kernel
// (_bwd_kernel through _core_bwd): see the note above sdf_grad_bwd_kernel.
// K5, iron_sdf_full, replaces iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_fn
// (_kernel, _mlp_body): K3-fwd's forward sweep alone (sdf_grad_fwd_kernel
// with GRAD = false), [sdf / scale, features] for every point at f32 class.
// 524,544 MACs a point (the hidden chain and all 257 outputs) against 1,040
// bytes (12 in, 257 x 4 out), so operations bound it: 1.67 ms on 262,144
// points as 3xTF32 (its route), 4.12 ms in f32 on the CUDA cores.
//
// Layout (kernels/fused_sdf_grad.py::prepare_grad_weights): PE in reference
// column order padded to 48; hidden 256; the layer feeding the skip padded to
// 256 outputs; the skip's 1/sqrt(2) folded into its two matrices; the final
// layer kept at its true width d_out (257).  The reverse sweep
// u_{l-1} = (u_l @ W_l^T) * sigmoid(100 z_{l-1}) reads host-made transposes,
// so that both sweeps read weights coalesced.
//
// What bounds K3-fwd on an H100: about 2 MFLOP a point (983,296 MACs: the
// forward to 257 outputs and the reverse sweep) against about 1 KB of
// output, so operations bound it: 3.12 ms on 262,144 points as 3xTF32 on
// the tensor cores (its route: three tf32 products a MAC), 7.71 ms in f32
// on the CUDA cores.  See the note above sdf_grad_fwd_kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "split3.cuh"

using namespace iron;

namespace {

constexpr int HID = 256;
constexpr int PE_W = 48;
constexpr int THREADS = 256;

__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) / 100.0f;
}

__device__ __forceinline__ float sigmoid100(float z) {
  return 1.0f / (1.0f + expf(-100.0f * z));
}

// Offset of layer l's first matrix in the concatenated layout (the skip
// layer's PE matrix follows its hidden one).
__device__ __forceinline__ size_t mat_off(int l, int n_layers, int skip, int d_out) {
  size_t off = 0;
  for (int m = 0; m < l; ++m) {
    const int K = (m == 0) ? PE_W : HID;
    const int N = (m == n_layers - 1) ? d_out : HID;
    off += (size_t)K * N + ((m == skip) ? (size_t)PE_W * N : 0);
  }
  return off;
}

// ---------------------------------------------------------------------------
// K3 backward.  Given the cotangents of (value, feature, grad) of n points,
// computes dx and the cotangent of every prepared matrix and bias: the
// adjoint of the forward chain and of the u-chain (the reverse-over-reverse
// graph), as iron_tpu/kernels/fused_sdf_grad.py::_bwd_kernel does.  Per tile:
//   1. recompute the forward chain, keeping z_l of every hidden layer;
//   2. recompute the u-chain, keeping vh_l = u_l @ W_l^T and the PE
//      cotangent a0cot;
//   3. the output stage: bar_a0cot = dg[axis] * dPE/dy, and dx's term
//      through d2PE/dy2;
//   4. the adjoint of the u-chain in forward order: bar_vh_l, bar_u_l, the
//      u-chain's share of bar_z_{l-1}, and dW_l += bar_vh_l^T u_l;
//   5. the adjoint of the primal chain in reverse order: bz_l, db_l,
//      dW_l += a_l^T bz_l, bar_a_l = bz_l @ W_l^T;
//   6. dx += scale * sum over each axis of bar_a0 * dPE/dy.
//
// The design for Hopper.  A training step calls K3-bwd on 1,024, 2,048 and
// 4,096 points: 16 to 64 tiles of 64 rows, a fifth to a half of the card if
// a tile were one block.  So a tile is split across the 4 CTAs of a thread
// block cluster by columns: CTA r owns the hidden columns [64 r, 64 r + 64)
// of every layer and computes them in every product, reading the full-width
// row operand (a_l, u_l, bar_vh_l, bz_l, 256 columns) from its own shared
// memory: every CTA's epilogue writes its 64 columns locally and then copies
// them into the other CTAs' tiles in 16-byte stores (distributed shared
// memory, sm90.cuh::cluster_spread); the cluster meets at one barrier a phase
// (two in step 5).
// Clusters are persistent: cluster c takes tiles c, c + G, ... with G at
// most the clusters the card holds at once (30 on an H100 SXM: 120 CTAs,
// one an SM; cudaOccupancyMaxActiveClusters).  A tile is 16 MT rows, MT = 1
// to 4, sized so the tiles spread evenly over G clusters in as few rounds
// as 64-row tiles allow (kernels/fused_sdf_grad.py::bwd_tiling): the step's
// calls run 22 clusters (88 CTAs) of 48-row tiles at 1,024 points, and 30
// clusters (120 CTAs) in 2 and 3 rounds of 48-row tiles at 2,048 and 4,096.
//
// Every product runs on the tensor cores at f32 class, 3xTF32: mma.sync
// m16n8k8 on operands split into tf32 hi and lo (split3.cuh), a_hi b_hi +
// a_hi b_lo + a_lo b_hi.  bf16 parts are not accurate enough here (the
// u-chain multiplies by 100 sigma (1 - sigma); split3.cuh).  Three kinds:
//   * A @ W (forward chain, bar_u), B from host-packed fragments of W;
//   * A @ W^T (u-chain, bar_a), B from host-packed fragments of W^T;
//   * dW[:, own] += P^T q, summed over the tile's rows: A = P^T read
//     transposed from the row tile, B = the CTA's own columns of u_l or bz_l.
// Row tiles stay f32 in shared memory and are split as fragments are loaded.
// In the first two kinds warp w computes n-tile w of the CTA's 8 for every
// m-tile, so thread (w, lane) owns the same rows and columns in every
// per-column step: the chains z_l, vh_l and the u-chain's bar_z_l of its own
// elements go to a global scratch that only it reads back (fragment order,
// coalesced), and bar_u, bar_a stay in its registers.  The 48-wide products
// (a0cot, bar_a0: the PE cotangents, needed only for dx) run on CTA 0, warps
// 0-5.
//
// The dW/db sums stay deterministic: each entry has one owning thread in its
// cluster, which stores it on the cluster's first tile and adds to it on the
// next ones, into the cluster's own partial (n_w + n_b floats);
// reduce_partials_kernel then sums the clusters' partials in cluster order.
// Per call: partials G x 2.2 MB (66 MB at G = 30) and scratch 3 x 8 x R x 64
// f32 a CTA (295 KB at R = 48, 35 MB for 120 CTAs), 101 MB at 4,096 points
// against 240 MB before.  A tile moves about 86 scratch slabs of R x 64 f32 a
// CTA (1.0 MB at R = 48), mostly from L2; were it all to reach HBM, 124 MB a
// round of 120 CTAs, 37 us at 3.35 TB/s.
//
// Shared memory 210 KB a CTA (two full-width f32 row tiles 2 x 69 KB, the
// PE and bar_a0cot panels, the own-column tile, CTA 0's PE cotangents), one
// CTA an SM.
namespace k3b {

constexpr int CLUSTER = 4;
constexpr int OWN = HID / CLUSTER;   // columns a CTA owns
constexpr int MAXR = 64;             // rows of a tile, at most
constexpr int OUT_PAD = 264;         // d_out, at most, padded to k-steps of 8
constexpr int TS = OUT_PAD + 4;      // row stride of the full-width tiles
constexpr int PS = PE_W + 4;         // row stride of the PE panels
constexpr int QS = OWN + 8;          // row stride of the own-column tile
constexpr int PACK_HID = HID * HID / 2;   // float2 in a packed 256 x 256 matrix
constexpr int PACK_PE = PE_W * HID / 2;   // float2 in a packed 48 x 256 (or 256 x 48) matrix

struct Smem {
  float T[2][MAXR * TS];       // full-width row tiles
  float pe[MAXR * PS];         // PE(y)
  float bac[MAXR * PS];        // bar_a0cot = dg[axis] * dPE/dy
  float q[MAXR * QS];          // own columns of u_l or bz_l: B of the dW products
  float a0cot[MAXR * PE_W];    // CTA 0: PE cotangent from the u-chain
  float bar_a0[MAXR * PE_W];   // CTA 0: PE cotangent from the primal chain
  float s0[HID];               // CTA 0: column sums of bar_vh of the final layer
  float y[MAXR][3];
  float dg[MAXR][3];
  float dxp[MAXR][3];          // CTA 0: dx's term through d2PE/dy2
};

// PE column c of the scaled point y, and its derivative along axis c % 3
// (zero past d_embed).
__device__ __forceinline__ void pe_d1(const float* y, int c, int d_embed, float& v, float& d) {
  v = 0.0f;
  d = 0.0f;
  if (c >= d_embed) return;
  if (c < 3) {
    v = y[c];
    d = 1.0f;
    return;
  }
  const int q = (c - 3) / 3;
  const float f = ldexpf(1.0f, q >> 1);
  const float a = y[(c - 3) % 3] * f;
  const float sa = sinf(a), ca = cosf(a);
  v = (q & 1) ? ca : sa;
  d = (q & 1) ? -f * sa : f * ca;
}

// Offset (float2) of layer l's first matrix in the packed forward set and,
// with the same sizes, in the packed transposed set: layer 0 48 x 256, the
// hidden layers 256 x 256, the skip layer's PE matrix after its hidden one.
__device__ __forceinline__ size_t pack_off(int l, int skip) {
  size_t off = 0;
  for (int m = 0; m < l; ++m) off += (m == 0 ? PACK_PE : PACK_HID) + (m == skip ? PACK_PE : 0);
  return off;
}

// acc[m] += A[16 m .., 0 .. 8 KS) @ B[.., n-tile j]: the rows x one n-tile
// product of this warp, every m-tile.  A: f32 tile in shared memory (row
// stride lda); B: packed tf32 fragments [KS][NT][32 lanes] of float2, lane
// (g, t) holding (B[8 ks + t][8 j + g], B[8 ks + t + 4][8 j + g]), read from
// L2 PF k-steps ahead of use, so that the L2 round trip overlaps the
// products.
template <int MT>
__device__ __forceinline__ void prod_rows(float (&acc)[MT][4], const float* A, int lda, int KS,
                                          const float2* __restrict__ B, int NT, int j) {
  constexpr int PF = 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2* b = B + (size_t)j * 32 + lane;
  const size_t bstep = (size_t)NT * 32;
  float2 bq[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) bq[i] = (i < KS) ? __ldg(b + i * bstep) : make_float2(0.0f, 0.0f);
  for (int ks0 = 0; ks0 < KS; ks0 += PF) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int ks = ks0 + i;
      if (ks < KS) {
        const float2 bv = bq[i];
        if (ks + PF < KS) bq[i] = __ldg(b + (ks + PF) * bstep);
        uint32_t bb[4];
        split_tf32(bv.x, bb[0], bb[2]);
        split_tf32(bv.y, bb[1], bb[3]);
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* a = A + (16 * m + g) * lda + 8 * ks + t;
          const float av[4] = {a[0], a[8 * lda], a[4], a[8 * lda + 4]};
          split_tf32(av, ah[m], al[m]);
        }
        mma3_tf32(acc, ah, al, bb);
      }
    }
  }
}

// acc[i][nn] += P^T q over the tile's 16 MT rows, for the m-tiles m0 + i of
// P's columns and the 8 n-tiles of q: the dW product.  P: f32 row tile
// (stride ldp); q: the CTA's own 64 columns (stride ldq).
template <int MT, int MI>
__device__ __forceinline__ void prod_dw(float (&acc)[MI][8][4], const float* P, int ldp, int m0,
                                        const float* q, int ldq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < 2 * MT; ++ks) {
    const float* p0 = P + (8 * ks + t) * ldp;
    const float* p1 = p0 + 4 * ldp;
    uint32_t ah[MI][4], al[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int c = 16 * (m0 + i) + g;
      const float av[4] = {p0[c], p0[c + 8], p1[c], p1[c + 8]};
      split_tf32(av, ah[i], al[i]);
    }
    const float* q0 = q + (8 * ks + t) * ldq + g;
    const float* q1 = q0 + 4 * ldq;
    uint32_t bb[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      split_tf32(q0[8 * nn], bb[nn][0], bb[nn][2]);
      split_tf32(q1[8 * nn], bb[nn][1], bb[nn][3]);
    }
    // pass by pass over the 8 MI independent accumulators
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) mma_tf32(acc[i][nn], ah[i], bb[nn][0], bb[nn][1]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) mma_tf32(acc[i][nn], ah[i], bb[nn][2], bb[nn][3]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) mma_tf32(acc[i][nn], al[i], bb[nn][0], bb[nn][1]);
  }
}

template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][8][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nn][e] = 0.0f;
}

// This thread's MT x 2 elements (float2) of an own-column slab of the
// scratch, all loads issued before any use.
template <int MT>
__device__ __forceinline__ void load_slab(float2 (&v)[MT][2], const float2* slab, int fi0) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) v[m][h] = slab[fi0 + (m * 2 + h) * 32];
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
}

// dst[row * ld + col] (+)= acc for the rows 16 (m0 + i) + .. and the columns
// col0 + 8 nn + .. below ncols: stored on the cluster's first tile, added
// after.  Every old value is loaded before the first store, so that the
// loads are in flight together (the compiler cannot prove that a store does
// not alias a later load).
template <int MI>
__device__ __forceinline__ void flush_dw(float (&acc)[MI][8][4], float* dst, int ld, int m0,
                                         int col0, int ncols, bool first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto at = [&](int i, int nn, int e) -> float* {
    const int row = 16 * (m0 + i) + g + 8 * (e >> 1), col = col0 + 8 * nn + 2 * t + (e & 1);
    return col < ncols ? dst + (size_t)row * ld + col : nullptr;
  };
  if (!first) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (float* p = at(i, nn, e)) acc[i][nn][e] += *p;
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (float* p = at(i, nn, e)) *p = acc[i][nn][e];
}

// panel[row][8 w + ..] += acc: a 48-wide product's n-tile w into a PE panel.
template <int MT>
__device__ __forceinline__ void add_panel(const float (&acc)[MT][4], float* panel) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) panel[(16 * m + g + 8 * (e >> 1)) * PE_W + 8 * warp + 2 * t + (e & 1)] += acc[m][e];
}

}  // namespace k3b

// dvf: [n, d_out] cotangent of the final layer's output (the value's already
// divided by scale); dgr: [n, 3] cotangent of grad.  wf, wt2: the packed
// forward and transposed matrices (pack_off; wt2 ends with the final layer's
// transpose, OUT_PAD-class rows x 256).  part: per cluster, n_w matrix entries
// (the concatenated layout) then the biases, part_stride floats a cluster.
// scratch: per CTA 3 x (n_layers - 1) x 16 MT x 64 floats.
template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
sdf_grad_bwd_kernel(const float* __restrict__ x, int n, const float* __restrict__ dvf,
                    const float* __restrict__ dgr, const float2* __restrict__ wf,
                    const float2* __restrict__ wt2, const float* __restrict__ bias,
                    const float* __restrict__ wlast0, int n_layers, int skip, int d_embed,
                    int d_out, float scale, float* __restrict__ dx_out,
                    float* __restrict__ part, int part_stride, int n_w,
                    float* __restrict__ scratch) {
  using namespace k3b;
  constexpr int R = 16 * MT;
  constexpr int HALF = R * 32;   // float2 of one R x 64 layer slab of the scratch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = cluster_rank();
  const int own0 = rank * OWN;
  const int jn = rank * (OWN / 8) + warp;          // this warp's n-tile of a 256-wide output
  const int ocol = 8 * warp + 2 * t;                // this thread's first own column (local)
  const int L = n_layers, nh = n_layers - 1;
  const int cid = blockIdx.x / CLUSTER, ncl = gridDim.x / CLUSTER;
  float* dW = part + (size_t)cid * part_stride;
  float* dB = dW + n_w;
  float2* Zs = reinterpret_cast<float2*>(scratch) + (size_t)blockIdx.x * 3 * nh * HALF;
  float2* VHs = Zs + (size_t)nh * HALF;
  float2* BZs = VHs + (size_t)nh * HALF;
  const int out_pad = (d_out + 7) & ~7;
  const int n_tiles = (n + R - 1) / R;
  const float2 wl = make_float2(__ldg(wlast0 + own0 + ocol), __ldg(wlast0 + own0 + ocol + 1));

  // this thread's element (m, half) of an own-column slab: fragment-order
  // index in the scratch, and the tile row
  const int fi0 = warp * MT * 2 * 32 + lane;
  auto fi = [&](int m, int h) { return fi0 + (m * 2 + h) * 32; };
  auto frow = [&](int m, int h) { return 16 * m + g + 8 * h; };
  // write (v0, v1) at [row][own0 + ocol] of tile T[b]; spread(b) then copies
  // the CTA's columns of T[b] to the other CTAs of the cluster
  auto bcast = [&](int b, int row, float v0, float v1) {
    *reinterpret_cast<float2*>(&sm.T[b][row * TS + own0 + ocol]) = make_float2(v0, v1);
  };
  auto spread = [&](int b) {
    __syncthreads();
    cluster_spread(&sm.T[b][own0], TS * 4, R, OWN * 4, CLUSTER);
  };

  cluster_sync();   // every CTA of the cluster runs before any remote write
  for (int tile = cid; tile < n_tiles; tile += ncl) {
    const bool first = tile == cid;
    const int row0 = tile * R;

    // ---- 0. inputs, PE and bar_a0cot panels ----
    for (int i = tid; i < R * 3; i += THREADS) {
      const int r = i / 3, j = i % 3;
      const bool in = row0 + r < n;
      sm.y[r][j] = in ? x[(size_t)(row0 + r) * 3 + j] * scale : 0.0f;
      sm.dg[r][j] = in ? dgr[(size_t)(row0 + r) * 3 + j] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < R * PE_W; i += THREADS) {
      const int r = i / PE_W, c = i % PE_W;
      float v, d;
      pe_d1(sm.y[r], c, d_embed, v, d);
      sm.pe[r * PS + c] = v;
      sm.bac[r * PS + c] = sm.dg[r][c % 3] * d;
      if (rank == 0) {
        sm.a0cot[i] = 0.0f;
        sm.bar_a0[i] = 0.0f;
      }
    }
    __syncthreads();

    // ---- 1. forward chain of the hidden layers: z_l to scratch, a_{l+1} to T ----
    int wb = 0, rb = 0;   // the T buffer written next, the one read
    for (int l = 0; l < nh; ++l) {
      const size_t off = pack_off(l, skip);
      float acc[MT][4];
      zero(acc);
      if (l == 0) {
        prod_rows(acc, sm.pe, PS, PE_W / 8, wf + off, HID / 8, jn);
      } else {
        prod_rows(acc, sm.T[rb], TS, HID / 8, wf + off, HID / 8, jn);
        if (l == skip) prod_rows(acc, sm.pe, PS, PE_W / 8, wf + off + PACK_HID, HID / 8, jn);
      }
      const float b0 = __ldg(bias + l * HID + own0 + ocol), b1 = __ldg(bias + l * HID + own0 + ocol + 1);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float z0 = acc[m][2 * h] + b0, z1 = acc[m][2 * h + 1] + b1;
          Zs[(size_t)l * HALF + fi(m, h)] = make_float2(z0, z1);
          if (l < nh - 1) bcast(wb, frow(m, h), softplus100(z0), softplus100(z1));
        }
      if (l < nh - 1) {
        spread(wb);
        cluster_sync();
        rb = wb;
        wb ^= 1;
      }
    }

    // ---- 2. u-chain: u_{L-2} = W_last[:, 0] * sigmoid(100 z_{L-2}) ----
    {
      float2 z[MT][2];
      load_slab(z, Zs + (size_t)(nh - 1) * HALF, fi0);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bcast(wb, frow(m, h), wl.x * sigmoid100(z[m][h].x), wl.y * sigmoid100(z[m][h].y));
    }
    spread(wb);
    cluster_sync();
    rb = wb;
    wb ^= 1;
    for (int l = nh - 1; l >= 0; --l) {
      const size_t off = pack_off(l, skip);
      if (rank == 0 && warp < PE_W / 8 && (l == skip || l == 0)) {
        // a0cot += u_l @ W_pe^T (skip) or u_0 @ W_0^T
        float acc[MT][4];
        zero(acc);
        prod_rows(acc, sm.T[rb], TS, HID / 8, wt2 + off + (l == skip ? PACK_HID : 0), PE_W / 8,
                  warp);
        add_panel(acc, sm.a0cot);
      }
      if (l == 0) break;
      // vh_l = u_l @ W_l^T (own columns); u_{l-1} = vh_l * sigmoid(100 z_{l-1})
      float2 z[MT][2];
      load_slab(z, Zs + (size_t)(l - 1) * HALF, fi0);
      float acc[MT][4];
      zero(acc);
      prod_rows(acc, sm.T[rb], TS, HID / 8, wt2 + off, HID / 8, jn);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          VHs[(size_t)l * HALF + fi(m, h)] = make_float2(acc[m][2 * h], acc[m][2 * h + 1]);
          bcast(wb, frow(m, h), acc[m][2 * h] * sigmoid100(z[m][h].x),
                acc[m][2 * h + 1] * sigmoid100(z[m][h].y));
        }
      spread(wb);
      cluster_sync();
      rb = wb;
      wb ^= 1;
    }
    // sm.T[rb] holds u_0

    // ---- 3. output stage (CTA 0): dx's term through d2PE/dy2 ----
    __syncthreads();
    if (rank == 0 && tid < R * 3) {
      const int r = tid / 3, j = tid % 3;
      float s = 0.0f;
      for (int c = 3 + j; c < d_embed; c += 3) {
        const float f = ldexpf(1.0f, ((c - 3) / 3) >> 1);
        s += sm.a0cot[r * PE_W + c] * (-f * f * sm.pe[r * PS + c]);
      }
      sm.dxp[r][j] = scale * sm.dg[r][j] * s;
    }

    // ---- 4. adjoint of the u-chain, forward order ----
    // l = 0: dW_0 += bar_a0cot^T u_0; bar_u_0 = bar_a0cot @ W_0
    {
      if (warp < PE_W / 16) {
        float acc[1][8][4];
        zero(acc);
        prod_dw<MT, 1>(acc, sm.bac, PS, warp, sm.T[rb] + own0, TS);
        flush_dw(acc, dW + mat_off(0, L, skip, d_out), HID, warp, own0, HID, first);
      }
    }
    float bu[MT][4];
    zero(bu);
    prod_rows(bu, sm.bac, PS, PE_W / 8, wf + pack_off(0, skip), HID / 8, jn);
    for (int l = 1; l < L; ++l) {
      // bar_vh_l = bar_u_{l-1} * sigma'(z_{l-1}) -> T; the u-chain's share of
      // bar_z_{l-1} = bar_u_{l-1} * vh_l * sigma''(z_{l-1}) -> scratch; u_l -> q
      float2 zp[MT][2], vh[MT][2], zl[MT][2], vn[MT][2];
      load_slab(zp, Zs + (size_t)(l - 1) * HALF, fi0);
      if (l < L - 1) {
        load_slab(vh, VHs + (size_t)l * HALF, fi0);
        load_slab(zl, Zs + (size_t)l * HALF, fi0);
        if (l + 1 < L - 1) load_slab(vn, VHs + (size_t)(l + 1) * HALF, fi0);
      }
      __syncthreads();   // every warp has read sm.q
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 z = zp[m][h];
          const float2 v = (l == L - 1) ? wl : vh[m][h];
          const float s0 = sigmoid100(z.x), s1 = sigmoid100(z.y);
          const float bu0 = bu[m][2 * h], bu1 = bu[m][2 * h + 1];
          bcast(wb, frow(m, h), bu0 * s0, bu1 * s1);
          BZs[(size_t)(l - 1) * HALF + fi(m, h)] =
              make_float2(bu0 * v.x * (100.0f * s0 * (1.0f - s0)),
                          bu1 * v.y * (100.0f * s1 * (1.0f - s1)));
          if (l < L - 1) {
            const float2 u = (l + 1 == L - 1) ? wl : vn[m][h];
            float* qp = &sm.q[frow(m, h) * QS + ocol];
            qp[0] = u.x * sigmoid100(zl[m][h].x);
            qp[1] = u.y * sigmoid100(zl[m][h].y);
          }
        }
      spread(wb);
      cluster_sync();
      rb = wb;
      wb ^= 1;
      if (l == L - 1) {
        // u_{L-1} = e0: dW_last[:, 0] += column sums of bar_vh (CTA 0, in step 5)
        if (rank == 0) {
          float s = 0.0f;
          for (int r = 0; r < R; ++r) s += sm.T[rb][r * TS + tid];
          sm.s0[tid] = s;
        }
        break;
      }
      const size_t off = pack_off(l, skip);
      {
        float acc[2][8][4];
        zero(acc);
        prod_dw<MT, 2>(acc, sm.T[rb], TS, 2 * warp, sm.q, QS);
        flush_dw(acc, dW + mat_off(l, L, skip, d_out), HID, 2 * warp, own0, HID, first);
      }
      if (l == skip && warp < PE_W / 16) {
        float acc[1][8][4];
        zero(acc);
        prod_dw<MT, 1>(acc, sm.bac, PS, warp, sm.q, QS);
        flush_dw(acc, dW + mat_off(l, L, skip, d_out) + HID * HID, HID, warp, own0, HID, first);
      }
      zero(bu);
      prod_rows(bu, sm.T[rb], TS, HID / 8, wf + off, HID / 8, jn);
      if (l == skip) prod_rows(bu, sm.bac, PS, PE_W / 8, wf + off + PACK_HID, HID / 8, jn);
    }

    // ---- 5. adjoint of the primal chain, reverse order ----
    cluster_sync();   // every CTA has read T
    // l = L-1: bz = dvf (T[1], every column, read from global by each CTA);
    // a_{L-1} = softplus(z_{L-2}) -> T[0]
    {
      float2 z[MT][2];
      load_slab(z, Zs + (size_t)(nh - 1) * HALF, fi0);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bcast(0, frow(m, h), softplus100(z[m][h].x), softplus100(z[m][h].y));
    }
    for (int i = tid; i < R * out_pad; i += THREADS) {
      const int r = i / out_pad, c = i % out_pad;
      sm.T[1][r * TS + c] = (c < d_out && row0 + r < n) ? dvf[(size_t)(row0 + r) * d_out + c] : 0.0f;
    }
    spread(0);
    cluster_sync();
    float ba[MT][4];
    {
      const size_t wlast = mat_off(L - 1, L, skip, d_out);
      float acc[2][8][4];
      zero(acc);
      prod_dw<MT, 2>(acc, sm.T[0], TS, 2 * warp, sm.T[1] + own0, TS);
      if (rank == 0 && t == 0) {
        acc[0][0][0] += sm.s0[16 * (2 * warp) + g];
        acc[0][0][2] += sm.s0[16 * (2 * warp) + g + 8];
        acc[1][0][0] += sm.s0[16 * (2 * warp + 1) + g];
        acc[1][0][2] += sm.s0[16 * (2 * warp + 1) + g + 8];
      }
      flush_dw(acc, dW + wlast, d_out, 2 * warp, own0, d_out, first);
      // db of the final layer: own columns, and CTA CLUSTER-1 those past 256
      const int c = (tid < OWN) ? own0 + tid : (rank == CLUSTER - 1 ? HID + tid - OWN : d_out);
      if (c < d_out) {
        float s = 0.0f;
        for (int r = 0; r < R; ++r) s += sm.T[1][r * TS + c];
        float* p = dB + nh * HID + c;
        *p = first ? s : *p + s;
      }
      if (rank == CLUSTER - 1) {
        // dW_last[:, c] for the columns past 256, f32 on the CUDA cores
        for (int c = HID; c < d_out; ++c) {
          float s = 0.0f;
          for (int r = 0; r < R; ++r) s = fmaf(sm.T[0][r * TS + tid], sm.T[1][r * TS + c], s);
          float* p = dW + wlast + (size_t)tid * d_out + c;
          *p = first ? s : *p + s;
        }
      }
      zero(ba);
      prod_rows(ba, sm.T[1], TS, out_pad / 8, wt2 + pack_off(L - 1, skip), HID / 8, jn);
    }
    for (int l = nh - 1; l >= 0; --l) {
      float2 z[MT][2], bzs[MT][2], zp[MT][2];
      load_slab(z, Zs + (size_t)l * HALF, fi0);
      load_slab(bzs, BZs + (size_t)l * HALF, fi0);
      if (l > 0) load_slab(zp, Zs + (size_t)(l - 1) * HALF, fi0);
      cluster_sync();   // every CTA has read T[0] and T[1]
      // bz_l = bar_z_l + bar_a_{l+1} * sigma'(z_l) -> q and T[1]; db_l; a_l -> T[0]
      float dbs0 = 0.0f, dbs1 = 0.0f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = bzs[m][h].x + ba[m][2 * h] * sigmoid100(z[m][h].x);
          const float v1 = bzs[m][h].y + ba[m][2 * h + 1] * sigmoid100(z[m][h].y);
          dbs0 += v0;
          dbs1 += v1;
          const int row = frow(m, h);
          sm.q[row * QS + ocol] = v0;
          sm.q[row * QS + ocol + 1] = v1;
          bcast(1, row, v0, v1);
          if (l > 0) bcast(0, row, softplus100(zp[m][h].x), softplus100(zp[m][h].y));
        }
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        dbs0 += __shfl_xor_sync(0xffffffffu, dbs0, s);
        dbs1 += __shfl_xor_sync(0xffffffffu, dbs1, s);
      }
      if (g == 0) {
        float* p = dB + l * HID + own0 + ocol;
        const float o0 = first ? 0.0f : p[0], o1 = first ? 0.0f : p[1];
        p[0] = o0 + dbs0;
        p[1] = o1 + dbs1;
      }
      spread(1);
      if (l > 0) cluster_spread(&sm.T[0][own0], TS * 4, R, OWN * 4, CLUSTER);
      cluster_sync();
      const size_t off = pack_off(l, skip);
      if (l > 0) {
        float acc[2][8][4];
        zero(acc);
        prod_dw<MT, 2>(acc, sm.T[0], TS, 2 * warp, sm.q, QS);
        flush_dw(acc, dW + mat_off(l, L, skip, d_out), HID, 2 * warp, own0, HID, false);
      }
      if ((l == 0 || l == skip) && warp < PE_W / 16) {
        // step 4 stored these entries on the cluster's first tile: add
        float acc[1][8][4];
        zero(acc);
        prod_dw<MT, 1>(acc, sm.pe, PS, warp, sm.q, QS);
        flush_dw(acc, dW + mat_off(l, L, skip, d_out) + (l == skip ? HID * HID : 0), HID, warp,
                 own0, HID, false);
      }
      if (rank == 0 && warp < PE_W / 8 && (l == skip || l == 0)) {
        // bar_a0 += bz_l @ W_pe^T (skip) or bz_0 @ W_0^T
        float acc[MT][4];
        zero(acc);
        prod_rows(acc, sm.T[1], TS, HID / 8, wt2 + off + (l == skip ? PACK_HID : 0), PE_W / 8,
                  warp);
        add_panel(acc, sm.bar_a0);
      }
      if (l > 0) {
        zero(ba);
        prod_rows(ba, sm.T[1], TS, HID / 8, wt2 + off, HID / 8, jn);
      }
    }

    // ---- 6. dx (CTA 0) ----
    __syncthreads();
    if (rank == 0 && tid < R * 3) {
      const int r = tid / 3, j = tid % 3;
      if (row0 + r < n) {
        float s = 0.0f;
        for (int c = j; c < d_embed; c += 3) {
          float v, d;
          pe_d1(sm.y[r], c, d_embed, v, d);
          s += sm.bar_a0[r * PE_W + c] * d;
        }
        dx_out[(size_t)(row0 + r) * 3 + j] = sm.dxp[r][j] + scale * s;
      }
    }
    cluster_sync();   // every CTA is done with this tile's shared memory
  }
}

// out[i] = sum over blocks b, in order, of part[b * stride + i].
__global__ void reduce_partials_kernel(const float* __restrict__ part, int blocks,
                                       int stride, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * stride + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// K3 forward.  Value, features and input gradient of n points: the forward
// chain through every layer, then the u-chain (u_{L-2} = W_last[:, 0] *
// sigmoid(100 z_{L-2}), u_{l-1} = (u_l @ W_l^T) * sigmoid(100 z_{l-1})) to
// the PE cotangent a0cot, and grad_j = sum over the PE columns of axis j of
// a0cot * dPE/dy.
//
// The design for Hopper, K3-bwd's recipe on K3-bwd's weights:
//   * Every product on the tensor cores at f32 class, 3xTF32 (split3.cuh):
//     mma.sync m16n8k8 on operands split into tf32 hi and lo, a_hi b_hi +
//     a_hi b_lo + a_lo b_hi.  It meets the JAX kernel's 1e-5 hold on value,
//     features and gradient where three bf16 passes miss it
//     (tests/test_torch_kernels_k1_k3.py).  Row tiles stay f32 in shared
//     memory and are split as fragments are loaded; B fragments come from
//     the tf32 packs that K3-bwd reads (GradWeights.bwd_wf, bwd_wt) and the
//     final layer's forward pack (fwd_wlast), PF k-steps ahead of use.
//     The tensor cores' f32 accumulation drops low bits of a running sum,
//     so each k-step's three passes go to a fresh accumulator that an f32
//     add puts into the sum: summed into one accumulator, the errors were
//     ~10x larger, up to 0.9 of the 1e-5 hold (PERF.md).
//   * Work sized to the call (kernels/fused_sdf_grad.py::fwd_tiling).  A
//     training step's calls (1,024 to 4,096 points) split each tile's
//     columns over a cluster of CS = 4 or 2 CTAs, the widest whose clusters
//     hold the call in one round; CTA r owns the columns [256 r / CS, ...)
//     of every hidden layer: its epilogue writes them into its own
//     full-width row tile and copies them into the other CTAs' (distributed
//     shared memory, sm90.cuh::cluster_spread), one cluster barrier a
//     layer; a tile is the shortest of 16 MT rows (MT = 1 to 4) that covers
//     the call in that round.  A larger call (the render's 262,144 points)
//     runs one CTA a 64-row tile (CS = 1) on a persistent grid.
//   * sigmoid(100 z) of every hidden layer, the u-chain's factor, is kept
//     by the thread that computed it, in fragment order: in shared memory
//     when it fits beside the row tiles (a CTA's own columns x 8 layers x
//     16 MT rows: at CS = 4, 48 rows take 96 KB), else in a per-CTA global
//     scratch that only that thread reads back (64 rows at CS = 1: 512 KB a
//     CTA, 67 MB for the grid, past the L2), each layer's slab brought to
//     L2 by prefetches issued before the u-chain product that precedes its
//     use.
//   * The SFU's exp and log for softplus(100 z) and sigmoid(100 z), one exp
//     for both: within 1e-7 relative of the precise forms, far under the
//     1e-5 hold.
//   * The 48-wide products of the PE cotangent run on CTA 0, warps 0-5,
//     which also writes the gradient.  The final layer's first 256
//     columns go as the hidden layers'; its last (d_out = 257) is an f32
//     dot product on the CUDA cores of the last CTA.
//
// K5 is this kernel with GRAD = false: the forward chain and the final
// layer alone, without the u-chain, the sigmoid store and its scratch, one
// CTA a tile on a persistent grid.  With a single row tile (a barrier a
// layer between the products and the epilogue) a tile fits 96 and 128 rows
// as well as 64: each weight k-step then serves more rows.  96 rows measured
// fastest on the sweep's 262,144 points (64 rows re-read the weights a
// third more often a point; at 128 the 3xTF32 operands spill registers),
// and K5 is built for 96 alone (kernels/fused_sdf_grad.py::K5_ROWS;
// PERF.md; scripts/ablate_k2_k5_torch.py builds the other heights).
namespace k3f {

constexpr int TS = HID + 4;    // row stride of the full-width tiles (conflict-free fragments)
constexpr int PS = PE_W + 4;   // row stride of the PE panel
constexpr int OUT_NT = 33;     // n-tiles of the final layer, d_out padded to 264

// GRAD = false (K5): one row tile, no PE cotangent.
template <int MT, bool GRAD = true>
struct Smem {
  float T[GRAD ? 2 : 1][16 * MT * TS];   // full-width row tiles: a_l in the forward chain, u_l in the u-chain
  float pe[16 * MT * PS];                // PE(y)
  float d1[GRAD ? 16 * MT * PE_W : 1];      // dPE/dy (CTA 0)
  float a0cot[GRAD ? 16 * MT * PE_W : 1];   // PE cotangent (CTA 0)
  float y[16 * MT][3];
};

// softplus(100 z) / 100 and sigmoid(100 z) from one SFU exp.
__device__ __forceinline__ void softplus_sigmoid100(float z, float& sp, float& sg) {
  const float t = 100.0f * z;
  const float e = __expf(-fabsf(t));
  sp = (fmaxf(t, 0.0f) + __logf(1.0f + e)) * 0.01f;
  const float r = __fdividef(1.0f, 1.0f + e);
  sg = t >= 0.0f ? r : e * r;
}

// acc[j][m] += A[16 m .., 0 .. 8 KS) @ B[.., n-tile j0 + j] for NJ n-tiles
// and MT m-tiles, 3xTF32: each A fragment is split once and used for every
// n-tile.  B: packed tf32 fragments [KS][NT][32 lanes] of float2, read
// from L2 PF k-steps ahead of use.  Each k-step's three passes sum into a
// fresh accumulator that an f32 add then adds to acc.
template <int MT, int NJ>
__device__ __forceinline__ void prod_rows_nj(float (&acc)[NJ][MT][4], const float* A, int lda,
                                             int KS, const float2* __restrict__ B, int NT,
                                             int j0) {
  constexpr int PF = NJ >= 4 ? 2 : 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2* b = B + (size_t)j0 * 32 + lane;
  const size_t bstep = (size_t)NT * 32;
  float2 bq[PF][NJ];
#pragma unroll
  for (int i = 0; i < PF; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bq[i][j] = (i < KS) ? __ldg(b + i * bstep + j * 32) : make_float2(0.0f, 0.0f);
  for (int ks0 = 0; ks0 < KS; ks0 += PF) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int ks = ks0 + i;
      if (ks < KS) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* a = A + (16 * m + g) * lda + 8 * ks + t;
          const float av[4] = {a[0], a[8 * lda], a[4], a[8 * lda + 4]};
          split_tf32(av, ah[m], al[m]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 bv = bq[i][j];
          if (ks + PF < KS) bq[i][j] = __ldg(b + (ks + PF) * bstep + j * 32);
          uint32_t bb[4];
          split_tf32(bv.x, bb[0], bb[2]);
          split_tf32(bv.y, bb[1], bb[3]);
          // the k-step's products in a fresh accumulator, added to the
          // running sum by an f32 add: the tensor cores' f32 accumulation
          // drops low bits of each sum, here of a k-step's sum only
          float part[MT][4] = {};
          mma3_tf32(part, ah, al, bb);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][m][e] += part[m][e];
        }
      }
    }
  }
}

template <int MT, int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][MT][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.0f;
}

}  // namespace k3f

// wf, wt2: K3-bwd's packed forward and transposed matrices (k3b::pack_off);
// wlf: the final layer packed [256 x 264] (OUT_NT n-tiles).  sp: this
// launch's sigmoid(100 z) store, (n_layers - 1) x 16 MT x 256 / CS floats a
// CTA, in shared memory after the Smem when sp_on_chip, else in `scratch`.
// GRAD = false is K5: the forward sweep alone, without the u-chain, the
// sigmoid store and the gradient, on one row tile (a barrier a layer
// between the products and the epilogue), CS = 1; row r's [sdf, features]
// go to value[r * d_out ...] (feat = value + 1).
template <int MT, int CS, bool GRAD = true>
__global__ void __launch_bounds__(THREADS, 1)
sdf_grad_fwd_kernel(const float* __restrict__ x, int n, const float2* __restrict__ wf,
                    const float2* __restrict__ wt2, const float2* __restrict__ wlf,
                    const float* __restrict__ bias, const float* __restrict__ wlast0,
                    int n_layers, int skip, int d_embed, int d_out, float scale,
                    float* __restrict__ value, float* __restrict__ feat,
                    float* __restrict__ grad, float* __restrict__ scratch, int sp_on_chip) {
  using namespace k3f;
  static_assert(GRAD || CS == 1, "the forward sweep alone runs one CTA a tile");
  constexpr int R = 16 * MT;
  constexpr int OWN_NT = 32 / CS;        // n-tiles of a hidden layer a CTA owns
  constexpr int NJ = OWN_NT / 8;         // of them, a warp's
  constexpr int SLAB = 8 * NJ * MT * 2 * 32;   // float2 of one layer's own-column slab
  const int vstride = GRAD ? 1 : d_out, fstride = GRAD ? d_out - 1 : d_out;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MT, GRAD>& sm = *reinterpret_cast<Smem<MT, GRAD>*>(smem_raw);
  // row tile b (one tile without the u-chain)
  auto T = [&](int b) { return sm.T[GRAD ? b : 0]; };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = CS == 1 ? 0 : cluster_rank();
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int nh = n_layers - 1;
  const int j0 = rank * OWN_NT + warp * NJ;   // this warp's first n-tile of a hidden layer
  float2* sp = sp_on_chip
                   ? reinterpret_cast<float2*>(smem_raw + sizeof(Smem<MT, GRAD>))
                   : reinterpret_cast<float2*>(scratch) + (size_t)blockIdx.x * nh * SLAB;
  // this thread's element (j, m, h) of a layer's slab: fragment order
  auto si = [&](int l, int j, int m, int h) {
    return (size_t)l * SLAB + (((warp * NJ + j) * MT + m) * 2 + h) * 32 + lane;
  };
  // write (v0, v1) at [row][col] of tile T[b] for this thread's element
  auto put = [&](int b, int j, int m, int h, float v0, float v1) {
    const int row = 16 * m + g + 8 * h, col = 8 * (j0 + j) + 2 * t;
    *reinterpret_cast<float2*>(&T(b)[row * TS + col]) = make_float2(v0, v1);
  };
  // T[b] is complete in every CTA of the cluster
  auto share = [&](int b) {
    __syncthreads();
    if (CS > 1) {
      cluster_spread(&T(b)[rank * OWN_NT * 8], TS * 4, R, OWN_NT * 32, CS);
      cluster_sync();
    }
  };
  const int n_tiles = (n + R - 1) / R;

  if (CS > 1) cluster_sync();   // every CTA of the cluster runs before any remote write
  for (int tile = cid; tile < n_tiles; tile += ncl) {
    const int row0 = tile * R;
    // ---- inputs: PE, dPE/dy ----
    for (int i = tid; i < R * 3; i += THREADS) {
      const int r = i / 3, j = i % 3;
      sm.y[r][j] = (row0 + r < n) ? x[(size_t)(row0 + r) * 3 + j] * scale : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < R * PE_W; i += THREADS) {
      const int r = i / PE_W, c = i % PE_W;
      float v, d;
      k3b::pe_d1(sm.y[r], c, d_embed, v, d);
      sm.pe[r * PS + c] = v;
      if (GRAD && rank == 0) {
        sm.d1[i] = d;
        sm.a0cot[i] = 0.0f;
      }
    }
    __syncthreads();

    // ---- forward chain: a_{l+1} = softplus(z_l) -> T, sigmoid(100 z_l) -> sp ----
    int wb = 0, rb = 0;
    for (int l = 0; l < nh; ++l) {
      const size_t off = k3b::pack_off(l, skip);
      float acc[NJ][MT][4];
      zero(acc);
      if (l == 0) {
        prod_rows_nj(acc, sm.pe, PS, PE_W / 8, wf + off, HID / 8, j0);
      } else {
        prod_rows_nj(acc, T(rb), TS, HID / 8, wf + off, HID / 8, j0);
        if (l == skip) prod_rows_nj(acc, sm.pe, PS, PE_W / 8, wf + off + k3b::PACK_HID, HID / 8, j0);
      }
      if (!GRAD) __syncthreads();   // every read of the one row tile is done
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * (j0 + j) + 2 * t;
        const float b0 = __ldg(bias + l * HID + col), b1 = __ldg(bias + l * HID + col + 1);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float a0, a1, s0, s1;
            softplus_sigmoid100(acc[j][m][2 * h] + b0, a0, s0);
            softplus_sigmoid100(acc[j][m][2 * h + 1] + b1, a1, s1);
            put(wb, j, m, h, a0, a1);
            if (GRAD) sp[si(l, j, m, h)] = make_float2(s0, s1);
          }
      }
      share(wb);
      rb = wb;
      wb ^= 1;
    }

    // ---- final layer: value and features; the n-tiles [j0, j0 + NJ) as in
    // the hidden layers, and the columns past 256 on the last CTA ----
    auto write_out = [&](int jt, const float (&acc)[MT][4]) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * m + g + 8 * (e >> 1), c = 8 * jt + 2 * t + (e & 1);
          if (c < d_out && row0 + row < n) {
            const float z = acc[m][e] + __ldg(bias + nh * HID + c);
            if (c == 0) value[(size_t)(row0 + row) * vstride] = z / scale;
            else feat[(size_t)(row0 + row) * fstride + c - 1] = z;
          }
        }
    };
    {
      float acc[NJ][MT][4];
      zero(acc);
      prod_rows_nj(acc, T(rb), TS, HID / 8, wlf, OUT_NT, j0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) write_out(j0 + j, acc[j]);
    }
    // the columns past 256 (d_out 257: one) on the CUDA cores, in f32:
    // four threads a row, 64 products each, then two shuffles
    for (int i = tid; rank == CS - 1 && i < 4 * R; i += THREADS) {
      const int r = i >> 2, q = i & 3;
      const float* a = T(rb) + r * TS + 64 * q;
      const float* wl = reinterpret_cast<const float*>(wlf);
      for (int c = HID; c < d_out; ++c) {
        float z = 0.0f;
#pragma unroll 8
        for (int k = 0; k < 64; ++k) {
          // W_last[64 q + k][c] in the pack: k-step, lane (c % 8, row % 4), half
          const int row = 64 * q + k;
          const int i = (((row >> 3) * OUT_NT + (c >> 3)) * 32 + (c & 7) * 4 + (row & 3)) * 2
                        + ((row >> 2) & 1);
          z = fmaf(a[k], __ldg(wl + i), z);
        }
        z += __shfl_xor_sync(0xffffffffu, z, 1);
        z += __shfl_xor_sync(0xffffffffu, z, 2);
        if (q == 0 && row0 + r < n)
          feat[(size_t)(row0 + r) * fstride + c - 1] = z + __ldg(bias + nh * HID + c);
      }
    }
    // K5 ends the tile here; the next tile's input barriers order this
    // tile's reads of the row tile before its writes
    if constexpr (!GRAD) continue;

    // ---- u-chain: u_{L-2} = W_last[:, 0] * sigmoid(100 z_{L-2}) ----
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * (j0 + j) + 2 * t;
      const float w0 = __ldg(wlast0 + col), w1 = __ldg(wlast0 + col + 1);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 s = sp[si(nh - 1, j, m, h)];
          put(wb, j, m, h, w0 * s.x, w1 * s.y);
        }
    }
    share(wb);
    rb = wb;
    wb ^= 1;
    for (int l = nh - 1; l >= 0; --l) {
      const size_t off = k3b::pack_off(l, skip);
      if (rank == 0 && warp < PE_W / 8 && (l == skip || l == 0)) {
        // a0cot += u_l @ W_pe^T (skip) or u_0 @ W_0^T
        float acc[1][MT][4];
        zero(acc);
        prod_rows_nj(acc, T(rb), TS, HID / 8,
                     wt2 + off + (l == skip ? k3b::PACK_HID : 0), PE_W / 8, warp);
        k3b::add_panel(acc[0], sm.a0cot);
      }
      if (l == 0) break;
      // u_{l-1} = (u_l @ W_l^T) * sigmoid(100 z_{l-1}), own columns; the
      // sigmoid store of layer l - 1, when in the global scratch, is
      // brought to L2 while the product runs
      if (!sp_on_chip) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              asm volatile("prefetch.global.L2 [%0];" ::"l"(sp + si(l - 1, j, m, h)));
      }
      float acc[NJ][MT][4];
      zero(acc);
      prod_rows_nj(acc, T(rb), TS, HID / 8, wt2 + off, HID / 8, j0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 s = sp[si(l - 1, j, m, h)];
            put(wb, j, m, h, acc[j][m][2 * h] * s.x, acc[j][m][2 * h + 1] * s.y);
          }
      share(wb);
      rb = wb;
      wb ^= 1;
    }

    // ---- grad (CTA 0) ----
    __syncthreads();
    if (rank == 0 && tid < R * 3) {
      const int r = tid / 3, j = tid % 3;
      if (row0 + r < n) {
        float s = 0.0f;
        for (int c = j; c < d_embed; c += 3) s += sm.a0cot[r * PE_W + c] * sm.d1[r * PE_W + c];
        grad[(size_t)(row0 + r) * 3 + j] = s;
      }
    }
    // every CTA is done with this tile's shared memory before the next
    // tile's remote writes
    if (CS > 1) cluster_sync();
    else __syncthreads();
  }
}

// Dynamic shared memory of K3-fwd at (MT, CS): the Smem, and the sigmoid
// store when sp_on_chip.
size_t fwd_smem(int mt, int cs, int n_layers, bool sp_on_chip) {
  const size_t base = mt == 1 ? sizeof(k3f::Smem<1>) : mt == 2 ? sizeof(k3f::Smem<2>)
                      : mt == 3 ? sizeof(k3f::Smem<3>) : sizeof(k3f::Smem<4>);
  return base + (sp_on_chip ? (size_t)(n_layers - 1) * 16 * mt * (HID / cs) * 4 : 0);
}

template <int MT, int CS>
cudaError_t launch_fwd(int clusters, size_t smem, cudaStream_t st, const float* x, int n,
                       const void* wf, const void* wt2, const void* wlf, const float* bias,
                       const float* wlast0, int n_layers, int skip, int d_embed, int d_out,
                       float scale, float* value, float* feat, float* grad, float* scratch,
                       int sp_on_chip, int* occupancy) {
  auto kern = sdf_grad_fwd_kernel<MT, CS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(clusters * CS, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  if (occupancy) {   // the clusters (CS = 1: CTAs) the card holds at once
    if (CS > 1) return cudaOccupancyMaxActiveClusters(occupancy, kern, &cfg);
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    *occupancy = per_sm * sms;
    return e;
  }
  return cudaLaunchKernelEx(&cfg, kern, x, n, (const float2*)wf, (const float2*)wt2,
                            (const float2*)wlf, bias, wlast0, n_layers, skip, d_embed, d_out,
                            scale, value, feat, grad, scratch, sp_on_chip);
}

// K5 at 16 MT rows a tile: the forward sweep alone, one CTA a tile on a
// persistent grid of `ctas`; out[r * d_out + c] (c = 0 the sdf).  With
// held != nullptr, writes the CTAs the card holds at once and launches nothing.
template <int MT>
cudaError_t launch_full(int ctas, cudaStream_t st, const float* x, int n, const void* wf,
                        const void* wlf, const float* bias, int n_layers, int skip, int d_embed,
                        int d_out, float scale, float* out, int* held) {
  auto kern = sdf_grad_fwd_kernel<MT, 1, false>;
  const int smem = (int)sizeof(k3f::Smem<MT, false>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (held) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    *held = per_sm * sms;
    return e;
  }
  kern<<<ctas, THREADS, smem, st>>>(x, n, (const float2*)wf, nullptr, (const float2*)wlf, bias,
                                    nullptr, n_layers, skip, d_embed, d_out, scale, out, out + 1,
                                    nullptr, nullptr, 0);
  return cudaSuccess;
}

// The tile height K5 is built for (kernels/fused_sdf_grad.py::K5_ROWS).
cudaError_t dispatch_full(int rows, int ctas, cudaStream_t st, const float* x, int n,
                          const void* wf, const void* wlf, const float* bias, int n_layers,
                          int skip, int d_embed, int d_out, float scale, float* out, int* held) {
#define IRON_FULL(MT)                                                                      \
  return launch_full<MT>(ctas, st, x, n, wf, wlf, bias, n_layers, skip, d_embed, d_out,   \
                         scale, out, held)
  if (rows == 96) IRON_FULL(6);
#undef IRON_FULL
  return cudaErrorInvalidValue;
}

// The tilings K3-fwd is built for: width 1 with 64-row tiles, width 2 with
// 32 to 64, width 4 with 16 to 64 (kernels/fused_sdf_grad.py::fwd_tiling).
cudaError_t dispatch_fwd(int rows, int width, int clusters, size_t smem, cudaStream_t st,
                         const float* x, int n, const void* wf, const void* wt2,
                         const void* wlf, const float* bias, const float* wlast0, int n_layers,
                         int skip, int d_embed, int d_out, float scale, float* value,
                         float* feat, float* grad, float* scratch, int sp_on_chip,
                         int* occupancy) {
#define IRON_FWD(MT, CS)                                                                   \
  return launch_fwd<MT, CS>(clusters, smem, st, x, n, wf, wt2, wlf, bias, wlast0, n_layers, \
                            skip, d_embed, d_out, scale, value, feat, grad, scratch,       \
                            sp_on_chip, occupancy)
  if (width == 1 && rows == 64) IRON_FWD(4, 1);
  if (width == 2 && rows == 32) IRON_FWD(2, 2);
  if (width == 2 && rows == 48) IRON_FWD(3, 2);
  if (width == 2 && rows == 64) IRON_FWD(4, 2);
  if (width == 4 && rows == 16) IRON_FWD(1, 4);
  if (width == 4 && rows == 32) IRON_FWD(2, 4);
  if (width == 4 && rows == 48) IRON_FWD(3, 4);
  if (width == 4 && rows == 64) IRON_FWD(4, 4);
#undef IRON_FWD
  return cudaErrorInvalidValue;
}

// Launch configuration of the backward kernel: `clusters` clusters of 4
// CTAs, 256 threads, k3b::Smem of dynamic shared memory.
void bwd_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int clusters,
                cudaStream_t st) {
  cfg.gridDim = dim3(clusters * k3b::CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = sizeof(k3b::Smem);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k3b::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int MT>
cudaError_t launch_bwd(const cudaLaunchConfig_t& cfg, const float* x, int n, const float* dvf,
                       const float* dg, const void* wf, const void* wt2, const float* bias,
                       const float* wlast0, int n_layers, int skip, int d_embed, int d_out,
                       float scale, float* dx, float* part, int part_stride, int n_w,
                       float* scratch) {
  cudaError_t e = cudaFuncSetAttribute(sdf_grad_bwd_kernel<MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(k3b::Smem));
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, sdf_grad_bwd_kernel<MT>, x, n, dvf, dg, (const float2*)wf,
                            (const float2*)wt2, bias, wlast0, n_layers, skip, d_embed, d_out,
                            scale, dx, part, part_stride, n_w, scratch);
}

}  // namespace

extern "C" {

const char* iron_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Whether K3-fwd at (rows, width) keeps sigmoid(100 z) in shared memory:
// 1 when it fits beside the tiles, else 0; -1 on error.
int iron_grad_fwd_sp_on_chip(int rows, int width, int n_layers) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return fwd_smem(rows / 16, width, n_layers, true) <= (size_t)optin ? 1 : 0;
}

// The clusters of `width` CTAs (width 1: CTAs) of K3-fwd at (rows, width)
// the card holds at once; -1 on error.
int iron_grad_fwd_clusters(int rows, int width, int n_layers, int sp_on_chip) {
  int occ = 0;
  const size_t smem = fwd_smem(rows / 16, width, n_layers, sp_on_chip != 0);
  if (dispatch_fwd(rows, width, 1, smem, nullptr, nullptr, 0, nullptr, nullptr, nullptr,
                   nullptr, nullptr, n_layers, 0, 0, 0, 1.0f, nullptr, nullptr, nullptr,
                   nullptr, sp_on_chip, &occ) != cudaSuccess)
    return -1;
  return occ;
}

// rows, width: a tile's rows and the CTAs that share it, clusters: the
// persistent grid (kernels/fused_sdf_grad.py::fwd_tiling).  wf, wt2: K3-bwd's
// packed forward and transposed matrices; wlf: the final layer's forward
// pack.  sp_on_chip: iron_grad_fwd_sp_on_chip's answer; when 0, scratch
// holds clusters * (n_layers - 1) * rows * 256 floats.
int iron_sdf_value_feat_grad(const float* x, int n, const void* wf, const void* wt2,
                             const void* wlf, const float* bias, const float* wlast0,
                             int n_layers, int skip, int d_embed, int d_out, float scale,
                             float* value, float* feat, float* grad, float* scratch, int rows,
                             int width, int clusters, int sp_on_chip, void* stream) {
  if (n <= 0) return 0;
  if (clusters < 1 || d_out > 8 * k3f::OUT_NT || sp_on_chip < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(rows / 16, width, n_layers, sp_on_chip != 0);
  cudaError_t e = dispatch_fwd(rows, width, clusters, smem, (cudaStream_t)stream, x, n, wf, wt2,
                               wlf, bias, wlast0, n_layers, skip, d_embed, d_out, scale, value,
                               feat, grad, scratch, sp_on_chip, nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The CTAs of K5 at `rows` rows a tile that the card holds at once; -1 on
// error.
int iron_sdf_full_ctas(int rows) {
  int held = 0;
  if (dispatch_full(rows, 1, nullptr, nullptr, 0, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1.0f,
                    nullptr, &held) != cudaSuccess)
    return -1;
  return held;
}

// out: n x d_out floats.  wf, wlf: K3-fwd's packed hidden and final-layer
// matrices; rows: a tile's rows (96); ctas: the persistent grid.
int iron_sdf_full(const float* x, int n, const void* wf, const void* wlf, const float* bias,
                  int n_layers, int skip, int d_embed, int d_out, float scale, float* out,
                  int rows, int ctas, void* stream) {
  if (n <= 0) return 0;
  if (ctas < 1 || d_out > 8 * k3f::OUT_NT) return (int)cudaErrorInvalidValue;
  cudaError_t e = dispatch_full(rows, ctas, (cudaStream_t)stream, x, n, wf, wlf, bias, n_layers,
                                skip, d_embed, d_out, scale, out, nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of the backward kernel the card holds at once (one CTA an SM).
int iron_grad_bwd_clusters() {
  const int smem = (int)sizeof(k3b::Smem);
  if (cudaFuncSetAttribute(sdf_grad_bwd_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  bwd_config(cfg, attr, 1, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, sdf_grad_bwd_kernel<4>, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// rows: 16, 32, 48 or 64 points a tile; clusters: the persistent grid, in clusters
// of 4 CTAs.  wf, wt2: the packed forward and transposed matrices
// (kernels/fused_sdf_grad.py::prepare_grad_weights).  part: clusters *
// part_stride floats (part_stride = n_w matrix entries + the biases);
// scratch: 4 * clusters * 3 * (n_layers - 1) * rows * 64 floats; dparams:
// part_stride floats, the summed cotangents of the matrices then the biases.
int iron_sdf_value_feat_grad_bwd(const float* x, int n, const float* dvf, const float* dg,
                                 const void* wf, const void* wt2, const float* bias,
                                 const float* wlast0, int n_layers, int skip, int d_embed,
                                 int d_out, float scale, float* dx, float* part, int part_stride,
                                 int n_w, float* scratch, float* dparams, int rows, int clusters,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d_out > k3b::OUT_PAD || rows < 16 || rows > k3b::MAXR || rows % 16 || clusters < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * part_stride, st);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  bwd_config(cfg, attr, clusters, st);
  cudaError_t e;
  switch (rows) {
    case 16: e = launch_bwd<1>(cfg, x, n, dvf, dg, wf, wt2, bias, wlast0, n_layers, skip, d_embed,
                               d_out, scale, dx, part, part_stride, n_w, scratch); break;
    case 32: e = launch_bwd<2>(cfg, x, n, dvf, dg, wf, wt2, bias, wlast0, n_layers, skip, d_embed,
                               d_out, scale, dx, part, part_stride, n_w, scratch); break;
    case 48: e = launch_bwd<3>(cfg, x, n, dvf, dg, wf, wt2, bias, wlast0, n_layers, skip, d_embed,
                               d_out, scale, dx, part, part_stride, n_w, scratch); break;
    default: e = launch_bwd<4>(cfg, x, n, dvf, dg, wf, wt2, bias, wlast0, n_layers, skip, d_embed,
                               d_out, scale, dx, part, part_stride, n_w, scratch); break;
  }
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<(part_stride + 255) / 256, 256, 0, st>>>(part, clusters, part_stride,
                                                                    dparams);
  return (int)cudaGetLastError();
}

}  // extern "C"
