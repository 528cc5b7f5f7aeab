// K3 forward, iron_sdf_value_feat_grad: SDF value, the feature vector and the
// input gradient of the weight-normed softplus(100) SDF MLP in one forward
// and one reverse sweep, all in f32.
//
// Replaces the forward TPU kernel of
//   iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn
//   (_fwd_kernel, _forward_chain, _u_chain, _pe_value_d1_d2).
// K3 backward, iron_sdf_value_feat_grad_bwd, replaces its backward kernel
// (_bwd_kernel through _core_bwd): see the note above sdf_grad_bwd_kernel.
// K5, iron_sdf_full, replaces iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_fn
// (_kernel, _mlp_body): K3's forward sweep alone, [sdf / scale, features]
// for every point, f32.  524,544 MACs a point (the hidden chain and all 257
// outputs) against 1,040 bytes (12 in, 257 x 4 out), so f32 operations
// bound it too; TF32 would break the JAX package's 2e-5 hold on it.
//
// Layout (kernels/fused_sdf_grad.py::prepare_grad_weights): PE in reference
// column order padded to 48; hidden 256; the layer feeding the skip padded to
// 256 outputs; the skip's 1/sqrt(2) folded into its two matrices; the final
// layer kept at its true width d_out (257).  The reverse sweep
// u_{l-1} = (u_l @ W_l^T) * sigmoid(100 z_{l-1}) reads host-made transposes,
// so that both sweeps read weights coalesced.
//
// What bounds it on an H100: about 2 MFLOP a point in f32 (983,296 MACs:
// the forward to 257 outputs and the reverse sweep) against about 1 KB of
// output, so f32 operations on the CUDA cores bound it (TF32 tensor
// cores would break the 1e-5 parity the JAX package holds).  Each block takes
// 64 points, one thread per output column, accumulating the 64 rows in
// registers from broadcast float4 reads of the activation tile in shared
// memory; weights stream from L2.  The reverse sweep needs sigmoid(100 z) of
// every hidden layer (8 x 256 f32 a point, 512 KB for a tile, beyond shared
// memory), so each thread writes its own column of them to a scratch buffer
// that the wrapper allocates, and reads it back in the reverse sweep.  Blocks
// are persistent (as many as fit on the card walk all tiles), so the scratch
// stays small and mostly in L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "split3.cuh"

using namespace iron;

namespace {

constexpr int ROWS = 64;
constexpr int HID = 256;
constexpr int PE_W = 48;
constexpr int THREADS = 256;

struct GradSmem {
  float act[ROWS * HID];     // activations in the forward sweep, u in the reverse
  float pe[ROWS * PE_W];     // PE(y)
  float d1[ROWS * PE_W];     // dPE/dy
  float a0cot[ROWS * PE_W];  // cotangent of the PE input
  float y[ROWS][3];
};

__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) / 100.0f;
}

__device__ __forceinline__ float sigmoid100(float z) {
  return 1.0f / (1.0f + expf(-100.0f * z));
}

// acc[r] += sum_k A[r][k] * W[k*ldw + c] for the 64 rows of the tile
// (K a multiple of 4, A 16-byte aligned rows).
__device__ __forceinline__ void col_gemm(const float* A, int lda, int K,
                                         const float* __restrict__ W, int ldw, int c,
                                         float (&acc)[ROWS]) {
  for (int k = 0; k < K; k += 4) {
    const float w0 = __ldg(W + (size_t)(k + 0) * ldw + c);
    const float w1 = __ldg(W + (size_t)(k + 1) * ldw + c);
    const float w2 = __ldg(W + (size_t)(k + 2) * ldw + c);
    const float w3 = __ldg(W + (size_t)(k + 3) * ldw + c);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
      acc[r] = fmaf(a.x, w0, acc[r]);
      acc[r] = fmaf(a.y, w1, acc[r]);
      acc[r] = fmaf(a.z, w2, acc[r]);
      acc[r] = fmaf(a.w, w3, acc[r]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
}

// The tile of rows [row0, row0 + 64): sm.y = x * scale, sm.pe = PE(y),
// sm.d1 = dPE/dy (zero past d_embed), sm.a0cot cleared.  Ends with a barrier.
__device__ __forceinline__ void load_tile(GradSmem& sm, const float* __restrict__ x, int n,
                                          int row0, float scale, int d_embed) {
  const int tid = threadIdx.x;
  for (int i = tid; i < ROWS * 3; i += THREADS) {
    const int r = i / 3, j = i % 3;
    sm.y[r][j] = (row0 + r < n) ? x[(size_t)(row0 + r) * 3 + j] * scale : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < ROWS * PE_W; i += THREADS) {
    const int r = i / PE_W, c = i % PE_W;
    float v = 0.0f, d = 0.0f;
    if (c < d_embed) {
      if (c < 3) {
        v = sm.y[r][c];
        d = 1.0f;
      } else {
        const int q = (c - 3) / 3;          // sin block (even q) or cos block, frequency q/2
        const float f = ldexpf(1.0f, q >> 1);
        const float a = sm.y[r][(c - 3) % 3] * f;
        const float sa = sinf(a), ca = cosf(a);
        v = (q & 1) ? ca : sa;
        d = (q & 1) ? -f * sa : f * ca;
      }
    }
    sm.pe[i] = v;
    sm.d1[i] = d;
    sm.a0cot[i] = 0.0f;
  }
  __syncthreads();
}

// The forward sweep of the tile in sm.pe through every layer.  Hidden
// activations go to sm.act and, when sp_base is not null, sigmoid(100 z) of
// hidden layer l to sp_base + l * 64 * 256.  The final layer writes, for the
// rows below n, value[row * vstride] = z_0 / scale and
// feat[row * fstride + c - 1] = z_c (c >= 1).  wfwd: layer matrices
// [K_l x N_l] in layer order (skip layer: W_h then W_pe); bias: (n_layers-1)
// x 256 then d_out.  Every loop over the 64 rows of acc is fully unrolled,
// so acc stays in registers.  Ends with a barrier.
__device__ __forceinline__ void forward_sweep(GradSmem& sm, const float* __restrict__ wfwd,
                                              const float* __restrict__ bias, int n_layers,
                                              int skip, int d_out, float scale, int row0, int n,
                                              float* __restrict__ sp_base,
                                              float* __restrict__ value, int vstride,
                                              float* __restrict__ feat, int fstride) {
  const int tid = threadIdx.x;
  float acc[ROWS];
  const float* w = wfwd;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = (l == n_layers - 1);
    const int K = (l == 0) ? PE_W : HID;
    const int N = last ? d_out : HID;
    const float* A = (l == 0) ? sm.pe : sm.act;
    const float* bl = bias + l * HID;
    for (int c0 = 0; c0 < N; c0 += THREADS) {
      const int c = c0 + tid;
      zero(acc);
      if (c < N) {
        col_gemm(A, K, K, w, N, c, acc);
        if (l == skip) col_gemm(sm.pe, PE_W, PE_W, w + (size_t)K * N, N, c, acc);
      }
      if (!last) {
        __syncthreads();  // every read of the input tile is done
        const float b = __ldg(bl + c);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.act[r * HID + c] = softplus100(acc[r] + b);
        if (sp_base != nullptr) {
          float* sp = sp_base + (size_t)l * ROWS * HID;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) sp[r * HID + c] = sigmoid100(acc[r] + b);
        }
        __syncthreads();
      } else if (c < N) {
        const float b = __ldg(bl + c);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (row0 + r < n) {
            const float z = acc[r] + b;
            if (c == 0)
              value[(size_t)(row0 + r) * vstride] = z / scale;
            else
              feat[(size_t)(row0 + r) * fstride + (c - 1)] = z;
          }
        }
      }
    }
    w += (size_t)K * N + ((l == skip) ? (size_t)PE_W * N : 0);
  }
  __syncthreads();  // the final layer's reads of act are done
}

// wt: the transposes of wfwd's matrices, final layer excluded; wlast0: column
// 0 of the final matrix (256).
__global__ void __launch_bounds__(THREADS)
sdf_grad_fwd_kernel(const float* __restrict__ x, int n, const float* __restrict__ wfwd,
                    const float* __restrict__ wt, const float* __restrict__ bias,
                    const float* __restrict__ wlast0, int n_layers, int skip, int d_embed,
                    int d_out, float scale, float* __restrict__ value,
                    float* __restrict__ feat, float* __restrict__ grad,
                    float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int n_hidden = n_layers - 1;
  float* sp_base = scratch + (size_t)blockIdx.x * n_hidden * ROWS * HID;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  float acc[ROWS];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    load_tile(sm, x, n, row0, scale, d_embed);
    forward_sweep(sm, wfwd, bias, n_layers, skip, d_out, scale, row0, n, sp_base, value, 1,
                  feat, d_out - 1);

    // ---- reverse sweep: u_{L-2} = W_last[:, 0] * sigmoid(100 z_{L-2}) ----
    {
      const float* sp = sp_base + (size_t)(n_hidden - 1) * ROWS * HID;
      const float wl = __ldg(wlast0 + tid);
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) sm.act[r * HID + tid] = wl * sp[r * HID + tid];
    }
    __syncthreads();
    for (int l = n_hidden - 1; l >= 0; --l) {
      // offset of layer l's transposed matrix (uniform over the block)
      size_t off = 0;
      for (int m = 0; m < l; ++m)
        off += (size_t)HID * ((m == 0) ? PE_W : HID) + ((m == skip) ? (size_t)HID * PE_W : 0);
      const int K = (l == 0) ? PE_W : HID;   // input width of layer l
      if (l == skip && tid < PE_W) {
        zero(acc);
        col_gemm(sm.act, HID, HID, wt + off + (size_t)HID * K, PE_W, tid, acc);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.a0cot[r * PE_W + tid] += acc[r];
      }
      zero(acc);
      if (tid < K) col_gemm(sm.act, HID, HID, wt + off, K, tid, acc);
      __syncthreads();  // every read of u_l is done
      if (l > 0) {
        const float* sp = sp_base + (size_t)(l - 1) * ROWS * HID;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.act[r * HID + tid] = acc[r] * sp[r * HID + tid];
      } else if (tid < PE_W) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.a0cot[r * PE_W + tid] += acc[r];
      }
      __syncthreads();
    }

    // ---- grad_j = sum over the PE columns of axis j of a0cot * dPE/dy ----
    if (tid < ROWS * 3) {
      const int r = tid / 3, j = tid % 3;
      if (row0 + r < n) {
        float g = 0.0f;
        for (int c = j; c < d_embed; c += 3) g += sm.a0cot[r * PE_W + c] * sm.d1[r * PE_W + c];
        grad[(size_t)(row0 + r) * 3 + j] = g;
      }
    }
    __syncthreads();
  }
}

// K5: the forward sweep alone, one 64-row tile a block, writing out[row] =
// [z_0 / scale, z_1, ..., z_{d_out-1}] (d_out floats a row).
__global__ void __launch_bounds__(THREADS)
sdf_full_kernel(const float* __restrict__ x, int n, const float* __restrict__ wfwd,
                const float* __restrict__ bias, int n_layers, int skip, int d_embed, int d_out,
                float scale, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem_raw);
  const int row0 = blockIdx.x * ROWS;
  load_tile(sm, x, n, row0, scale, d_embed);
  forward_sweep(sm, wfwd, bias, n_layers, skip, d_out, scale, row0, n, nullptr, out, d_out,
                out + 1, d_out);
}

// Offset of layer l's first matrix in the concatenated layout (the skip
// layer's PE matrix follows its hidden one).  For l < n_layers it is also the
// offset of layer l's transposes in the hidden-transposes buffer.
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

// Blocks the card holds at once (the persistent grid): blocks per SM times sms.
int iron_grad_blocks(int sms) {
  const int smem = (int)sizeof(GradSmem);
  if (cudaFuncSetAttribute(sdf_grad_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return sms;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sdf_grad_fwd_kernel, THREADS,
                                                    smem) != cudaSuccess || per_sm < 1)
    per_sm = 1;
  return per_sm * sms;
}

// scratch: grid * (n_layers - 1) * 64 * 256 floats.
int iron_sdf_value_feat_grad(const float* x, int n, const float* wfwd, const float* wt,
                             const float* bias, const float* wlast0, int n_layers, int skip,
                             int d_embed, int d_out, float scale, float* value, float* feat,
                             float* grad, float* scratch, int grid, void* stream) {
  if (n <= 0) return 0;
  const int smem = (int)sizeof(GradSmem);
  cudaError_t e = cudaFuncSetAttribute(sdf_grad_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sdf_grad_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, n, wfwd, wt, bias, wlast0, n_layers, skip, d_embed, d_out, scale, value, feat,
      grad, scratch);
  return (int)cudaGetLastError();
}

// out: n x d_out floats.
int iron_sdf_full(const float* x, int n, const float* wfwd, const float* bias, int n_layers,
                  int skip, int d_embed, int d_out, float scale, float* out, void* stream) {
  if (n <= 0) return 0;
  const int smem = (int)sizeof(GradSmem);
  cudaError_t e = cudaFuncSetAttribute(sdf_full_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sdf_full_kernel<<<(n + ROWS - 1) / ROWS, THREADS, smem, (cudaStream_t)stream>>>(
      x, n, wfwd, bias, n_layers, skip, d_embed, d_out, scale, out);
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
