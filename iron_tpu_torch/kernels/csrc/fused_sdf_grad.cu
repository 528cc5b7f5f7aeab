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
// The TPU kernel adds dW/db into its outputs across a sequential grid.  Here
// blocks are persistent and run in parallel: each block adds its tiles' dW/db
// into its own partial buffer (every entry has one owning thread, so there is
// no atomic), and reduce_partials_kernel sums the blocks' partials in block
// order, so the result is the same from run to run.
//
// What bounds it on an H100: about 2.9 M multiply-adds a point (the hidden
// forward and the u-chain again, the two adjoint sweeps and the two dW
// products of every layer) against 1 KB of cotangents, so f32 operations on
// the CUDA cores bound it.  A tile's chains (z, vh and the u-chain's bar_z of 8 hidden
// layers, 1.5 MB at 64 rows) do not fit in shared memory; each block keeps
// them in its own global scratch, written and read back by the thread that
// owns the column, and keeps on chip only the two 64-row operand tiles of the
// products and the PE panels (196 KB).  The dW products are the same
// column-owner pattern as the forward: thread c holds column c of u_l or
// bz_l in registers and reads the other operand as broadcast float4 rows
// from shared memory.

constexpr int OUT_MAX = 260;   // the final layer's width rounded up to 4, at most

struct BwdSmem {
  float t0[ROWS * HID];        // a_l, u_0, bar_vh_l: the row operand of the dW products
  float t1[ROWS * OUT_MAX];    // bar_u_l, then bz_l: the A operand of the transposed products
  float pe[ROWS * PE_W];
  float d1[ROWS * PE_W];
  float a0cot[ROWS * PE_W];
  float bar_a0cot[ROWS * PE_W];
  float bar_a0[ROWS * PE_W];   // cotangent of the PE from the primal chain
  float y[ROWS][3];
  float dg[ROWS][3];
  float dx[ROWS][3];
};

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

// part[k * ldp + c] += sum_r P[r * ldP + k] * q[r] for k < K (K a multiple
// of 4): one column c of P^T q, for the thread that owns column c.
__device__ __forceinline__ void outer_acc(const float* P, int ldP, int K,
                                          const float (&q)[ROWS], float* part, int ldp,
                                          int c) {
  for (int k = 0; k < K; k += 4) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(P + r * ldP + k);
      s0 = fmaf(p.x, q[r], s0);
      s1 = fmaf(p.y, q[r], s1);
      s2 = fmaf(p.z, q[r], s2);
      s3 = fmaf(p.w, q[r], s3);
    }
    float* o = part + (size_t)k * ldp + c;
    o[0] += s0;
    o[ldp] += s1;
    o[2 * (size_t)ldp] += s2;
    o[3 * (size_t)ldp] += s3;
  }
}

// dvf: [n, d_out] cotangent of the final layer's output (the value's already
// divided by scale); dgr: [n, 3] cotangent of grad.  wt_last: the final
// layer's transpose [out_ld x 256], rows past d_out zero.  part: per block,
// n_w matrix entries (the concatenated layout) then the biases, part_stride
// floats a block.  scratch: per block 3 x (n_layers - 1) x 64 x 256 floats.
__global__ void __launch_bounds__(THREADS)
sdf_grad_bwd_kernel(const float* __restrict__ x, int n, const float* __restrict__ dvf,
                    const float* __restrict__ dgr, const float* __restrict__ wfwd,
                    const float* __restrict__ wt, const float* __restrict__ wt_last,
                    const float* __restrict__ bias, const float* __restrict__ wlast0,
                    int n_layers, int skip, int d_embed, int d_out, float scale,
                    float* __restrict__ dx_out, float* __restrict__ part, int part_stride,
                    int n_w, float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int L = n_layers, nh = n_layers - 1;
  const size_t slab = (size_t)ROWS * HID;
  float* Zs = scratch + (size_t)blockIdx.x * 3 * nh * slab;   // z_l, l < L-1
  float* VHs = Zs + nh * slab;                                 // vh_l, 1 <= l < L-1
  float* BZs = VHs + nh * slab;                                // the u-chain's bar_z_l
  float* dW = part + (size_t)blockIdx.x * part_stride;
  float* dB = dW + n_w;
  const int out_ld = (d_out + 3) & ~3;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int col = tid;         // the column this thread owns in 256-wide tiles
  const float wl = __ldg(wlast0 + col);
  float acc[ROWS];
  float q[ROWS];

  for (int i = tid; i < part_stride; i += THREADS) dW[i] = 0.0f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    for (int i = tid; i < ROWS * 3; i += THREADS) {
      const int r = i / 3, j = i % 3;
      const bool in = row0 + r < n;
      sm.y[r][j] = in ? x[(size_t)(row0 + r) * 3 + j] * scale : 0.0f;
      sm.dg[r][j] = in ? dgr[(size_t)(row0 + r) * 3 + j] : 0.0f;
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
          const int qq = (c - 3) / 3;
          const float f = ldexpf(1.0f, qq >> 1);
          const float a = sm.y[r][(c - 3) % 3] * f;
          const float sa = sinf(a), ca = cosf(a);
          v = (qq & 1) ? ca : sa;
          d = (qq & 1) ? -f * sa : f * ca;
        }
      }
      sm.pe[i] = v;
      sm.d1[i] = d;
      sm.a0cot[i] = 0.0f;
      sm.bar_a0[i] = 0.0f;
    }
    __syncthreads();

    // ---- 1. forward chain of the hidden layers, z_l to scratch ----
    for (int l = 0; l < nh; ++l) {
      const int K = (l == 0) ? PE_W : HID;
      const float* A = (l == 0) ? sm.pe : sm.t0;
      const float* w = wfwd + mat_off(l, L, skip, d_out);
      zero(acc);
      col_gemm(A, K, K, w, HID, col, acc);
      if (l == skip) col_gemm(sm.pe, PE_W, PE_W, w + (size_t)K * HID, HID, col, acc);
      __syncthreads();  // every read of the input tile is done
      const float b = __ldg(bias + l * HID + col);
      float* Z = Zs + l * slab;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float z = acc[r] + b;
        Z[r * HID + col] = z;
        sm.t0[r * HID + col] = softplus100(z);
      }
      __syncthreads();
    }

    // ---- 2. u-chain: u_{L-2} = W_last[:, 0] * sigmoid(100 z_{L-2}) ----
    {
      const float* Z = Zs + (nh - 1) * slab;
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) sm.t0[r * HID + col] = wl * sigmoid100(Z[r * HID + col]);
    }
    __syncthreads();
    for (int l = nh - 1; l >= 0; --l) {
      const size_t off = mat_off(l, L, skip, d_out);
      const int K = (l == 0) ? PE_W : HID;
      if (l == skip && tid < PE_W) {
        zero(acc);
        col_gemm(sm.t0, HID, HID, wt + off + (size_t)HID * K, PE_W, tid, acc);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.a0cot[r * PE_W + tid] += acc[r];
      }
      zero(acc);
      if (tid < K) col_gemm(sm.t0, HID, HID, wt + off, K, tid, acc);
      __syncthreads();  // every read of u_l is done
      if (l > 0) {
        const float* Z = Zs + (l - 1) * slab;
        float* VH = VHs + l * slab;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          VH[r * HID + col] = acc[r];
          sm.t0[r * HID + col] = acc[r] * sigmoid100(Z[r * HID + col]);
        }
      } else if (tid < PE_W) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.a0cot[r * PE_W + tid] += acc[r];
      }
      __syncthreads();
    }
    // sm.t0 now holds u_0

    // ---- 3. output stage ----
    for (int i = tid; i < ROWS * PE_W; i += THREADS) {
      const int r = i / PE_W, c = i % PE_W;
      sm.bar_a0cot[i] = (c < d_embed) ? sm.dg[r][c % 3] * sm.d1[i] : 0.0f;
    }
    if (tid < ROWS * 3) {
      // d(dPE_c/dy)/dy = d2PE_c/dy2 = -f^2 PE_c on the sin/cos columns
      const int r = tid / 3, j = tid % 3;
      float s = 0.0f;
      for (int c = 3 + j; c < d_embed; c += 3) {
        const float f = ldexpf(1.0f, ((c - 3) / 3) >> 1);
        s += sm.a0cot[r * PE_W + c] * (-f * f * sm.pe[r * PE_W + c]);
      }
      sm.dx[r][j] = scale * sm.dg[r][j] * s;
    }
    __syncthreads();

    // ---- 4. adjoint of the u-chain, forward order ----
    // l = 0: bar_vh_0 = bar_a0cot; dW_0 += bar_a0cot^T u_0; bar_u_0 = bar_a0cot @ W_0
#pragma unroll
    for (int r = 0; r < ROWS; ++r) q[r] = sm.t0[r * HID + col];
    outer_acc(sm.bar_a0cot, PE_W, PE_W, q, dW + mat_off(0, L, skip, d_out), HID, col);
    zero(acc);
    col_gemm(sm.bar_a0cot, PE_W, PE_W, wfwd + mat_off(0, L, skip, d_out), HID, col, acc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sm.t1[r * HID + col] = acc[r];
    __syncthreads();  // every read of u_0 is done
    for (int l = 1; l < L; ++l) {
      // bar_vh_l = bar_u_{l-1} * sigma'(z_{l-1}) -> t0; the u-chain's share of
      // bar_z_{l-1} = bar_u_{l-1} * vh_l * sigma''(z_{l-1}) -> scratch
      {
        const float* Z = Zs + (l - 1) * slab;
        const float* VH = VHs + l * slab;
        float* BZ = BZs + (l - 1) * slab;
#pragma unroll 8
        for (int r = 0; r < ROWS; ++r) {
          const float bu = sm.t1[r * HID + col];
          const float s = sigmoid100(Z[r * HID + col]);
          const float vh = (l == L - 1) ? wl : VH[r * HID + col];
          sm.t0[r * HID + col] = bu * s;
          BZ[r * HID + col] = bu * vh * (100.0f * s * (1.0f - s));
        }
      }
      __syncthreads();
      const size_t off = mat_off(l, L, skip, d_out);
      if (l == L - 1) {
        // u_{L-1} = e0: only the sdf column of the final matrix
        float s = 0.0f;
        for (int r = 0; r < ROWS; ++r) s += sm.t0[r * HID + col];
        dW[off + (size_t)col * d_out] += s;
      } else {
        // u_l = vh_{l+1} * sigma'(z_l), column col
        const float* Z = Zs + l * slab;
        const float* VH = VHs + (l + 1) * slab;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          q[r] = ((l + 1 == L - 1) ? wl : VH[r * HID + col]) * sigmoid100(Z[r * HID + col]);
        outer_acc(sm.t0, HID, HID, q, dW + off, HID, col);
        if (l == skip) outer_acc(sm.bar_a0cot, PE_W, PE_W, q, dW + off + (size_t)HID * HID, HID, col);
        zero(acc);
        col_gemm(sm.t0, HID, HID, wfwd + off, HID, col, acc);
        if (l == skip) col_gemm(sm.bar_a0cot, PE_W, PE_W, wfwd + off + (size_t)HID * HID, HID,
                                col, acc);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.t1[r * HID + col] = acc[r];
      }
      __syncthreads();  // every read of bar_vh_l is done
    }

    // ---- 5. adjoint of the primal chain, reverse order ----
    // l = L-1: bz = dvf; a_{L-1} = softplus(z_{L-2})
    {
      const float* Z = Zs + (nh - 1) * slab;
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) sm.t0[r * HID + col] = softplus100(Z[r * HID + col]);
      for (int i = tid; i < ROWS * out_ld; i += THREADS) {
        const int r = i / out_ld, c = i % out_ld;
        sm.t1[i] = (c < d_out && row0 + r < n) ? dvf[(size_t)(row0 + r) * d_out + c] : 0.0f;
      }
    }
    __syncthreads();
    {
      const size_t off = mat_off(L - 1, L, skip, d_out);
      for (int c0 = 0; c0 < d_out; c0 += THREADS) {
        const int c = c0 + tid;
        if (c < d_out) {
          float s = 0.0f;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            q[r] = sm.t1[r * out_ld + c];
            s += q[r];
          }
          dB[nh * HID + c] += s;
          outer_acc(sm.t0, HID, HID, q, dW + off, d_out, c);
        }
      }
      zero(acc);
      col_gemm(sm.t1, out_ld, out_ld, wt_last, HID, col, acc);   // bar_a_{L-1}
    }
    __syncthreads();  // every read of t0 and t1 is done
    for (int l = nh - 1; l >= 0; --l) {
      const size_t off = mat_off(l, L, skip, d_out);
      const int K = (l == 0) ? PE_W : HID;
      {
        // bz_l = bar_z_l + bar_a_{l+1} * sigma'(z_l) -> t1 (and q); a_l -> t0
        const float* Z = Zs + l * slab;
        const float* BZ = BZs + l * slab;
        const float* Zp = Zs + (l > 0 ? l - 1 : 0) * slab;
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          q[r] = BZ[r * HID + col] + acc[r] * sigmoid100(Z[r * HID + col]);
          s += q[r];
          sm.t1[r * HID + col] = q[r];
          if (l > 0) sm.t0[r * HID + col] = softplus100(Zp[r * HID + col]);
        }
        dB[l * HID + col] += s;
      }
      __syncthreads();
      outer_acc((l == 0) ? sm.pe : sm.t0, K, K, q, dW + off, HID, col);
      if (l == skip) {
        outer_acc(sm.pe, PE_W, PE_W, q, dW + off + (size_t)HID * HID, HID, col);
        if (tid < PE_W) {
          zero(acc);
          col_gemm(sm.t1, HID, HID, wt + off + (size_t)HID * K, PE_W, tid, acc);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) sm.bar_a0[r * PE_W + tid] += acc[r];
        }
      }
      zero(acc);
      if (tid < K) col_gemm(sm.t1, HID, HID, wt + off, K, tid, acc);   // bar_a_l
      if (l == 0 && tid < PE_W) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sm.bar_a0[r * PE_W + tid] += acc[r];
      }
      __syncthreads();  // every read of t0 and t1 is done
    }

    // ---- 6. dx ----
    if (tid < ROWS * 3) {
      const int r = tid / 3, j = tid % 3;
      if (row0 + r < n) {
        float s = 0.0f;
        for (int c = j; c < d_embed; c += 3) s += sm.bar_a0[r * PE_W + c] * sm.d1[r * PE_W + c];
        dx_out[(size_t)(row0 + r) * 3 + j] = sm.dx[r][j] + scale * s;
      }
    }
    __syncthreads();
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

// Blocks the card holds at once for the backward kernel.
int iron_grad_bwd_blocks(int sms) {
  const int smem = (int)sizeof(BwdSmem);
  if (cudaFuncSetAttribute(sdf_grad_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return sms;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sdf_grad_bwd_kernel, THREADS,
                                                    smem) != cudaSuccess || per_sm < 1)
    per_sm = 1;
  return per_sm * sms;
}

// part: grid * part_stride floats (part_stride = n_w matrix entries + the
// biases); scratch: grid * 3 * (n_layers - 1) * 64 * 256 floats; dparams:
// part_stride floats, the summed cotangents of the matrices then the biases.
int iron_sdf_value_feat_grad_bwd(const float* x, int n, const float* dvf, const float* dg,
                                 const float* wfwd, const float* wt, const float* wt_last,
                                 const float* bias, const float* wlast0, int n_layers,
                                 int skip, int d_embed, int d_out, float scale, float* dx,
                                 float* part, int part_stride, int n_w, float* scratch,
                                 float* dparams, int grid, void* stream) {
  if (d_out > OUT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * part_stride, st);
  const int smem = (int)sizeof(BwdSmem);
  cudaError_t e = cudaFuncSetAttribute(sdf_grad_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sdf_grad_bwd_kernel<<<grid, THREADS, smem, st>>>(
      x, n, dvf, dg, wfwd, wt, wt_last, bias, wlast0, n_layers, skip, d_embed, d_out, scale,
      dx, part, part_stride, n_w, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<(part_stride + 255) / 256, 256, 0, st>>>(part, grid, part_stride,
                                                                    dparams);
  return (int)cudaGetLastError();
}

}  // extern "C"
