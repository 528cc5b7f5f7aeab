// K3 forward, iron_sdf_value_feat_grad: SDF value, the feature vector and the
// input gradient of the weight-normed softplus(100) SDF MLP in one forward
// and one reverse sweep, all in f32.
//
// Replaces the forward TPU kernel of
//   iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn
//   (_fwd_kernel, _forward_chain, _u_chain, _pe_value_d1_d2).
// The backward kernel (_bwd_kernel) is not ported yet.
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

// wfwd: layer matrices [K_l x N_l] in layer order (skip layer: W_h then W_pe);
// wt: their transposes, final layer excluded; bias: (n_layers-1) x 256 then
// d_out; wlast0: column 0 of the final matrix (256).  Every loop over the 64
// rows of acc is fully unrolled, so acc stays in registers.
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

    // ---- forward sweep ----
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
          float* sp = sp_base + (size_t)l * ROWS * HID;
          const float b = __ldg(bl + c);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float z = acc[r] + b;
            sm.act[r * HID + c] = softplus100(z);
            sp[r * HID + c] = sigmoid100(z);
          }
          __syncthreads();
        } else if (c < N) {
          const float b = __ldg(bl + c);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (row0 + r < n) {
              const float z = acc[r] + b;
              if (c == 0)
                value[row0 + r] = z / scale;
              else
                feat[(size_t)(row0 + r) * (d_out - 1) + (c - 1)] = z;
            }
          }
        }
      }
      w += (size_t)K * N + ((l == skip) ? (size_t)PE_W * N : 0);
    }
    __syncthreads();  // the final layer's reads of act are done

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

}  // extern "C"
