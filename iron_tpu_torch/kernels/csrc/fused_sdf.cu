// SDF evaluators for the sphere tracer on the bf16 tensor cores: the coarse
// K1 and K2, bf16 operands with f32 accumulation (the JAX package's coarse
// precision class), and the accurate K4, three bf16 passes on split operands.
//
// K2, iron_sdf_only_bf16, replaces the TPU kernel of
//   iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_only_bf16_fn (_sdf_only_kernel_bf16):
//   x [N,3] -> sdf [N].  See the note above sdf_only_bf16_kernel.
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
// What bounds K1, K2 and K4 on an H100: the chain is 9 dense layers of 256
// per point, about 0.92 MFLOP a point (459,008 MACs to the sdf column)
// against 12-40 bytes of input and output, so tensor-core operations bound
// them, not device memory.  The bf16 weights (about 0.97 MB) do not fit in a
// block's shared memory; every tile streams them from L2: K1 and K4 as
// pre-packed mma fragments straight into registers, K2 through a ring of
// k-tiles in shared memory that two warpgroups share.  K1 is a persistent
// launch that compacts the active rays between iterations: see the K1 note
// below.
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

// ---------------------------------------------------------------------------
// K2, the fallback sweep's coarse SDF.  A call holds 131,072 points (1,024
// rays x 128 samples): the card is full, and what a tile costs is its share
// of the weight stream and of the products and epilogues.  The design for
// Hopper's warpgroups:
//
//   * One CTA an SM (a persistent grid) takes 128 rows at a time: two
//     consumer warpgroups of 64 rows each and one producer warpgroup, of
//     which one thread works.  Every weight byte that reaches the SM serves
//     both consumer warpgroups, 128 rows (the body K2 had before read all
//     0.97 MB of weights from L2 for every 64 rows).  The producer gives its
//     registers to the consumers (setmaxnreg: 24 and 240 a thread).
//   * The producer streams the weights, k-tile after k-tile in the order of
//     the layers, with one bulk copy (TMA, 1-D, no tensor map) of 8 KB a
//     k-tile into a ring of STAGES k-tiles in shared memory, completed on a
//     "full" mbarrier a stage; each consumer warpgroup frees a stage on its
//     "empty" mbarrier once the products that read it are done.  The host
//     packs each k-tile in the order the wgmma descriptor reads it, swizzle
//     included (kernels/fused_sdf.py::pack_wgmma_b), so a plain copy lands
//     it.
//   * Each hidden layer is a chain of wgmma.mma_async m64n256k16 (bf16, f32
//     accumulation) a warpgroup, one a k-tile, A from registers and B from
//     the ring, INFLIGHT products in flight behind the one issued.  The
//     accumulator of a 256-wide layer has the layout of the next layer's A
//     fragments for K = 256, so the epilogue (bias, the SFU softplus, bf16)
//     writes the next layer's A straight into registers: activations never
//     go back to shared memory.  The PE tile (48 columns, 3 k-tiles) is read
//     from shared memory by ldmatrix, for layer 0 and the skip; the skip's
//     1/sqrt(2) is applied after its sum, as K1 does.
//   * The two warpgroups take turns at the tensor cores, so that one's
//     products run during the other's epilogue (14% faster than in
//     lockstep).
//   * The final layer (the sdf column) sums each row on the CUDA cores in a
//     fixed order: a row's 256 values lie in one quad of lanes, each lane
//     sums its 64, then two shuffles.
//
// What bounds it on an H100 (PERF.md; scripts/trace_kernels_torch.py,
// scripts/ablate_k2_k5_torch.py): the epilogues, about half of a tile's
// cycles (two SFU operations and ~9 others a value, 128 values a thread a
// layer), then the products; not the weight stream: with the copies past
// the first ring left out the call takes as long.  A 2-CTA cluster that
// multicasts each k-tile into both rings (256 rows a weight read) and K2 on
// K1's evaluation (mma.sync, two 64-row CTAs an SM) were built and timed
// slower; the ablation script builds both.
//
// Shared memory ~208 KB a CTA (the ring 192 KB, two PE tiles, the rows'
// points, the barriers); 384 threads.
namespace k2 {

constexpr int WG_ROWS = 64;                    // rows of a consumer warpgroup
constexpr int CONSUMERS = 2;                   // consumer warpgroups a CTA
constexpr int TILE = CONSUMERS * WG_ROWS;      // rows a CTA takes at a time
constexpr int THREADS = 128 * (CONSUMERS + 1); // and the producer warpgroup
constexpr int STAGES = 24;                     // k-tiles in the ring: a layer and a half
constexpr int KT_BYTES = 16 * HID * 2;         // a bf16 16 x 256 k-tile

struct Smem {
  unsigned char ring[STAGES][KT_BYTES];        // first: 1024-byte aligned
  __nv_bfloat16 pe[CONSUMERS][WG_ROWS * P_STRIDE];
  float y[TILE][3];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

}  // namespace k2

// wg: the swizzled k-tiles of the hidden layers in layer order (n_ktiles of
// them; the skip layer's hidden then PE matrix); bias and wlast as K1's.
__global__ void __launch_bounds__(k2::THREADS, 1)
sdf_only_bf16_kernel(const float* __restrict__ x, int n, const unsigned char* __restrict__ wg,
                     int n_ktiles, const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ wlast, int n_layers, int skip,
                     int d_embed, float scale, float inv_scale, float* __restrict__ out) {
  using namespace k2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (n + TILE - 1) / TILE;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);   // a thread of each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // ---- the producer: the weight stream, once a tile ----
    setmaxnreg_dec<24>();
    if (tid == 128 * CONSUMERS) {
      uint32_t c = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int k = 0; k < n_ktiles; ++k, ++c) {
          const int s = c % STAGES;
          if (c >= STAGES) mbar_wait(&sm.empty[s], (c / STAGES - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[s], KT_BYTES);
          bulk_load(sm.ring[s], wg + (size_t)k * KT_BYTES, KT_BYTES, &sm.full[s]);
        }
      }
    }
  } else {
    // ---- a consumer warpgroup: rows [64 wgi, 64 wgi + 64) of each tile ----
    setmaxnreg_inc<240>();
    const int wgi = warp >> 2, wwarp = warp & 3, wtid = tid & 127;
    // the two warpgroups take turns at the tensor cores (named barriers 3
    // and 4), warpgroup 0 first: one's products run during the other's
    // epilogue
    if (wgi == 1) named_arrive(3, 256);
    const int g = lane >> 2, t = lane & 3;
    __nv_bfloat16* pe = sm.pe[wgi];
    float (*y)[3] = sm.y + wgi * WG_ROWS;
    uint32_t c = 0;   // the k-tile of the stream
    float acc[128];
    uint32_t a[HID / 16][4];
    // this warpgroup is done with the stage of k-tile ck (its wgmma waits
    // have returned)
    auto release = [&](uint32_t ck) {
      if (wtid == 0) mbar_arrive(&sm.empty[ck % STAGES]);
    };
    // acc (+)= A @ k-tile c, the i-th product of a layer (i = 0 overwrites
    // acc); once the product INFLIGHT before it is done, free that one's stage
    constexpr int INFLIGHT = 1;   // products in flight behind the one issued
    auto product = [&](const uint32_t (&ar)[4], int i) {
      const int s = c % STAGES;
      mbar_wait(&sm.full[s], (c / STAGES) & 1);
      wgmma_fence();
      wgmma_m64n256k16_bf16(acc, ar, wgmma_desc_k16_sw32(sm.ring[s]), i > 0 ? 1 : 0);
      wgmma_commit();
      if (i >= INFLIGHT) {
        wgmma_wait<INFLIGHT>();
        release(c - INFLIGHT);
      }
      ++c;
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile * TILE + wgi * WG_ROWS;
      named_sync(1 + wgi, 128);   // the tile before is done with y and the PE tile
      for (int i = wtid; i < WG_ROWS * 3; i += 128) {
        const int r = i / 3, j = i % 3;
        y[r][j] = (row0 + r < n) ? x[(size_t)(row0 + r) * 3 + j] * scale : 0.0f;
      }
      named_sync(1 + wgi, 128);
      fill_pe_sincos(pe, y, WG_ROWS, d_embed, wtid, 128);
      named_sync(1 + wgi, 128);

      for (int l = 0; l < n_layers - 1; ++l) {
        uint32_t ape[PE_W / 16][4];
        const bool pe_in = (l == 0 || l == skip);
        if (pe_in) {
#pragma unroll
          for (int kt = 0; kt < PE_W / 16; ++kt) k4::load_a_ldm(pe, P_STRIDE, wwarp, kt, ape[kt]);
        }
#pragma unroll
        for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
        named_sync(3 + wgi, 256);   // this warpgroup's turn
        int products = 0;   // of this layer
        if (l == 0) {
#pragma unroll
          for (int kt = 0; kt < PE_W / 16; ++kt) product(ape[kt], products++);
        } else {
#pragma unroll
          for (int kt = 0; kt < HID / 16; ++kt) product(a[kt], products++);
          if (l == skip) {
#pragma unroll
            for (int kt = 0; kt < PE_W / 16; ++kt) product(ape[kt], products++);
          }
        }
        named_arrive(4 - wgi, 256);   // the other warpgroup's turn
        wgmma_wait<0>();
        for (int q = min(INFLIGHT, products); q >= 1; --q) release(c - q);
        // the products are done with their registers
#pragma unroll
        for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
#pragma unroll
        for (int kt = 0; kt < HID / 16; ++kt)
#pragma unroll
          for (int e = 0; e < 4; ++e) reg_fence(a[kt][e]);
        if (pe_in) {
#pragma unroll
          for (int kt = 0; kt < PE_W / 16; ++kt)
#pragma unroll
            for (int e = 0; e < 4; ++e) reg_fence(ape[kt][e]);
        }
        // z = acc * post + b; softplus; bf16: the next layer's A fragments.
        // Columns 16 kt + 2 t (+1) are n-tile 2 kt, 16 kt + 8 + 2 t (+1)
        // n-tile 2 kt + 1; rows g and g + 8 of the warp's 16.
        const float post = (l == skip) ? INV_SQRT2 : 1.0f;
        const float* bl = bias + l * HID;
#pragma unroll
        for (int kt = 0; kt < HID / 16; ++kt) {
          const float2 b0 = __ldg(reinterpret_cast<const float2*>(bl + 16 * kt + 2 * t));
          const float2 b1 = __ldg(reinterpret_cast<const float2*>(bl + 16 * kt + 8 + 2 * t));
          const float* d = acc + 8 * kt;
          a[kt][0] = pack_bf16(k4::softplus100_fast(d[0] * post + b0.x),
                               k4::softplus100_fast(d[1] * post + b0.y));
          a[kt][1] = pack_bf16(k4::softplus100_fast(d[2] * post + b0.x),
                               k4::softplus100_fast(d[3] * post + b0.y));
          a[kt][2] = pack_bf16(k4::softplus100_fast(d[4] * post + b1.x),
                               k4::softplus100_fast(d[5] * post + b1.y));
          a[kt][3] = pack_bf16(k4::softplus100_fast(d[6] * post + b1.x),
                               k4::softplus100_fast(d[7] * post + b1.y));
        }
      }

      // final layer, the sdf column of rows g and g + 8: this lane's 64
      // products each, then the quad's sum
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int kt = 0; kt < HID / 16; ++kt) {
        const uint32_t* wl = reinterpret_cast<const uint32_t*>(wlast + 16 * kt + 2 * t);
        const float2 w0 = unpack_bf16(__ldg(wl)), w1 = unpack_bf16(__ldg(wl + 4));
        const float2 h0 = unpack_bf16(a[kt][0]), h1 = unpack_bf16(a[kt][1]);
        const float2 h2 = unpack_bf16(a[kt][2]), h3 = unpack_bf16(a[kt][3]);
        s0 = fmaf(h0.x, w0.x, s0);
        s0 = fmaf(h0.y, w0.y, s0);
        s0 = fmaf(h2.x, w1.x, s0);
        s0 = fmaf(h2.y, w1.y, s0);
        s1 = fmaf(h1.x, w0.x, s1);
        s1 = fmaf(h1.y, w0.y, s1);
        s1 = fmaf(h3.x, w1.x, s1);
        s1 = fmaf(h3.y, w1.y, s1);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const int r = row0 + 16 * wwarp + g;
      const float b_last = __ldg(bias + (n_layers - 1) * HID);
      if (t == 0 && r < n) out[r] = (s0 + b_last) * inv_scale;
      if (t == 0 && r + 8 < n) out[r + 8] = (s1 + b_last) * inv_scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K1, the coarse march.  A training step marches 16,384 and 2,048 rays, of
// which a few thousand march at all and a few hundred are still marching
// after five iterations; a 512² view marches 262,144.  So the march is a
// chain of up to n_iters + 1 dependent evaluations per ray, on a card that
// a step keeps nearly empty and a view fills.  The design:
//
//   * One persistent launch of as many CTAs as the card holds at once (two
//     an SM, iron_coarse_march_ctas), at most one a 64-ray tile of the
//     call.  Iteration -1 evaluates every ray at acc0 (the rays outside
//     `work` too) and appends each ray that marches on to a device-side
//     list of active ray indices; iteration i takes its 64-ray tiles from
//     list i and appends the rays still active to list i + 1 (a
//     warp-aggregated atomicAdd).  The grid meets at a barrier between
//     iterations (sm90.cuh::grid_sync) and leaves together when a list is
//     empty.  The launch is cooperative: every CTA is resident at once
//     whatever else runs on the card (another stream's kernel, a cap on the
//     SMs), or the launch fails; a grid sized from an idle card's occupancy
//     and launched plainly could spin at the barrier.  A block
//     marches no ray that has stopped: a 512² view's march takes 20,082
//     tile-evaluations where one 64-ray block a tile to its slowest ray
//     took 36,652.  No host sync: the wrapper allocates the lists and
//     counts and returns.
//   * Each evaluation is K4's body in one pass: A fragments by ldmatrix, B
//     fragments from L2 straight into registers PF k-tiles ahead of their
//     use, in one stream across the layers.  A tile's evaluation is bound
//     by its CTA's L2 stream (~0.97 MB of bf16 weights), so two CTAs an SM
//     (at most 128 registers a thread) run two streams.  The epilogue's
//     softplus takes the SFU's exp and log (within 1e-8 of the precise
//     form, far under bf16's 2^-9); the PE takes sin and cos of an angle
//     from one sincosf.  The final layer sums each row in a fixed order
//     (four threads a row, 64 products each, then two shuffles), so a ray's
//     result does not depend on its tile or its row.
//   * Splitting a short iteration's tiles over the columns of a 2- or
//     4-CTA cluster, as K4 does, was built and timed on an NVIDIA H100
//     80GB HBM3 at 700 W: the exchange of each layer's activations and the
//     cluster barrier (~3k cycles a layer) cost what the narrower weight
//     stream saved, so no step or view march was faster than at one CTA a
//     tile (PERF.md).
//
// Shared memory ~77 KB a CTA (two bf16 activation tiles, the PE tile, the
// rows' ray state).
namespace k1 {

constexpr int PF = 4;   // k-tiles of B fragments in flight
constexpr int SM_SLOTS = 1024;   // CTA counts by %smid (coarse_march_kernel)

struct Smem {
  __nv_bfloat16 act[2][ROWS * H_STRIDE];
  __nv_bfloat16 pe[ROWS * P_STRIDE];
  float y[ROWS][3];    // scaled sample points of the tile's rows
  float out[ROWS];     // sdf * scale of the tile's rows
  float acc[ROWS];     // each row's marched distance
  int ray[ROWS];       // each row's ray, -1 for an empty row
  int count;           // the active list's length, read after a grid barrier
  int place;           // where this CTA takes its tiles from iteration 0 on
};

struct Args {
  const float* ray_o;
  const float* ray_d;
  const float* acc0;
  const uint8_t* work;
  const float* max_dis;
  int n, n_iters;
  float thr;
  const uint2* wpack;
  int n_ktiles;
  const float* bias;
  const __nv_bfloat16* wlast;
  int n_layers, skip, d_embed;
  float scale, inv_scale;
  float* acc_out;
  float* sdf_out;
  uint8_t* act_out;
  int* lists;          // two lists of n ray indices, used in turns
  int* counts;         // n_iters + 1 list lengths, zero at launch
  unsigned* barrier;   // grid barrier count, zero at launch
  unsigned* places;    // 2 + SM_SLOTS counts of CTAs, zero at launch (coarse_march_kernel)
};

// sm.out[r] = sdf(sm.y[r]) * scale for the tile's 64 rows; warp w computes
// all 4 m-tiles of the n-tiles [4 w, 4 w + 4) of every hidden layer.  Ends
// with a block barrier after sm.out is written.
__device__ void eval_tile(Smem& sm, const Args& p) {
  constexpr int MTW = 4, NTW = 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt0 = NTW * warp;

  // the weight stream, k-tile c of the packed matrices in slot c % PF
  const size_t lane_off = (size_t)nt0 * 32 + lane;
  uint2 bh[PF][NTW];
  auto fetch = [&](int c, uint2 (&h)[NTW]) {
    if (c >= p.n_ktiles) return;
    const size_t o = (size_t)c * k4::KT_WORDS + lane_off;
#pragma unroll
    for (int j = 0; j < NTW; ++j) h[j] = __ldg(p.wpack + o + j * 32);
  };
#pragma unroll
  for (int i = 0; i < PF; ++i) fetch(i, bh[i]);

  fill_pe_sincos(sm.pe, sm.y, ROWS, p.d_embed, tid, THREADS);
  __syncthreads();

  int c = 0;
  float acc[MTW][NTW][4];
  auto consume = [&](const __nv_bfloat16* A, int stride, int KT) {
    const int c_end = c + KT;
    for (int c0 = c - c % PF; c0 < c_end; c0 += PF) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int ck = c0 + i;
        if (ck < c || ck >= c_end) continue;
        uint32_t a[MTW][4];
#pragma unroll
        for (int m = 0; m < MTW; ++m) k4::load_a_ldm(A, stride, m, ck - c, a[m]);
        uint2 b[NTW];
#pragma unroll
        for (int j = 0; j < NTW; ++j) b[j] = bh[i][j];
        fetch(ck + PF, bh[i]);
#pragma unroll
        for (int m = 0; m < MTW; ++m)
#pragma unroll
          for (int j = 0; j < NTW; ++j) mma_bf16(acc[m][j], a[m], b[j].x, b[j].y);
      }
    }
    c = c_end;
  };

  int cur = 0;
  for (int l = 0; l < p.n_layers - 1; ++l) {
#pragma unroll
    for (int m = 0; m < MTW; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[m][j][k] = 0.0f;
    int nxt = 0;
    if (l == 0) {
      consume(sm.pe, P_STRIDE, PE_W / 16);
    } else {
      consume(sm.act[cur], H_STRIDE, HID / 16);
      if (l == p.skip) consume(sm.pe, P_STRIDE, PE_W / 16);
      nxt = cur ^ 1;
    }
    const float post = (l == p.skip) ? INV_SQRT2 : 1.0f;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = (nt0 + j) * 8 + 2 * t;
      const float b0 = __ldg(p.bias + l * HID + col), b1 = __ldg(p.bias + l * HID + col + 1);
#pragma unroll
      for (int m = 0; m < MTW; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          store_pair(k4::softplus100_fast(acc[m][j][2 * half] * post + b0),
                     k4::softplus100_fast(acc[m][j][2 * half + 1] * post + b1),
                     sm.act[nxt] + (m * 16 + g + 8 * half) * H_STRIDE + col);
    }
    __syncthreads();
    cur = nxt;
  }

  // final layer, the sdf column: four threads a row
  {
    const int r = tid >> 2, q = tid & 3;
    const __nv_bfloat16* hh = sm.act[cur] + r * H_STRIDE + q * 64;
    const __nv_bfloat16* wh = p.wlast + q * 64;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < 64; k += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hh + k));
      const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wh + k));
      s = fmaf(a.x, w.x, s);
      s = fmaf(a.y, w.y, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) sm.out[r] = s + __ldg(p.bias + (p.n_layers - 1) * HID);
  }
  __syncthreads();
}

// One iteration of the march over its m active rays (list == nullptr:
// iteration -1, every ray at acc0): the CTA takes the 64-ray tiles block,
// block + gridDim.x, ...
__device__ void march_iteration(Smem& sm, const Args& p, int m, int block, const int* list,
                                int* next, int* next_count) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int tiles = (m + ROWS - 1) / ROWS;
  for (int tile = block; tile < tiles; tile += gridDim.x) {
    if (tid < ROWS) {
      const int j = tile * ROWS + tid;
      int ray = -1;
      float a = 0.0f;
      if (j < m) {
        // state written by other CTAs in the iteration before: read past L1
        ray = list ? __ldcg(list + j) : j;
        a = list ? __ldcg(p.acc_out + ray) + __ldcg(p.sdf_out + ray) : p.acc0[ray];
      }
      sm.ray[tid] = ray;
      sm.acc[tid] = a;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sm.y[tid][k] = ray >= 0 ? (p.ray_o[(size_t)ray * 3 + k] + p.ray_d[(size_t)ray * 3 + k] * a)
                                      * p.scale : 0.0f;
    }
    __syncthreads();
    eval_tile(sm, p);
    // the rows' new state, and the rays that march on
    bool keep = false;
    int ray = -1;
    if (tid < ROWS) {
      ray = sm.ray[tid];
      if (ray >= 0) {
        const float s = sm.out[tid] * p.inv_scale, a = sm.acc[tid];
        keep = (list || p.work[ray] != 0) && fabsf(s) > p.thr && a < p.max_dis[ray];
        p.acc_out[ray] = a;
        p.sdf_out[ray] = s;
        p.act_out[ray] = keep ? 1 : 0;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (bal) {
        const int leader = __ffs(bal) - 1;
        int pos = 0;
        if (lane == leader) pos = atomicAdd(next_count, __popc(bal));
        pos = __shfl_sync(0xffffffffu, pos, leader);
        if (keep) next[pos + __popc(bal & ((1u << lane) - 1))] = ray;
      }
    }
    __syncthreads();   // sm.ray, sm.acc and sm.out are read before the next tile's loads
  }
}

}  // namespace k1

__global__ void __launch_bounds__(THREADS, 2)
coarse_march_kernel(const __grid_constant__ k1::Args p) {
  using namespace k1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  int m = p.n;
  // From iteration 0 on, an iteration's few tiles go to the CTAs in an order
  // that puts the CTAs first on their SM before the second ones: a
  // cooperative launch places CTAs two to an SM from the start (CTAs k and
  // k + 8 share one), and block order would crowd the tiles onto half as
  // many SMs, two weight streams an SM.
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(smid));
    const bool first = atomicAdd(p.places + 2 + smid % SM_SLOTS, 1u) == 0;
    sm.place = first ? (int)atomicAdd(p.places, 1u) : -1 - (int)atomicAdd(p.places + 1, 1u);
  }
  for (int it = -1; it < p.n_iters; ++it) {
    if (it >= 0) {
      grid_sync(p.barrier, (unsigned)(it + 1) * gridDim.x);
      if (threadIdx.x == 0) {
        sm.count = (int)ld_acquire((const unsigned*)(p.counts + it));
        // every CTA has counted itself before the first barrier
        if (sm.place < 0) sm.place = (int)ld_acquire(p.places) - 1 - sm.place;
      }
      __syncthreads();
      m = sm.count;
      __syncthreads();
      if (m == 0) break;   // the same m in every CTA: the grid leaves together
    }
    march_iteration(sm, p, m, it < 0 ? (int)blockIdx.x : sm.place,
                    it < 0 ? nullptr : p.lists + (size_t)(it & 1) * p.n,
                    p.lists + (size_t)((it + 1) & 1) * p.n, p.counts + it + 1);
  }
}

}  // namespace

extern "C" {

const char* iron_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The CTAs of K2 the card holds at once (one an SM); -1 on error.
int iron_sdf_only_bf16_ctas() {
  const int smem = (int)sizeof(k2::Smem) + 1024;   // and the ring's alignment
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(sdf_only_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sdf_only_bf16_kernel, k2::THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// wg: n_ktiles swizzled k-tiles of 16 x 256 bf16 (kernels/fused_sdf.py::
// pack_wgmma_b); ctas: the persistent grid (kernels/fused_sdf.py::k2_tiling).
int iron_sdf_only_bf16(const float* x, int n, const void* wg, int n_ktiles, const float* bias,
                       const void* wlast, int n_layers, int skip, int d_embed, float scale,
                       float* out, int ctas, void* stream) {
  if (n <= 0) return 0;
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(k2::Smem) + 1024;   // and the ring's alignment
  cudaError_t e = cudaFuncSetAttribute(sdf_only_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sdf_only_bf16_kernel<<<ctas, k2::THREADS, smem, (cudaStream_t)stream>>>(
      x, n, (const unsigned char*)wg, n_ktiles, bias, (const __nv_bfloat16*)wlast, n_layers,
      skip, d_embed, scale, 1.0f / scale, out);
  return (int)cudaGetLastError();
}

// 1 when the card can launch a cooperative grid (K1's launch), 0 when it
// cannot, -1 on error.
int iron_cooperative_launch() {
  int dev = 0, coop = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess)
    return -1;
  return coop ? 1 : 0;
}

// The ints of K1's counts past the list lengths and the barrier's count.
int iron_coarse_march_places() { return 2 + k1::SM_SLOTS; }

// The CTAs of K1 that the card holds at once; -1 on error.
int iron_coarse_march_ctas() {
  const int smem = (int)sizeof(k1::Smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(coarse_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coarse_march_kernel, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// ctas: the persistent grid, at most iron_coarse_march_ctas() (a larger grid
// returns cudaErrorCooperativeLaunchTooLarge).  lists: 2 n ints; counts:
// n_iters + 2 + iron_coarse_march_places() ints, zero (the list lengths, the
// grid barrier's count, the counts of the CTAs' places).
int iron_coarse_march_bf16(const float* ray_o, const float* ray_d, const float* acc0,
                           const void* work, const float* max_dis, int n, int n_iters,
                           float threshold, const void* wpack, int n_ktiles, const float* bias,
                           const void* wlast, int n_layers, int skip, int d_embed,
                           float scale, float* acc_out, float* sdf_out, void* act_out,
                           int* lists, int* counts, int ctas, void* stream) {
  if (n <= 0) return 0;
  if (ctas < 1 || n_iters < 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(k1::Smem);
  cudaError_t e = cudaFuncSetAttribute(coarse_march_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const k1::Args p = {ray_o, ray_d, acc0, (const uint8_t*)work, max_dis, n, n_iters, threshold,
                      (const uint2*)wpack, n_ktiles, bias, (const __nv_bfloat16*)wlast,
                      n_layers, skip, d_embed, scale, 1.0f / scale, acc_out, sdf_out,
                      (uint8_t*)act_out, lists, counts, (unsigned*)(counts + n_iters + 1),
                      (unsigned*)(counts + n_iters + 2)};
  // A cooperative launch: every CTA is resident at once, or the launch
  // fails (cudaErrorCooperativeLaunchTooLarge) and nothing runs.
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, coarse_march_kernel, p);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no error for the next one to report
    return (int)e;
  }
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
