// Thin wrappers over the Hopper (sm_90a) instructions that the tensor-core
// kernels use: warp-level mma.sync (bf16 m16n8k16 and tf32 m16n8k8),
// ldmatrix, thread block clusters with distributed shared memory, the
// barrier of a persistent grid, and K2's warpgroup products (wgmma) on a
// ring of bulk copies (TMA) completed on mbarriers.  Kept apart from the
// arithmetic so that each kernel reads as a sequence of named steps.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace iron {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a b, m16n8k16, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, tf32 operands (f32 bit patterns whose low 13 bits are
// zero), f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives, in r[j], row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ---- thread block clusters ----

__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}

// The address of *p in the shared memory of block `rank` of this cluster.
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// Copy rows [0, rows) x bytes [0, width) of the block at p (row stride
// `stride` bytes; p, stride and width multiples of 16) from this block's
// shared memory to the same addresses in the other ncta - 1 blocks of the
// cluster, 16 bytes a thread and step: written locally first, a block is
// spread in wide stores (a remote store costs about the same whatever its
// width).  The caller orders the writes of the block before it (a block
// barrier) and the remote readers after it (a cluster barrier).
__device__ __forceinline__ void cluster_spread(void* p, int stride, int rows, int width,
                                               int ncta) {
  const int chunks = width / 16, per_cta = rows * chunks;
  const int me = cluster_rank();
  for (int i = threadIdx.x; i < (ncta - 1) * per_cta; i += blockDim.x) {
    const int q = (me + 1 + i / per_cta) % ncta;
    char* src = static_cast<char*>(p) + ((i % per_cta) / chunks) * stride + 16 * (i % chunks);
    *reinterpret_cast<uint4*>(cluster_map(src, q)) = *reinterpret_cast<const uint4*>(src);
  }
}

// Every thread of every block of the cluster arrives and waits; orders the
// shared memory accesses (local and remote) before it with those after it.
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// ---- grid-wide barrier of a persistent grid ----

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives and waits: the k-th barrier of a launch
// waits until *count (zero at launch) reaches k * gridDim.x.  Only a grid
// whose blocks are all resident at once may use it: a cooperative launch,
// which fails rather than run a grid the card cannot hold.  A wait of more
// than 2^35 clock cycles traps, so that a fault ends the launch with an
// error and does not hang the card.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long t0 = clock64();
    while (ld_acquire(count) < target) {
      if (clock64() - t0 > (1ll << 35)) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
}

// ---- warpgroup products, mbarriers and bulk copies (K2) ----

// Every thread of the `count` threads that use named barrier `id` (1-15;
// 0 is __syncthreads) arrives and waits.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive at named barrier `id` without waiting (the other threads of its
// `count` wait there with named_sync).
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the other threads of the
// cluster and to the asynchronous proxy (bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on a barrier of this CTA and add `bytes` to the transfers its
// phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait of more than 2^33 clock cycles traps, so that a fault ends the launch
// with an error and does not hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// One bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from device memory into this CTA's shared
// memory, completed on the barrier `bar` of this CTA.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The shared-memory descriptor of a wgmma B operand: a 16 x 256 bf16 k-tile
// stored K-major (each of the 256 columns' 16 values in 32 bytes) in the
// 32-byte swizzle: 8-column atoms of 256 bytes one after another (stride
// 256 bytes), and in each atom the two 16-byte halves of columns 4-7
// swapped (address bit 4 ^= bit 7).  The k-tile starts 256-byte aligned.
__device__ __forceinline__ uint64_t wgmma_desc_k16_sw32(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)   // LBO (unused)
         | ((uint64_t)(256 >> 4) << 32)                                  // SBO: 256 bytes
         | ((uint64_t)3 << 62);                                          // 32-byte swizzle
}

// Give registers back (producer) or take them (consumers) at warpgroup
// granularity: a thread's registers become N (a multiple of 8, 24 to 256).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Orders this thread's register accesses before the warpgroup's next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Tells the compiler that v is read and written here: keeps the registers
// of an asynchronous wgmma's operands out of its reordering and reuse.
__device__ __forceinline__ void reg_fence(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// d (+)= a b for a 64 x 256 tile of the warpgroup: a the 64 x 16 bf16 A
// operand in registers (each warp's 16 rows in the m16n8k16 A fragment
// order), b a 16 x 256 bf16 k-tile in shared memory (desc_b), d f32 in the
// accumulator order (n-tile j of 8 columns in d[4 j .. 4 j + 3], as mma.sync's
// C fragment).  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace iron
