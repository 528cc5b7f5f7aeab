// Thin wrappers over the Hopper (sm_90a) instructions that the clustered
// tensor-core kernels use: warp-level mma.sync (bf16 m16n8k16 and tf32
// m16n8k8), ldmatrix, and thread block clusters with distributed shared
// memory.  Kept apart from the arithmetic so that each kernel reads as a
// sequence of named steps.
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

}  // namespace iron
