// Device code shared by the decode-shaped norm kernels (residual_norm.cu,
// gated_rmsnorm.cu): 16-byte row vectors and the fixed-order sums of a row.
//
// A row's sum has one order, the same in every thread that asks for it:
//   1. each thread adds its own terms in the order it was given them;
//   2. a butterfly inside each warp (every lane ends with the same bits,
//      since a + b == b + a);
//   3. lane 0 of each warp writes the warp's sum, one __syncthreads, and
//      every warp adds the warp sums itself in warp order, starting from
//      warp 0's (no second barrier, no broadcast slot);
//   4. in a thread block cluster, each CTA's sum is written into every
//      CTA's shared memory (distributed shared memory), one cluster barrier,
//      and every thread adds the CTAs' sums in rank order.
// Every add is __fadd_rn: no contraction into fused multiply-adds.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rownorm {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kLane = 8;            // bf16 values in one 16-byte vector
constexpr int kMaxThreads = 512;    // the register path's largest CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCtas = 8;         // CTAs a row (a cluster): 1, 2, 4, 8

// Where a CTA sits: its row (its cluster's index along x), its rank in the
// row and the row's CTAs (a launch without clusters is clusters of one),
// from special registers: no division by a run-time cluster size before
// the loads.
struct RowPos {
  int row, rank, ctas;
};

__device__ __forceinline__ RowPos row_pos() {
  RowPos p;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(p.row));
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(p.rank));
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(p.ctas));
  return p;
}

// v[j] = p[first + j * stride] for j < V, all loads issued before any use.
template <int V>
__device__ __forceinline__ void load(uint4 (&v)[V], const uint4* p,
                                     int first, int stride) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = p[first + j * stride];
}

__device__ __forceinline__ float to_float(const uint4& v, int e) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&v)[e]);
}

__device__ __forceinline__ void set_bf16(uint4& v, int e, float f) {
  reinterpret_cast<bf16*>(&v)[e] = __float2bfloat16_rn(f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Steps 2-3 for a CTA of at most kWarps warps. `red` holds kWarps floats,
// 16-byte aligned, and serves one sum only: a kernel that sums twice gives
// each sum its own `red`, so no barrier guards its reuse.
template <int kWarps>
__device__ __forceinline__ float cta_sum(float v, float* red) {
  static_assert(kWarps % 4 == 0, "red is read as float4");
  v = warp_sum(v);
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float w[kWarps];
#pragma unroll
  for (int i = 0; i < kWarps / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(red)[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
  float s = w[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i)
    if (i < warps) s = __fadd_rn(s, w[i]);
  return s;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The start of a row of `ctas` CTAs: every thread arrives (no ordering) on
// the barrier that row_sum's first call waits on before it writes into a
// peer's shared memory, so that every CTA of the cluster has started.
// Called once, right after the row's loads are issued.
__device__ __forceinline__ void cluster_start(int ctas) {
  if (ctas > 1) cluster_arrive_relaxed();
}

// Steps 2-4: the row's sum over `ctas` CTAs (a cluster along x, or one CTA
// when ctas == 1). Thread r < ctas writes its CTA's sum into slots[rank] of
// CTA r (distributed shared memory), one cluster barrier, and every thread
// adds its own CTA's slots[0 .. ctas) in rank order. `slots` is kMaxCtas
// floats of this CTA's shared memory and, like `red`, serves one sum. No CTA
// touches another's shared memory after its last sum, so a CTA may exit as
// soon as it is done. `first`: this is the kernel's first row_sum, which
// waits on cluster_start's barrier. Global stores issued before a cluster
// sum would delay its barrier (its arrive orders them); the kernels store
// after their sums.
template <int kWarps>
__device__ __forceinline__ float row_sum(float v, float* red, float* slots,
                                         int ctas, bool first) {
  const float s = cta_sum<kWarps>(v, red);
  if (ctas == 1) return s;
  cg::cluster_group cluster = cg::this_cluster();
  if (first) cluster_wait();
  if (threadIdx.x < ctas)
    *cluster.map_shared_rank(slots + cluster.block_rank(), threadIdx.x) = s;
  cluster_arrive();
  cluster_wait();
  float t = slots[0];
#pragma unroll
  for (int r = 1; r < kMaxCtas; ++r)
    if (r < ctas) t = __fadd_rn(t, slots[r]);
  return t;
}

// A launch of rows * ctas CTAs of `threads`, a cluster of `ctas` along x
// when ctas > 1; `attr` is the cluster attribute's storage.
inline cudaLaunchConfig_t launch_config(int rows, int ctas, int threads,
                                        size_t smem, void* stream,
                                        cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  return cfg;
}

// Whether (threads, vecs, ctas) is a register-path plan that covers a row
// of d values exactly (ops.norm_plan makes them); vecs must also be one of
// the kernel's instantiations, which the caller checks.
inline bool plan_ok(int d, int threads, int vecs, int ctas) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         vecs >= 1 && ctas >= 1 && ctas <= kMaxCtas &&
         (ctas & (ctas - 1)) == 0 &&
         static_cast<long long>(threads) * vecs * ctas * kLane == d;
}

}  // namespace rownorm
