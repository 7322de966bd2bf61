// Fused scale + causal mask + softmax over score rows for Hopper (sm_90a):
// s [N, Sq, Sk] -> y = softmax(scale * s + causal mask) over the last axis,
// fp32 statistics, y in s's dtype (fp32 or bf16).
//
// Replaces the TPU kernel src/repro/kernels/fused_softmax/kernel.py:33
// scale_mask_softmax (pallas_call at :40). The plain version is
// repro_torch/kernels/fused_softmax/ref.py scale_mask_softmax, the JAX
// reference's operations in their order.
//
// What bounds it on this card: bytes. It reads s once and writes y once and
// does about six operations an element (scale, max, subtract, exp, add,
// divide): at bert-large's Phase 2 scores [64, 512, 512] fp32 that is
// 134 MB, 40 us at 3.35 TB/s, against 0.1 GFLOP, 1.5 us at 67 TFLOP/s fp32.
// What its design does about it: the TPU kernel keeps a 128-row tile in
// VMEM; here one CTA takes one row and keeps it in shared memory as fp32
// x = scale * s (masked), so s is read from device memory once and y is
// written once, the paper's separate scale, mask and softmax kernels (Fig. 8)
// in one pass. Unlike the TPU kernel, which asserts whole 128-row tiles, it
// takes any Sq; Sk is bounded by the shared memory a CTA may hold
// (kMaxSk fp32 values).
//
// Numerics follow the plain version operation by operation: x = s * scale
// with __fmul_rn, masked entries the finite -1e30 (a row with no valid
// column comes out uniform, 1 / Sk), p = expf(x - m) with __fsub_rn and
// expf (not __expf: PyTorch's CUDA exp is expf), y = p / sum with IEEE
// division, rounded once to bf16 where s is bf16. Only the order of the sum
// differs from PyTorch's: each thread adds its columns in order, a butterfly
// in each warp, then one thread adds the warp sums in warp order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSk = 32768;        // 128 KB of fp32 row in shared memory
                                     // (ops.MAX_SK)
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Block max: order does not matter for a max.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < warps; ++w) m = fmaxf(m, red[w]);
    red[kMaxWarps] = m;
  }
  __syncthreads();
  const float m = red[kMaxWarps];
  __syncthreads();                     // red is reused by block_sum
  return m;
}

// Fixed-order block sum: a butterfly in each warp (every lane ends with the
// same bits), then thread 0 adds the warp sums in order.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s = __fadd_rn(s, red[w]);
    red[kMaxWarps] = s;
  }
  __syncthreads();
  return red[kMaxWarps];
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
softmax_row_kernel(const T* __restrict__ s, T* __restrict__ y, int sq, int sk,
                   int q_offset, int causal, float scale) {
  extern __shared__ float xrow[];              // [sk] fp32
  __shared__ float red[kMaxWarps + 1];
  const size_t row = blockIdx.x;
  const T* src = s + row * static_cast<size_t>(sk);
  T* dst = y + row * static_cast<size_t>(sk);
  // columns past `last` are masked (causal: col > row-in-Sq + q_offset)
  const long long last = causal
      ? static_cast<long long>(row % static_cast<size_t>(sq)) + q_offset
      : static_cast<long long>(sk);

  float m = kNegInf;
  for (int c = threadIdx.x; c < sk; c += blockDim.x) {
    const float x = c <= last ? __fmul_rn(to_float(src[c]), scale) : kNegInf;
    xrow[c] = x;
    m = fmaxf(m, x);
  }
  m = block_max(m, red);

  float acc = 0.f;
  for (int c = threadIdx.x; c < sk; c += blockDim.x) {
    const float p = expf(__fsub_rn(xrow[c], m));
    xrow[c] = p;
    acc = __fadd_rn(acc, p);
  }
  const float total = block_sum(acc, red);

  for (int c = threadIdx.x; c < sk; c += blockDim.x)
    store(dst + c, __fdiv_rn(xrow[c], total));
}

template <typename T>
int launch(const void* s, void* y, int rows, int sq, int sk, int q_offset,
           int causal, float scale, cudaStream_t stream) {
  const int smem = sk * static_cast<int>(sizeof(float));
  // The 48 KB a CTA may hold without an opt-in covers the static `red` as
  // well as the dynamic row, so the row alone does not decide it: the limit
  // is raised once per device to kMaxSk's row, whatever this launch's Sk.
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(softmax_row_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSk * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  // 128 threads for short rows (more CTAs resident on an SM), 256 above
  const int threads = sk <= 1024 ? 128 : kMaxThreads;
  softmax_row_kernel<T><<<rows, threads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(y), sq, sk, q_offset, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s, y contiguous [rows = N * Sq, sk], fp32 (is_bf16 = 0) or bf16; row r is
// query row r % sq, at position (r % sq) + q_offset; 1 <= sk <= kMaxSk.
extern "C" int scale_mask_softmax(const void* s, void* y, int rows, int sq,
                                  int sk, int q_offset, int causal,
                                  int is_bf16, float scale, void* stream) {
  if (sk < 1 || sk > kMaxSk || sq < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(s, y, rows, sq, sk, q_offset, causal, scale, st);
  return launch<float>(s, y, rows, sq, sk, q_offset, causal, scale, st);
}
