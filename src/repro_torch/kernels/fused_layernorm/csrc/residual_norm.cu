// The decode residual stream's fused add + norm for Hopper (sm_90a):
// (y, x) -> (h = norm(x + y) * scale [+ bias], x2 = x + y), rows [R, D].
//
// Replaces the TPU kernel src/repro/kernels/fused_layernorm/kernel.py:85
// decode_residual_norm (pallas_call at :113). The plain version is
// repro_torch/kernels/fused_layernorm/ref.py: the add in the model dtype,
// then the port's apply_norm (models/layers.py) verbatim.
//
// What bounds it on this card: bytes. It reads y and x and writes h and x2
// once, plus the [D] scale: at the decode shape [8, 3072] bf16 that is
// 0.2 MB, 0.06 us at 3.35 TB/s; at a 64-row prefill chunk 1.6 MB, 0.5 us.
// Either way one launch costs more than the bytes, so the kernel is
// launch-latency bound. What its design does about it: one launch replaces
// the eager add + norm sequence (about ten launches) at each ln2 site.
//
// Design: one CTA of 256 threads per row. The row's x2 is kept in shared
// memory as fp32 (12 KB at D = 3072), so the row is read once. It takes
// bf16, the model dtype of the served configs. Numerics:
//   - x2 = round(float(x) + float(y)) to bf16: one rounding of
//     the fp32 sum, as PyTorch's elementwise add computes it, so x2 is
//     bitwise equal to the plain version;
//   - the fp32 statistics follow this kernel's own fixed order (each thread
//     sums its strided elements in order, a butterfly inside each warp,
//     then one thread adds the warp sums in warp order), and mean = sum *
//     (1 / D), var + eps, rsqrtf, then (v * r) * scale [+ bias] with no
//     fused multiply-adds. torch.mean on the card reduces in another order,
//     so h may differ from the plain version by an ulp of the model dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Fixed-order block sum: a butterfly in each warp (every lane ends with the
// same bits, since a + b == b + a), then thread 0 adds the warp sums in order.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w]);
    red[kWarps] = s;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

using bf16 = __nv_bfloat16;

template <bool kLayerNorm>
__global__ void __launch_bounds__(kThreads)
resnorm_kernel(const bf16* __restrict__ y, const bf16* __restrict__ x,
               const bf16* __restrict__ scale, const bf16* __restrict__ bias,
               bf16* __restrict__ h, bf16* __restrict__ xo, int d, float eps) {
  extern __shared__ float row[];             // x2 in fp32, [d]
  __shared__ float red[kWarps + 1];
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  const float inv_d = 1.0f / static_cast<float>(d);

  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const bf16 s = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(x[off + i]), __bfloat162float(y[off + i])));
    xo[off + i] = s;
    const float v = __bfloat162float(s);
    row[i] = v;
    acc = kLayerNorm ? __fadd_rn(acc, v) : __fadd_rn(acc, __fmul_rn(v, v));
  }
  float mu = 0.f, var;
  if (kLayerNorm) {
    mu = __fmul_rn(block_sum(acc, red), inv_d);
    acc = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float c = __fsub_rn(row[i], mu);
      acc = __fadd_rn(acc, __fmul_rn(c, c));
    }
  }
  var = __fmul_rn(block_sum(acc, red), inv_d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = kLayerNorm ? __fsub_rn(row[i], mu) : row[i];
    float o = __fmul_rn(__fmul_rn(c, r), __bfloat162float(scale[i]));
    if (bias != nullptr) o = __fadd_rn(o, __bfloat162float(bias[i]));
    h[off + i] = __float2bfloat16_rn(o);
  }
}

}  // namespace

// y, x, h, xo bf16 [rows, d]; scale and bias bf16 [d]; bias may be null.
extern "C" int decode_residual_norm(const void* y, const void* x,
                                    const void* scale, const void* bias,
                                    void* h, void* xo, int rows, int d,
                                    int layernorm, float eps, void* stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kern = layernorm ? resnorm_kernel<true> : resnorm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(x),
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(h), static_cast<bf16*>(xo), d, eps);
  return static_cast<int>(cudaGetLastError());
}
