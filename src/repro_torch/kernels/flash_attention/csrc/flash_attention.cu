// Flash-attention forward for Hopper (sm_90a): online-softmax GQA attention
// with causal, sliding-window and per-batch valid-length masks, any query
// and key length.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:64
// flash_attention_fwd (pallas_call at :87). The plain version is
// repro_torch/kernels/flash_attention/ref.py flash_attention_fwd.
//
// What bounds it on this card: operations. The static prefill's shape
// (q [4, 4096, 24, 128], k/v [4, 4096, 8, 128] bf16, causal) moves 268 MB
// (0.080 ms at 3.35 TB/s) but does 4 * B * Hq * D * S(S+1)/2 = 4.1e11
// flop: 0.42 ms on the bf16 tensor cores. Scores never touch device
// memory: HBM traffic is O(S * D) per head instead of the O(S^2) of a
// materialized softmax.
//
// Design (tensor cores through mma.sync; wgmma, TMA and warp
// specialization are later work): one CTA of 4 warps per (64-query tile,
// batch * query head), the heaviest causal tiles launched first; each warp
// owns 16 query rows. The Q tile is read once into registers as bf16 mma
// fragments. K/V tiles of 64 keys of the CTA's KV head (head h / (Hq /
// Hkv): no repeat of K/V) stream through a two-stage cp.async ring in
// shared memory, the next tile in flight during the current one's math.
// S = Q K^T is an m16n8k16 bf16 product accumulated in fp32 (exact
// products of the bf16 inputs), scaled by D^-0.5 in fp32. The running max
// m, sum l and output o stay in fp32 registers. p V accumulates in fp32:
// p is split into bf16 hi + lo parts (p - hi rounded again), two mma's,
// so p carries 16 significant bits instead of bf16's 8 (the chunked path
// rounds p to bf16; this kernel holds an fp32 plain version within a
// fraction of a bf16 ulp). The output is written once, in bf16. Masked
// scores are -1e30 (finite, as in the Pallas kernel), keys past Sk -inf,
// so a row with no valid key returns the mean of V over all keys, as the
// plain version does. KV tiles wholly outside every row's causal / window
// band or past kv_len are skipped (they add exactly 0 once a row has a
// valid key); a CTA holding a row with no valid key visits every tile, to
// keep that row's mean. Inputs are read in the model layout [B, S, H, D]
// through element strides (D contiguous), so v may be a column view of
// the fused QKV projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;              // query rows per CTA (16 per warp)
constexpr int BK = 64;              // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;             // bf16 of row padding (bank spread)
constexpr float kNegInf = -1e30f;   // masked score, as the Pallas kernel
constexpr int kMaxDevices = 16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* kv_len;
  bf16* out;
  int hq, hkv, sq, sk, q_offset, window, causal;
  long long q_sb, q_ss, q_sh;       // element strides of q [B, Sq, Hq, D]
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
};

template <int D>
struct Smem {
  static constexpr int kRow = D + kPad;             // bf16 a smem row
  static constexpr int kTile = BK * kRow;           // one K or V tile
  static constexpr int kBytes = (BQ * kRow + 4 * kTile) * 2;  // Q, 2 x K/V
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 hi part of (x, y) and the bf16 rounding of what it leaves
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int kRow = Smem<D>::kRow;
  constexpr int kVec = D / 8;                       // 16-byte vectors a row
  constexpr int kKSteps = D / 16;                   // k16 steps over D
  constexpr int kDTiles = D / 8;                    // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);     // [BQ][kRow]
  bf16* kvs = qs + BQ * kRow;                       // [2][K, V][BK][kRow]
  __shared__ int range_lo, range_hi, any_empty;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int q0 = qt * BQ;
  const int bh = blockIdx.y, b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int kvl = min(max(p.kv_len[b], 0), p.sk);

  // the key range [lo, hi) of each row; rows are visited by thread = row
  if (tid == 0) {
    range_lo = p.sk;
    range_hi = 0;
    any_empty = 0;
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < p.sq) {
    const int pos = q0 + tid + p.q_offset;
    const int hi = p.causal ? min(kvl, pos + 1) : kvl;
    const int lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
    if (lo >= hi) {
      any_empty = 1;
    } else {
      atomicMin(&range_lo, lo);
      atomicMax(&range_hi, hi);
    }
  }

  // the Q tile (rows past Sq zero-filled)
  for (int e = tid; e < BQ * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    const bool ok = q0 + r < p.sq;
    cp_async16(qs + r * kRow + c,
               ok ? p.q + b * p.q_sb + (q0 + r) * p.q_ss + h * p.q_sh + c
                  : p.q,
               ok);
  }
  cp_async_commit();
  __syncthreads();
  int t_begin, t_end;
  if (any_empty) {
    t_begin = 0;
    t_end = (p.sk + BK - 1) / BK;
  } else {
    t_begin = range_lo / BK;
    t_end = (range_hi + BK - 1) / BK;
  }

  const bf16* kbase = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + hk * p.v_sh;
  auto fetch = [&](int t, int stage) {
    bf16* ks = kvs + stage * 2 * Smem<D>::kTile;
    bf16* vs = ks + Smem<D>::kTile;
    for (int e = tid; e < BK * kVec; e += kThreads) {
      const int r = e / kVec, c = (e % kVec) * 8;
      const int col = t * BK + r;
      const bool ok = col < p.sk;
      cp_async16(ks + r * kRow + c, ok ? kbase + col * p.k_ss + c : kbase,
                 ok);
      cp_async16(vs + r * kRow + c, ok ? vbase + col * p.v_ss + c : vbase,
                 ok);
    }
  };
  if (t_begin < t_end) fetch(t_begin, 0);
  cp_async_commit();

  // this warp's 16 query rows as bf16 A fragments, once
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kKSteps][4];
  {
    const bf16* base = qs + (warp * 16 + (lane & 15)) * kRow + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(qf[kk], base + kk * 16);
  }

  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g + p.q_offset;  // rows g and g + 8

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) fetch(t + 1, stage ^ 1);     // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();                             // tile t has landed
    __syncthreads();
    const bf16* ks = kvs + stage * 2 * Smem<D>::kTile;
    const bf16* vs = ks + Smem<D>::kTile;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      // keys 8n..8n+7; matrices: d [16kk, +8), [16kk+8, +8), then kk+1
      const bf16* kb = ks + (n * 8 + (lane & 7)) * kRow + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < kKSteps; kk += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, kb + kk * 16);
        mma_bf16(s[n], qf[kk], r[0], r[1]);
        mma_bf16(s[n], qf[kk + 1], r[2], r[3]);
      }
    }

    // scale, masks, online softmax; a row's 64 keys live in the 4 lanes
    // of one quad
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int pos = row0 + 8 * hr;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = t * BK + n * 8 + 2 * t4 + j;
          bool ok = col < kvl;
          if (p.causal) ok = ok && col <= pos;
          if (p.window > 0) ok = ok && col > pos - p.window;
          float& x = s[n][2 * hr + j];
          x = col >= p.sk ? -INFINITY : (ok ? x * p.scale : kNegInf);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      alpha[hr] = expf(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[n][2 * hr + j];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha[hr] + sum;
      m[hr] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p V over 4 k16 steps of keys; p's fragments are the score
    // accumulators of n-tiles 2kk and 2kk + 1, split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      // V rows (keys) 16kk + [0, 16), transposed: two n-tiles of d a load
      const bf16* vb = vs + (kk * 16 + (lane & 15)) * kRow + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < kDTiles; n += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vb + n * 8);
        mma_bf16(o[n], ph, r[0], r[1]);
        mma_bf16(o[n], pl, r[0], r[1]);
        mma_bf16(o[n + 1], ph, r[2], r[3]);
        mma_bf16(o[n + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();                  // stage free for the tile after next
  }
  cp_async_wait<0>();

  // o / l, rounded to bf16 once; out is contiguous [B, Sq, Hq, D]
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + warp * 16 + g + 8 * hr;
    if (r >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[hr], 1e-30f);
    bf16* dst = p.out + ((static_cast<long long>(b) * p.sq + r) * p.hq + h)
                * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
}

template <int D>
int launch(const Params& p, int b, void* stream) {
  static bool smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 grid((p.sq + BQ - 1) / BQ, b * p.hq);
  flash_fwd_kernel<D><<<grid, kThreads, Smem<D>::kBytes,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, Hq, D], k / v [B, Sk, Hkv, D] bf16 with element strides (batch,
// sequence, head; D contiguous, strides multiples of 8, 16-byte aligned
// bases), kv_len [B] int32, out contiguous [B, Sq, Hq, D] bf16. D is 64 or
// 128; Hq a multiple of Hkv.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int b, int hq, int hkv, int sq, int sk, int d, int q_offset,
    int window, int causal, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
    int k_sh, int v_sb, int v_ss, int v_sh, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv || b <= 0 || sq <= 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const int*>(kv_len),
           static_cast<bf16*>(out), hq, hkv, sq, sk, q_offset, window,
           causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           scale};
  if (d == 128) return launch<128>(p, b, stream);
  if (d == 64) return launch<64>(p, b, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
