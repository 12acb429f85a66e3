// Banked KV-cache flash decode (one GQA decode step) for Hopper.
//
// Replaces: src/repro/kernels/banked_kv_decode.py, banked_kv_decode (block
// body _decode_block), the Pallas kernel behind repro.kernels.ops.kv_decode.
//
// What it computes.  q [B, Hq, D]; k, v [B, Hkv, NB, SB, D] (the cache
// [B, Hkv, S, D] cut into NB sequence banks of SB positions); lengths [B].
// For every query head, an f32 online-softmax recurrence over the banks
// in order with scale 1/sqrt(D): positions >= lengths[b] get score -1e30
// and weight 0, and the output is acc / max(l, 1e-30) cast to q's type,
// so a row of length 0 decodes to exact zeros.
//
// What bounds it on this card.  Bytes: a decode step reads every valid
// K and V row once (sum_b lengths[b] * Hkv * D * 2 * itemsize) and does
// 4 flops per element read, far below the ~295 flop/byte at which the
// tensor cores, rather than the 3.35 TB/s of HBM, would be the limit.
//
// Design.  One CTA per (batch row, kv head) serves all Hq / Hkv query
// heads of that kv head, so K and V are read once per group, as the
// Pallas head block does.  The CTA walks the banks in order, in tiles of
// 128 positions, and stops at the row's length: a bank that starts at or
// past lengths[b] leaves the JAX recurrence unchanged bit for bit
// (p = 0, alpha = 1), so skipping it changes no result and cuts the bytes
// to the valid prefix.  Per tile: each thread scores one position against
// the whole group with 16-byte K loads (f32 FMAs on CUDA cores: TF32
// tensor cores cannot meet the reference's 1e-5); one warp per query head
// folds the tile into the running max and sum; each thread then owns
// D / 128 output dims and accumulates p @ V with coalesced V row loads.
// The cast to bf16 is __float2bfloat16 (round to nearest even, as JAX
// casts).  Split-bank flash-decoding and TMA/wgmma are left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // one CTA per (batch row, kv head)
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // positions per step, one per thread
constexpr int kMaxGroup = 16;    // query heads per kv head
constexpr int kMaxDim = 256;
constexpr int kDimSlots = kMaxDim / kThreads;  // output dims per thread

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of K as floats: 4 f32 or 8 bf16.
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f = __bfloat1622float2(h[c]);
    x[2 * c] = f.x;
    x[2 * c + 1] = f.y;
  }
}

template <typename T, bool kVecLoads>
__global__ void __launch_bounds__(kThreads)
kv_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ lengths,
                 T* __restrict__ out, int hkv, int group, int n_banks,
                 int64_t bank_len, int dim, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [group, dim]
  float* p_s = q_s + group * dim;    // [group, kTile] scores, then weights
  float* m_s = p_s + group * kTile;  // [group] running max
  float* l_s = m_s + group;          // [group] running weight sum
  float* a_s = l_s + group;          // [group] this tile's rescale

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x - b * hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t seq = static_cast<int64_t>(n_banks) * bank_len;
  const int64_t len = min64(lengths[b] < 0 ? 0 : lengths[b], seq);

  const int64_t head0 = (static_cast<int64_t>(b) * hkv + h) * group;
  const T* qb = q + head0 * dim;
  for (int e = tid; e < group * dim; e += kThreads) q_s[e] = to_f32(qb[e]);
  if (tid < group) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  const int64_t base = (static_cast<int64_t>(b) * hkv + h) * seq * dim;
  const T* kb = k + base;
  const T* vb = v + base;

  float acc[kMaxGroup][kDimSlots];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int c = 0; c < kDimSlots; ++c) acc[g][c] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < n_banks; ++j) {
    const int64_t start = j * bank_len;
    if (start >= len) break;  // this bank and all later ones are empty
    const int64_t stop = min64(start + bank_len, len);
    for (int64_t t0 = start; t0 < stop; t0 += kTile) {
      const int nt = static_cast<int>(min64(kTile, stop - t0));
      // 1. scores of position t0 + tid against every head of the group
      if (tid < nt) {
        const T* krow = kb + (t0 + tid) * dim;
        float s[kMaxGroup];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
        if constexpr (kVecLoads) {
          constexpr int kVec = 16 / sizeof(T);
#pragma unroll 4
          for (int d0 = 0; d0 < dim; d0 += kVec) {
            const uint4 u = *reinterpret_cast<const uint4*>(krow + d0);
            float x[kVec];
            unpack(u, x);
#pragma unroll
            for (int g = 0; g < kMaxGroup; ++g) {
              if (g < group) {
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                  s[g] = fmaf(q_s[g * dim + d0 + e], x[e], s[g]);
              }
            }
          }
        } else {
          for (int d = 0; d < dim; ++d) {
            const float x = to_f32(krow[d]);
#pragma unroll
            for (int g = 0; g < kMaxGroup; ++g) {
              if (g < group) s[g] = fmaf(q_s[g * dim + d], x, s[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) p_s[g * kTile + tid] = s[g] * scale;
        }
      }
      __syncthreads();
      // 2. fold the tile into the running max and sum, a warp per head
      for (int g = warp; g < group; g += kWarps) {
        float* pg = p_s + g * kTile;
        float mx = -1e30f;
        for (int i = lane; i < nt; i += 32) mx = fmaxf(mx, pg[i]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int i = lane; i < nt; i += 32) {
          const float p = expf(pg[i] - m_new);
          pg[i] = p;
          sum += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      // 3. acc = acc * alpha + p @ V over the tile
#pragma unroll
      for (int c = 0; c < kDimSlots; ++c) {
        const int d = tid + c * kThreads;
        if (d < dim) {
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < group) acc[g][c] *= a_s[g];
          }
          const T* vcol = vb + t0 * dim + d;
#pragma unroll 4
          for (int i = 0; i < nt; ++i) {
            const float x = to_f32(vcol[static_cast<int64_t>(i) * dim]);
#pragma unroll
            for (int g = 0; g < kMaxGroup; ++g) {
              if (g < group)
                acc[g][c] = fmaf(p_s[g * kTile + i], x, acc[g][c]);
            }
          }
        }
      }
      __syncthreads();  // p_s and a_s are rewritten by the next tile
    }
  }

  T* ob = out + head0 * dim;
#pragma unroll
  for (int c = 0; c < kDimSlots; ++c) {
    const int d = tid + c * kThreads;
    if (d < dim) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group)
          store_f32(ob + g * dim + d, acc[g][c] / fmaxf(l_s[g], 1e-30f));
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, long long batch, int hkv, int group, int n_banks,
           long long bank_len, int dim, float scale, int vec,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(group) * dim +
                       static_cast<size_t>(group) * kTile + 3 * group);
  const unsigned grid = static_cast<unsigned>(batch * hkv);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int32_t* lp = static_cast<const int32_t*>(lengths);
  T* op = static_cast<T*>(out);
  if (vec) {
    kv_decode_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        qp, kp, vp, lp, op, hkv, group, n_banks, bank_len, dim, scale);
  } else {
    kv_decode_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        qp, kp, vp, lp, op, hkv, group, n_banks, bank_len, dim, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [batch, hkv * group, dim]; k, v: [batch, hkv, n_banks * bank_len, dim];
// lengths: [batch] int32; out like q.  dtype 0 = float32, 1 = bfloat16.
// vec = 1 when dim * itemsize is a multiple of 16 and k is 16-byte
// aligned.  Needs group <= kv_decode_max_group() and dim <=
// kv_decode_max_dim(); otherwise returns cudaErrorInvalidValue.  Returns
// cudaGetLastError().
int kv_decode_launch(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, long long batch, int hkv,
                     int group, int n_banks, long long bank_len, int dim,
                     float scale, int dtype, int vec, void* stream) {
  if (batch == 0 || hkv == 0) return 0;
  if (group < 1 || group > kMaxGroup || dim < 1 || dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, lengths, out, batch, hkv, group, n_banks,
                           bank_len, dim, scale, vec, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, lengths, out, batch, hkv, group,
                                   n_banks, bank_len, dim, scale, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The limits the kernel's register arrays are sized for.
int kv_decode_max_group() { return kMaxGroup; }
int kv_decode_max_dim() { return kMaxDim; }

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
