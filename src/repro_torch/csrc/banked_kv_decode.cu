// Banked KV-cache decode (one GQA decode step) for Hopper: split-bank
// flash-decoding with K/V tiles staged through shared memory by the
// Tensor Memory Accelerator.
//
// Replaces: src/repro/kernels/banked_kv_decode.py, banked_kv_decode (block
// body _decode_block), the Pallas kernel behind repro.kernels.ops.kv_decode.
//
// What it computes.  q [B, Hq, D]; k, v [B, Hkv, NB, SB, D] (the cache
// [B, Hkv, S, D] cut into NB sequence banks of SB positions); lengths [B].
// For every query head, an f32 online softmax over the row's positions
// with scale 1/sqrt(D): positions >= lengths[b] get weight 0 and never
// move the max, and the output is acc / max(l, 1e-30) cast to q's type
// (round to nearest even), so a row of length 0 decodes to exact zeros.
//
// What bounds it on this card.  Bytes: a decode step reads every valid
// K and V row once, sum_b lengths[b] * Hkv * D * 2 * itemsize, and does
// 4 flops per element read per query head of the group: far below the
// ~295 flop/byte at which the tensor cores, rather than the 3.35 TB/s of
// HBM, would be the limit, and a few percent of the 67 TFLOP/s of f32 on
// CUDA cores.  So the products are f32 FMAs on CUDA cores (which also
// keep the reference's 1e-5 in f32, which TF32 cannot), and the design
// is about bytes in flight and balance.
//
// Design.  Two kernels on the caller's stream.
//
// 1. kv_split_kernel: one CTA of 128 threads per (batch row, kv head,
//    split, head block).  A split is a run of split_len positions inside
//    one bank (the whole bank or an equal sub-division of it whose length
//    is a multiple of the tile; the autotuner's table or its default
//    chooses it), so each bank is still read as an independent port.  A
//    split that starts at or past lengths[b] exits at once, and the last
//    non-empty split stops at the length.  At decode_32k (SB 4096, split 1024) that
//    is 32768 CTAs, half of them empty, each streaming at most 512 KB:
//    the row-length imbalance of one CTA per row becomes a tail of at
//    most one split.
//
//    K and V tiles of the split are one contiguous block each, so thread
//    0 copies them with the 1-D bulk copy (cp.async.bulk ... complete_tx)
//    into a ring of kStages stages, each completing on an mbarrier; the
//    next three tiles are in flight while one is scored.  At decode_32k a
//    tile is 32 positions (8 KB of K and 8 KB of V), a CTA holds 64 KB
//    and three CTAs fit on an SM: up to 144 KB of K/V in flight per SM.
//    Rows whose byte length is not a multiple of 16 (or unaligned bases)
//    cannot be bulk-copied; the same kernel then copies each tile with
//    plain loads into rows padded to 16 bytes with zeros (kBulk false,
//    chosen by shape).
//
//    Compute reads the tile from shared memory in 16-byte words.  The
//    threads of a warp form lane groups of LPR lanes (the least power of
//    two covering the row at 8 head dims a lane: 16 lanes at D 128 bf16),
//    and lane group r of warp w owns rows w*RPW*R + j*RPW + r of the tile
//    (RPW = 32 / LPR, j < R = 4).  A lane owns the same 8 head dims of
//    every row: their q values sit in registers, its 16-byte words of K
//    and V are read straight from shared memory, and the 32 lanes of a
//    warp read RPW whole consecutive rows at once, 512 contiguous bytes,
//    so no two lanes of a quarter-warp meet in a bank.  Scores are summed
//    over the LPR lanes by xor shuffles (every lane gets the same bits);
//    each lane group keeps its own online-softmax state (m, l and acc for
//    its head dims) over its rows, so no barrier separates scoring from
//    the softmax or the p @ V products.  One __syncthreads per tile hands
//    the stage back to the copy.  At the end of the split the lane
//    groups' states are merged through shared memory into (m, l, acc),
//    unnormalised, in the workspace.
//
//    Registers: the kernel is templated on the head block kHB (1, 2 or
//    4, a launch argument; the default is the group rounded up to a power
//    of two and capped at 4, and the autotuner's table may pick another):
//    a lane holds kHB * 8 q values and kHB * 8 accumulators.  A group
//    larger than the head block (8, 12, 16 at the default) runs
//    ceil(group / kHB) head blocks as neighbouring CTAs that read the same
//    tiles, the second and later time mostly from L2; holding 16 heads in
//    one CTA would need 256 registers a lane for q and acc alone.  Heads
//    of a block past the group are masked out.
//
// 2. kv_combine_kernel: one warp per (batch row, query head) merges the
//    row's non-empty splits in position order: m = max m_s, l = sum l_s
//    e^(m_s - m), out = sum acc_s e^(m_s - m) / max(l, 1e-30).  A row with
//    no non-empty split writes exact zeros without touching the workspace.
//
// The design this replaces: one CTA per (batch row, kv head) walked
// its whole row bank by bank in tiles of 128 positions with plain global
// loads and three __syncthreads a tile, 1024 CTAs for the whole step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;          // R: rows a lane group scores per tile
constexpr int kStages = 4;        // bulk-copy ring depth
constexpr int kLaneDims = 8;      // head dims a lane owns
constexpr int kMaxHeadBlock = 4;  // query heads a CTA serves
constexpr int kMaxGroup = 16;     // query heads per kv head
constexpr int kMaxDim = 256;
constexpr int kBarrierBytes = 128;  // mbarriers at the front of smem
constexpr int kCombineWarps = 4;

// Tile geometry of a head dim, shared by host and device.  A row is
// padded to 16-byte words in shared memory; a lane owns itemsize / 2
// words (8 head dims); LPR lanes cover a row.
struct Geometry {
  int row_bytes;  // a row in shared memory, padded to 16 bytes
  int words;      // 16-byte words a row
  int lpr;        // lanes a row
  int tile;       // positions a tile
};

__host__ __device__ inline Geometry geometry(int dim, int itemsize) {
  Geometry g;
  g.row_bytes = (dim * itemsize + 15) / 16 * 16;
  g.words = g.row_bytes / 16;
  const int per_lane = itemsize / 2;
  const int spans = (g.words + per_lane - 1) / per_lane;
  g.lpr = 1;
  while (g.lpr < spans) g.lpr <<= 1;
  g.tile = kWarps * (32 / g.lpr) * kRows;
  return g;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as JAX casts
}

// 16 bytes as floats: 4 f32 or 8 bf16.
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One contiguous block of global memory into shared memory by the TMA,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct SplitArgs {
  float* ws_acc;  // [B * Hq, n_splits, dim]
  float* ws_ml;   // [B * Hq, n_splits, 2]
  int hkv, group, n_head_blocks, n_splits, dim;
  int64_t seq, split_len;
  float scale;
};

template <typename T, int kHB, bool kBulk>
__global__ void __launch_bounds__(kThreads)
kv_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int32_t* __restrict__ lengths,
                SplitArgs a) {
  constexpr int kVec = 16 / sizeof(T);       // head dims a 16-byte word
  constexpr int kWords = kLaneDims / kVec;   // words a lane: bf16 1, f32 2
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + kBarrierBytes;

  int64_t item = blockIdx.x;
  const int hb = static_cast<int>(item % a.n_head_blocks);
  item /= a.n_head_blocks;
  const int split = static_cast<int>(item % a.n_splits);
  item /= a.n_splits;
  const int h = static_cast<int>(item % a.hkv);
  const int64_t b = item / a.hkv;
  const int64_t len = min64(lengths[b] < 0 ? 0 : lengths[b], a.seq);
  const int64_t start = split * a.split_len;
  if (start >= len) return;  // the whole CTA: nothing to read
  const int64_t n = min64(a.split_len, len - start);

  const Geometry geo = geometry(a.dim, sizeof(T));
  const int tile = geo.tile;
  const int ntiles = static_cast<int>((n + tile - 1) / tile);
  const int tile_bytes = tile * geo.row_bytes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lpr = geo.lpr;
  const int rpw = 32 / lpr;
  const int sub = lane & (lpr - 1);
  const int r = lane / lpr;
  const int grp = warp * rpw + r;         // this lane's lane group
  const int row0 = warp * rpw * kRows + r;  // its first row in a tile

  const int64_t kv_row = static_cast<int64_t>(b) * a.hkv + h;
  const T* kb = k + (kv_row * a.seq + start) * a.dim;
  const T* vb = v + (kv_row * a.seq + start) * a.dim;
  auto stage_k = [&](int s) { return stages + s * 2 * tile_bytes; };
  auto stage_v = [&](int s) { return stages + (s * 2 + 1) * tile_bytes; };
  auto rows_of = [&](int t) {
    return static_cast<int>(min64(tile, n - static_cast<int64_t>(t) * tile));
  };
  auto load_tile = [&](int t) {
    const int s = t % kStages;
    const uint32_t bytes = rows_of(t) * geo.row_bytes;
    const int64_t off = static_cast<int64_t>(t) * tile * a.dim;
    mbar_expect_tx(&full[s], 2 * bytes);
    bulk_load(stage_k(s), kb + off, bytes, &full[s]);
    bulk_load(stage_v(s), vb + off, bytes, &full[s]);
  };

  if constexpr (kBulk) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      for (int t = 0; t < kStages && t < ntiles; ++t) load_tile(t);
    }
  }

  // this lane's head dims of each query head of the block, 0 past the
  // head dim or the group
  const int head0 = hb * kHB;
  float qr[kHB][kLaneDims];
#pragma unroll
  for (int g = 0; g < kHB; ++g) {
    const bool head_ok = head0 + g < a.group;
    const T* qrow = q + (kv_row * a.group + head0 + g) * a.dim;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int c = sub + w * lpr;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = c * kVec + e;
        qr[g][w * kVec + e] =
            head_ok && c < geo.words && d < a.dim ? to_f32(qrow[d]) : 0.f;
      }
    }
  }

  float m[kHB], l[kHB], acc[kHB][kLaneDims];
#pragma unroll
  for (int g = 0; g < kHB; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneDims; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = kBulk ? t % kStages : 0;
    const int rows = rows_of(t);
    if constexpr (kBulk) {
      mbar_wait(&full[s], (t / kStages) & 1);
    } else {
      // rows padded with zeros to 16 bytes: a zero q dim times a zero
      // pad adds nothing, and pad dims of acc are never written out
      const int dp = geo.row_bytes / static_cast<int>(sizeof(T));
      const int64_t off = static_cast<int64_t>(t) * tile * a.dim;
      T* ks = reinterpret_cast<T*>(stage_k(0));
      T* vs = reinterpret_cast<T*>(stage_v(0));
      for (int e = tid; e < rows * dp; e += kThreads) {
        const int row = e / dp;
        const int d = e - row * dp;
        const int64_t src = off + static_cast<int64_t>(row) * a.dim + d;
        store_f32(ks + e, d < a.dim ? to_f32(kb[src]) : 0.f);
        store_f32(vs + e, d < a.dim ? to_f32(vb[src]) : 0.f);
      }
      __syncthreads();
    }
    const unsigned char* ks = stage_k(s);
    const unsigned char* vs = stage_v(s);

    // scores of this lane group's rows against the head block
    float sc[kRows][kHB];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = row0 + j * rpw;
      float part[kHB];
#pragma unroll
      for (int g = 0; g < kHB; ++g) part[g] = 0.f;
      if (row < rows) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int c = sub + w * lpr;
          if (c < geo.words) {
            float x[kVec];
            unpack(*reinterpret_cast<const uint4*>(
                       ks + row * geo.row_bytes + c * 16),
                   x);
#pragma unroll
            for (int g = 0; g < kHB; ++g) {
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                part[g] = fmaf(qr[g][w * kVec + e], x[e], part[g]);
            }
          }
        }
      }
      for (int o = 1; o < lpr; o <<= 1) {
#pragma unroll
        for (int g = 0; g < kHB; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
#pragma unroll
      for (int g = 0; g < kHB; ++g) sc[j][g] = part[g] * a.scale;
    }

    // fold the rows into the lane group's running max, sum and acc
#pragma unroll
    for (int g = 0; g < kHB; ++g) {
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (row0 + j * rpw < rows) mx = fmaxf(mx, sc[j][g]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p =
            row0 + j * rpw < rows ? expf(sc[j][g] - m_new) : 0.f;
        sc[j][g] = p;
        psum += p;
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kLaneDims; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = row0 + j * rpw;
      if (row < rows) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int c = sub + w * lpr;
          if (c < geo.words) {
            float x[kVec];
            unpack(*reinterpret_cast<const uint4*>(
                       vs + row * geo.row_bytes + c * 16),
                   x);
#pragma unroll
            for (int g = 0; g < kHB; ++g) {
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[g][w * kVec + e] =
                    fmaf(sc[j][g], x[e], acc[g][w * kVec + e]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if constexpr (kBulk) {
      if (tid == 0 && t + kStages < ntiles) load_tile(t + kStages);
    }
  }

  // merge the lane groups' states; every copy has landed and been read,
  // so the stages are free
  const int groups = kWarps * rpw;
  const int dp = geo.words * kVec;
  float* red_m = reinterpret_cast<float*>(stages);  // [groups][kHB]
  float* red_l = red_m + groups * kHB;              // [groups][kHB]
  float* red_acc = red_l + groups * kHB;            // [groups][kHB][dp]
#pragma unroll
  for (int g = 0; g < kHB; ++g) {
    if (sub == 0) {
      red_m[grp * kHB + g] = m[g];
      red_l[grp * kHB + g] = l[g];
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int c = sub + w * lpr;
      if (c < geo.words) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          red_acc[(grp * kHB + g) * dp + c * kVec + e] =
              acc[g][w * kVec + e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kHB * a.dim; i += kThreads) {
    const int g = i / a.dim;
    const int d = i - g * a.dim;
    if (head0 + g >= a.group) break;
    float mm = -1e30f;
    for (int x = 0; x < groups; ++x) mm = fmaxf(mm, red_m[x * kHB + g]);
    float ll = 0.f, aa = 0.f;
    for (int x = 0; x < groups; ++x) {
      const float wgt = expf(red_m[x * kHB + g] - mm);
      ll += red_l[x * kHB + g] * wgt;
      aa += red_acc[(x * kHB + g) * dp + d] * wgt;
    }
    const int64_t qh = kv_row * a.group + head0 + g;  // row of [B * Hq]
    const int64_t slot = qh * a.n_splits + split;
    a.ws_acc[slot * a.dim + d] = aa;
    if (d == 0) {
      a.ws_ml[slot * 2] = mm;
      a.ws_ml[slot * 2 + 1] = ll;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
kv_combine_kernel(const float* __restrict__ ws_acc,
                  const float* __restrict__ ws_ml,
                  const int32_t* __restrict__ lengths, T* __restrict__ out,
                  int64_t n_rows, int hq, int64_t seq, int64_t split_len,
                  int n_splits, int dim) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int64_t b = row / hq;
  const int64_t len = min64(lengths[b] < 0 ? 0 : lengths[b], seq);
  const int active = static_cast<int>((len + split_len - 1) / split_len);
  T* o = out + row * dim;
  if (active == 0) {
    for (int d = lane; d < dim; d += 32) store_f32(o + d, 0.f);
    return;
  }
  const float* ml = ws_ml + row * n_splits * 2;
  const float* as = ws_acc + row * n_splits * dim;
  float m = -1e30f;
  for (int s = 0; s < active; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  float acc[kMaxDim / 32];
#pragma unroll
  for (int c = 0; c < kMaxDim / 32; ++c) acc[c] = 0.f;
  for (int s = 0; s < active; ++s) {
    const float w = expf(ml[2 * s] - m);
    l += ml[2 * s + 1] * w;
#pragma unroll
    for (int c = 0; c < kMaxDim / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < dim) acc[c] += as[static_cast<int64_t>(s) * dim + d] * w;
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kMaxDim / 32; ++c) {
    const int d = lane + 32 * c;
    if (d < dim) store_f32(o + d, acc[c] * inv);
  }
}

// Dynamic shared memory of a split CTA: the barriers, then the stage
// ring (one stage for plain loads), or the merge of the lane groups'
// states if that is larger.
size_t split_smem(const Geometry& geo, int head_block, int itemsize,
                  bool bulk) {
  const size_t ring = static_cast<size_t>(bulk ? kStages : 1) * 2 *
                      geo.tile * geo.row_bytes;
  const size_t groups = kWarps * (32 / geo.lpr);
  const size_t dp = geo.row_bytes / itemsize;
  const size_t merge = sizeof(float) * groups * head_block * (2 + dp);
  return kBarrierBytes + (ring > merge ? ring : merge);
}

template <typename T, int kHB, bool kBulk>
int launch_split_kernel(const void* q, const void* k, const void* v,
                 const void* lengths, const SplitArgs& args,
                 unsigned grid, cudaStream_t stream) {
  const Geometry geo = geometry(args.dim, sizeof(T));
  const size_t smem = split_smem(geo, kHB, sizeof(T), kBulk);
  auto kernel = kv_split_kernel<T, kHB, kBulk>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths), args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kHB>
int launch_split(bool bulk, const void* q, const void* k, const void* v,
                 const void* lengths, const SplitArgs& args, unsigned grid,
                 cudaStream_t stream) {
  return bulk ? launch_split_kernel<T, kHB, true>(q, k, v, lengths, args,
                                                  grid, stream)
              : launch_split_kernel<T, kHB, false>(q, k, v, lengths, args,
                                                   grid, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, float* workspace, long long batch, int hkv, int group,
           int n_banks, long long bank_len, long long split_len, int dim,
           float scale, int head_block, int vec, cudaStream_t stream) {
  SplitArgs args;
  args.hkv = hkv;
  args.group = group;
  args.n_head_blocks = (group + head_block - 1) / head_block;
  args.n_splits = static_cast<int>(n_banks * (bank_len / split_len));
  args.dim = dim;
  args.seq = static_cast<int64_t>(n_banks) * bank_len;
  args.split_len = split_len;
  args.scale = scale;
  const int64_t n_rows = static_cast<int64_t>(batch) * hkv * group;
  args.ws_acc = workspace;
  args.ws_ml = workspace + n_rows * args.n_splits * dim;
  const long long grid = batch * hkv * args.n_splits * args.n_head_blocks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(grid);
  const bool bulk = vec != 0;
  int code;
  switch (head_block) {
    case 1:
      code = launch_split<T, 1>(bulk, q, k, v, lengths, args, g, stream);
      break;
    case 2:
      code = launch_split<T, 2>(bulk, q, k, v, lengths, args, g, stream);
      break;
    case kMaxHeadBlock:
      code = launch_split<T, kMaxHeadBlock>(bulk, q, k, v, lengths, args, g,
                                            stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  const unsigned cgrid =
      static_cast<unsigned>((n_rows + kCombineWarps - 1) / kCombineWarps);
  kv_combine_kernel<T><<<cgrid, kCombineWarps * 32, 0, stream>>>(
      args.ws_acc, args.ws_ml, static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), n_rows, hkv * group, args.seq, split_len,
      args.n_splits, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [batch, hkv * group, dim]; k, v: [batch, hkv, n_banks * bank_len, dim];
// lengths: [batch] int32; out like q.  workspace: batch * hkv * group *
// n_splits * (dim + 2) floats, n_splits = n_banks * bank_len / split_len.
// split_len divides bank_len and is a multiple of kv_decode_tile(dim,
// itemsize) unless it is the whole bank.  dtype 0 = float32, 1 = bfloat16.
// head_block (query heads a split CTA) is 1, 2 or 4.  vec = 1 (bulk
// copies) needs dim * itemsize a multiple of 16 and k and v 16-byte
// aligned; vec = 0 takes plain loads.  Needs group <= kv_decode_max_group()
// and dim <= kv_decode_max_dim(); otherwise, or on any other head_block,
// returns cudaErrorInvalidValue.  Returns cudaGetLastError() after the
// second launch.
int kv_decode_launch(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* workspace,
                     long long batch, int hkv, int group, int n_banks,
                     long long bank_len, long long split_len, int dim,
                     float scale, int dtype, int head_block, int vec,
                     void* stream) {
  if (head_block != 1 && head_block != 2 && head_block != kMaxHeadBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || hkv == 0) return 0;
  if (group < 1 || group > kMaxGroup || dim < 1 || dim > kMaxDim ||
      n_banks < 1 || bank_len < 1 || split_len < 1 ||
      bank_len % split_len != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == 0 ? 4 : 2;
  if (split_len != bank_len && split_len % geometry(dim, itemsize).tile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (dim * itemsize) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, lengths, out, ws, batch, hkv, group,
                           n_banks, bank_len, split_len, dim, scale,
                           head_block, vec, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, lengths, out, ws, batch, hkv,
                                   group, n_banks, bank_len, split_len, dim,
                                   scale, head_block, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The limits the kernel serves, and the positions of a tile for a head
// dim and item size (the wrapper picks the split length from it).
int kv_decode_max_group() { return kMaxGroup; }
int kv_decode_max_dim() { return kMaxDim; }
int kv_decode_tile(int dim, int itemsize) {
  return geometry(dim, itemsize).tile;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
