// Mamba2 SSD chunk step (state-space duality, arXiv:2405.21060) for Hopper.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_chunk_step (block body
// _ssd_block), the Pallas kernel behind repro.kernels.ops.ssd_chunk.
//
// What it computes.  For one chunk of Q tokens, per (batch row b, head h):
//   x [Bt, H, Q, P], dt and cum [Bt, H, Q], B and C [Bt, Q, N],
//   h_in [Bt, H, P, N], all f32;
//   L[i,j] = exp(cum_i - cum_j) for j <= i, else 0
//   y      = ((C B^T) o L)(dt x) + (C o exp(cum)) h_in^T      [Q, P]
//   h_out  = exp(cum_Q) h_in + (exp(cum_Q - cum) dt x)^T B     [P, N]
// The causal mask is exact: the reference's exp(-1e30) is 0, so tiles
// with j > i are skipped and the terms of every sum are unchanged.
//
// What bounds it on this card.  Operations: per batch row C B^T is Q^2 N
// causal flops, and per head the intra, inbound-state and outbound-state
// products are Q^2 P + 2QNP + 2QPN.  At mamba2-130m's chunk (Q 256, P 64,
// N 128, H 24, Bt 8) that is 2.49 GFLOP against 40 MB of inputs and
// outputs.  The function is specified in f32, which the card runs at 67
// TFLOP/s on CUDA cores (0.037 ms) or, split into three TF32 products,
// at 495 TFLOP/s on the tensor cores (3 x 2.49 GFLOP: 0.015 ms, above the
// 0.012 ms of the bytes).  Plain TF32 rounds every operand to 11
// significant bits (~1e-3 over 256 terms) and would miss the 1e-4 gate.
//
// Design.  Three __global__s, launched back to back on one stream by one
// C entry (one port of ssd_chunk_step):
//   ssd_cb_kernel: C B^T once a batch row, not once a head: one CTA per
//     causal 64 x 64 tile, written to an f32 workspace [Bt, Qp, Qp]
//     (Qp = Q rounded up to the tile; 2 MB at the main shape, so it stays
//     in the 50 MB L2 for the next kernel).
//   ssd_y_kernel: one CTA per (64 rows i, 64 head dims p, head, batch
//     row).  It first takes the inbound state C_i h_in^T over N and
//     scales its rows by exp(cum_i), then walks j up to its last row: the
//     C B^T block from the workspace becomes the score block
//     S_ij = CB_ij exp(cum_i - cum_j) dt_j (masked j > i) in shared
//     memory, and the CTA accumulates S x_j.  The decay is applied to the
//     score after the product, never folded into the operands as
//     exp(cum_i) exp(-cum_j): at dt 0.1 and A -16 cum falls to about -400
//     within a chunk and exp(-cum_j) would overflow.  The row tiles are
//     launched longest first (the grid's slowest index walks i from the
//     last tile down), so the CTAs with the most j steps do not form the
//     tail of the launch.
//   ssd_state_kernel: one CTA per (64 p x 64 n tile of h_out, head,
//     batch row), accumulating (exp(cum_Q - cum_j) dt_j x_j)^T B_j over
//     j; the weight is applied to the A operand as its fragment is
//     loaded.
// Every product runs on the tensor cores as mma.sync.m16n8k8 TF32 in
// split precision ("3xTF32"): each f32 operand a is split into a TF32
// high part hi (a rounded to nearest) and the residual lo = a - hi, and
// the warp accumulates lo_a hi_b + hi_a lo_b + hi_a hi_b in f32, which
// keeps about 20 significant bits of every product (the dropped lo_a lo_b
// is below 2^-22 of it, lo's own truncation below 2^-21).  Each CTA has
// 4 warps, each owning a 32 x 32 tile of the CTA's 64 x 64 output (2 x 4
// fragments of m16n8).  The depth is walked in steps of 32, whose
// operands cp.async stages into a 2-stage ring in 37 KB of static shared
// memory (so registers, not shared memory, cap the CTAs an SM holds): 16
// bytes a copy when every row and base is 16-byte aligned (P and N
// multiples of 4; the host says so), else 4 bytes a copy; elements past
// Q, P or N are zero-filled by the copy itself (src-size 0), so every
// tail is masked.  Shared-memory rows
// are padded so that the hand-loaded fragments hit 32 distinct banks:
// operands read as [row][k] have a row pitch of 36 floats (4 mod 32),
// operands read as [k][col] 72 (8 mod 32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;             // output tile edge (rows and columns)
constexpr int kK = 32;             // depth of one staged step
constexpr int kThreads = 128;      // 4 warps, 2 x 2 over a 64 x 64 tile
constexpr int kRowK = kK + 4;      // pitch of a [row][k] operand tile
constexpr int kKCol = kT + 8;      // pitch of a [k][col] operand tile
constexpr int kOperand = kT * kRowK > kK * kKCol ? kT * kRowK : kK * kKCol;
// one stage of the ring: two operand tiles plus two vectors of kK
constexpr int kStage = 2 * kOperand + 2 * kK;
constexpr int kSmemFloats = 2 * kStage + kT;

// ---------------------------------------------------------------- copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the R x C tile src[r * ld + c] into dst[r * pitch + c]; only
// r < rows and c < cols are read, the rest is zero-filled.  With kVec,
// ld, cols and src are multiples of 4 floats (16 bytes).
template <bool kVec, int R, int C>
__device__ __forceinline__ void stage_tile(float* dst, int pitch,
                                           const float* src, int64_t ld,
                                           int rows, int cols) {
  static_assert((R * C / 4) % kThreads == 0, "whole copies a thread");
  if constexpr (kVec) {
#pragma unroll
    for (int u = 0; u < R * C / 4 / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / (C / 4), c = (e % (C / 4)) * 4;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * pitch + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < R * C / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / C, c = e % C;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * pitch + c, ok ? src + r * ld + c : src, ok);
    }
  }
}

// Stage kK consecutive floats src[0 .. n) into dst, zero past n; thread
// lane0 + e copies element e.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int n, int lane0) {
  const int e = static_cast<int>(threadIdx.x) - lane0;
  if (e >= 0 && e < kK) cp_async4(dst + e, e < n ? src + e : src, e < n);
}

// ------------------------------------------------------- split-TF32 mma
// hi: a rounded to the nearest TF32, ties away from zero (cvt.rna's
// rounding, done as an add and a mask on the bits: cvt.rna.tf32.f32 is
// emulated on sm_90 in several times the instructions); lo: the exact
// residual a - hi, whose low 13 bits the tensor core drops, an error
// below 2^-10 |lo| <= 2^-21 |a|.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over one kK-deep step of shared tiles, for this warp's
// 32 x 32 tile at (m0, n0).  A is read as [m][k] (kARowK: A[m * pa + k])
// or as [k][m] (A[k * pa + m]), B as [n][k] (kBRowK: B[n * pb + k]) or as
// [k][n].  With wk, element k of A is scaled by wk[k] before the split.
template <bool kARowK, bool kBRowK>
__device__ __forceinline__ void warp_mma(float (&acc)[2][4][4],
                                         const float* A, int pa,
                                         const float* B, int pb, int m0,
                                         int n0, const float* wk = nullptr) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kK; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mt * 16 + g + (e & 1) * 8;
        const int k = k0 + t + (e >> 1) * 4;
        float v = kARowK ? A[m * pa + k] : A[k * pa + m];
        if (wk != nullptr) v *= wk[k];
        split_tf32(v, ah[mt][e], al[mt][e]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nt * 8 + g;
        const int k = k0 + t + e * 4;
        split_tf32(kBRowK ? B[n * pb + k] : B[k * pb + n], bh[nt][e],
                   bl[nt][e]);
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(acc[mt][nt], al[mt], bh[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
  }
}

// Element e of fragment (mt, nt) of the warp's accumulator sits at row
// m0 + mt * 16 + g + (e >> 1) * 8 and column n0 + nt * 8 + 2t + (e & 1).
struct WarpTile {
  int m0, n0, g, t;
  __device__ WarpTile() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    m0 = (warp >> 1) * 32;
    n0 = (warp & 1) * 32;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ int row(int mt, int e) const {
    return m0 + mt * 16 + g + (e >> 1) * 8;
  }
  __device__ int col(int nt, int e) const {
    return n0 + nt * 8 + 2 * t + (e & 1);
  }
};

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// The steps of a CTA's main loop run through a 2-stage ring: the copies
// of step s + 1 are in flight while step s computes.  stage(s) issues
// step s's copies, compute(s) consumes them after the barrier.
template <class Stage, class Compute>
__device__ __forceinline__ void pipeline(int steps, Stage stage,
                                         Compute compute) {
  if (steps > 0) {
    stage(0);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    compute(s);
    __syncthreads();
  }
}

__device__ __forceinline__ void tri_tile(int k, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
  tj = k - ti * (ti + 1) / 2;
}

// ------------------------------------------------------------- kernels
// CB[b, i, j] = sum_n C[b, i, n] B[b, j, n] for the causal tile
// (ti, tj), tj <= ti, of the [Qp, Qp] workspace of batch row b.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ B, const float* __restrict__ C,
              float* __restrict__ cb, int Q, int N, int qp) {
  __shared__ __align__(16) float smem[kSmemFloats];
  int ti, tj;
  tri_tile(blockIdx.x, ti, tj);
  const int i0 = ti * kT, j0 = tj * kT, b = blockIdx.y;
  const float* Cb = C + (static_cast<int64_t>(b) * Q + i0) * N;
  const float* Bb = B + (static_cast<int64_t>(b) * Q + j0) * N;
  const WarpTile wt;
  float acc[2][4][4];
  zero(acc);
  pipeline(
      (N + kK - 1) / kK,
      [&](int s) {
        float* buf = smem + (s & 1) * kStage;
        const int n0 = s * kK;
        stage_tile<kVec, kT, kK>(buf, kRowK, Cb + n0, N, Q - i0, N - n0);
        stage_tile<kVec, kT, kK>(buf + kOperand, kRowK, Bb + n0, N, Q - j0,
                                 N - n0);
      },
      [&](int s) {
        const float* buf = smem + (s & 1) * kStage;
        warp_mma<true, true>(acc, buf, kRowK, buf + kOperand, kRowK, wt.m0,
                             wt.n0);
      });
  float* out = cb + static_cast<int64_t>(b) * qp * qp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[static_cast<int64_t>(i0 + wt.row(mt, e)) * qp + j0 +
            wt.col(nt, e)] = acc[mt][nt][e];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ cum, const float* __restrict__ C,
             const float* __restrict__ h_in, const float* __restrict__ cb,
             float* __restrict__ y, int H, int Q, int P, int N, int qp,
             int p_tiles) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* cum_i = smem + 2 * kStage;
  const int ti = gridDim.z - 1 - blockIdx.z;    // longest tiles first
  const int i0 = ti * kT;
  const int p0 = (blockIdx.x % p_tiles) * kT;
  const int h = blockIdx.x / p_tiles, b = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* xb = x + bh * Q * P + p0;
  const float* cumb = cum + bh * Q;
  const float* dtb = dt + bh * Q;
  const float* Cb = C + (static_cast<int64_t>(b) * Q + i0) * N;
  const float* hb = h_in + (bh * P + p0) * N;
  const float* cbb = cb + (static_cast<int64_t>(b) * qp + i0) * qp;
  const WarpTile wt;
  float acc[2][4][4];
  zero(acc);
  if (threadIdx.x < kT)
    cum_i[threadIdx.x] = i0 + threadIdx.x < Q ? cumb[i0 + threadIdx.x] : 0.f;
  __syncthreads();

  // inbound state: acc[i][p] = exp(cum_i) sum_n C[i, n] h_in[p, n]
  pipeline(
      (N + kK - 1) / kK,
      [&](int s) {
        float* buf = smem + (s & 1) * kStage;
        const int n0 = s * kK;
        stage_tile<kVec, kT, kK>(buf, kRowK, Cb + n0, N, Q - i0, N - n0);
        stage_tile<kVec, kT, kK>(buf + kOperand, kRowK, hb + n0, N, P - p0,
                                 N - n0);
      },
      [&](int s) {
        const float* buf = smem + (s & 1) * kStage;
        warp_mma<true, true>(acc, buf, kRowK, buf + kOperand, kRowK, wt.m0,
                             wt.n0);
      });
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gain = expf(cum_i[wt.row(mt, e)]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[mt][nt][e] *= gain;
    }

  // intra-chunk term over j <= i: S_ij = CB_ij exp(cum_i - cum_j) dt_j.
  // __expf (ex2.approx of diff * log2 e) is within 2^-22 + |diff| 4e-8
  // of exp relative to it: below 1e-6 where the decay exceeds 2e-9.
  const int j_end = min(Q, i0 + kT);
  pipeline(
      (j_end + kK - 1) / kK,
      [&](int s) {
        float* buf = smem + (s & 1) * kStage;
        const int j0 = s * kK;
        stage_tile<true, kT, kK>(buf, kRowK, cbb + j0, qp, kT, kK);
        stage_tile<kVec, kK, kT>(buf + kOperand, kKCol,
                                 xb + static_cast<int64_t>(j0) * P, P,
                                 Q - j0, P - p0);
        float* vec = buf + 2 * kOperand;
        stage_vec(vec, cumb + j0, Q - j0, 0);
        stage_vec(vec + kK, dtb + j0, Q - j0, kK);
      },
      [&](int s) {
        float* s_tile = smem + (s & 1) * kStage;
        const float* x_tile = s_tile + kOperand;
        const float* cum_j = s_tile + 2 * kOperand;
        const float* dt_j = cum_j + kK;
        const int j0 = s * kK;
#pragma unroll 4
        for (int u = 0; u < kT * kK / kThreads; ++u) {
          const int e = threadIdx.x + u * kThreads;
          const int r = e / kK, c = e % kK;
          const int i = i0 + r, j = j0 + c;
          float* sp = s_tile + r * kRowK + c;
          *sp = (j <= i && i < Q)
                    ? *sp * __expf(cum_i[r] - cum_j[c]) * dt_j[c]
                    : 0.f;
        }
        __syncthreads();
        warp_mma<true, false>(acc, s_tile, kRowK, x_tile, kKCol, wt.m0,
                              wt.n0);
      });

  float* yb = y + bh * Q * P;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wt.row(mt, e), p = p0 + wt.col(nt, e);
        if (i < Q && p < P)
          yb[static_cast<int64_t>(i) * P + p] = acc[mt][nt][e];
      }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ B,
                 const float* __restrict__ h_in, float* __restrict__ h_out,
                 int H, int Q, int P, int N, int n_tiles) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* wk = smem + 2 * kStage;     // exp(cum_Q - cum_j) dt_j of a step
  const int p0 = (blockIdx.x / n_tiles) * kT;
  const int n0 = (blockIdx.x % n_tiles) * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* xb = x + bh * Q * P + p0;
  const float* cumb = cum + bh * Q;
  const float* dtb = dt + bh * Q;
  const float* Bb = B + static_cast<int64_t>(b) * Q * N + n0;
  const float cum_last = cumb[Q - 1];
  const WarpTile wt;
  float acc[2][4][4];
  zero(acc);
  pipeline(
      (Q + kK - 1) / kK,
      [&](int s) {
        float* buf = smem + (s & 1) * kStage;
        const int j0 = s * kK;
        stage_tile<kVec, kK, kT>(buf, kKCol,
                                 xb + static_cast<int64_t>(j0) * P, P,
                                 Q - j0, P - p0);
        stage_tile<kVec, kK, kT>(buf + kOperand, kKCol,
                                 Bb + static_cast<int64_t>(j0) * N, N,
                                 Q - j0, N - n0);
        float* vec = buf + 2 * kOperand;
        stage_vec(vec, cumb + j0, Q - j0, 0);
        stage_vec(vec + kK, dtb + j0, Q - j0, kK);
      },
      [&](int s) {
        const float* buf = smem + (s & 1) * kStage;
        const float* vec = buf + 2 * kOperand;
        if (threadIdx.x < kK) {
          const int j = s * kK + threadIdx.x;
          wk[threadIdx.x] = j < Q ? expf(cum_last - vec[threadIdx.x]) *
                                        vec[kK + threadIdx.x]
                                  : 0.f;
        }
        __syncthreads();
        warp_mma<false, false>(acc, buf, kKCol, buf + kOperand, kKCol,
                               wt.m0, wt.n0, wk);
      });

  const float gain = expf(cum_last);
  const float* hb = h_in + bh * P * N;
  float* ob = h_out + bh * P * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + wt.row(mt, e), n = n0 + wt.col(nt, e);
        if (p < P && n < N) {
          const int64_t o = static_cast<int64_t>(p) * N + n;
          ob[o] = gain * hb[o] + acc[mt][nt][e];
        }
      }
}

template <bool kVec>
int launch(const float* x, const float* dt, const float* cum, const float* B,
           const float* C, const float* h_in, float* y, float* h_out,
           float* cb, int bt, int H, int Q, int P, int N, cudaStream_t s) {
  const int q_tiles = (Q + kT - 1) / kT;
  const int p_tiles = (P + kT - 1) / kT;
  const int n_tiles = (N + kT - 1) / kT;
  const int qp = q_tiles * kT;
  ssd_cb_kernel<kVec><<<dim3(q_tiles * (q_tiles + 1) / 2, bt), kThreads, 0,
                        s>>>(B, C, cb, Q, N, qp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_y_kernel<kVec><<<dim3(p_tiles * H, bt, q_tiles), kThreads, 0, s>>>(
      x, dt, cum, C, h_in, cb, y, H, Q, P, N, qp, p_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || N == 0) return static_cast<int>(err);
  ssd_state_kernel<kVec><<<dim3(p_tiles * n_tiles, H, bt), kThreads, 0,
                           s>>>(x, dt, cum, B, h_in, h_out, H, Q, P, N,
                                n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile edge: the workspace is [bt, Qp, Qp] f32 with Qp = Q rounded
// up to a multiple of it.
int ssd_chunk_tile() { return kT; }

// x [bt, H, Q, P], dt and cum [bt, H, Q], B and C [bt, Q, N],
// h_in [bt, H, P, N] -> y [bt, H, Q, P], h_out [bt, H, P, N]; all f32 and
// contiguous.  workspace: [bt, Qp, Qp] f32 (see ssd_chunk_tile).  vec is
// 1 when P and N are multiples of 4 and every base is 16-byte aligned.
// Returns cudaGetLastError() after the launches.
int ssd_chunk_launch(const float* x, const float* dt, const float* cum,
                     const float* B, const float* C, const float* h_in,
                     float* y, float* h_out, float* workspace, int bt, int H,
                     int Q, int P, int N, int vec, void* stream) {
  if (bt == 0 || H == 0 || Q == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, dt, cum, B, C, h_in, y, h_out, workspace, bt,
                            H, Q, P, N, s)
             : launch<false>(x, dt, cum, B, C, h_in, y, h_out, workspace, bt,
                             H, Q, P, N, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
