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
// What bounds it on this card.  Operations: per batch row C B^T is 2Q^2N
// flops, and per head the intra, inbound-state and outbound-state
// products are 2Q^2P + 2QNP + 2QPN.  At mamba2-130m's chunk (Q 256, P 64,
// N 128, H 24) that is about 0.42 GFLOP per batch row against ~5 MB of
// inputs and outputs, so f32 arithmetic (67 TFLOP/s on CUDA cores), not
// the 3.35 TB/s of HBM, is the limit.  The reference holds the chunk to
// 1e-4; TF32 tensor cores round inputs to 10 mantissa bits (~1e-3 over
// 256 terms), so every product is an f32 FMA on CUDA cores and every
// exponential is expf.
//
// Design.  Two kernels, launched back to back on one stream by one C
// entry (one port of ssd_chunk_step):
//   ssd_y_kernel: one CTA per (row tile of 64 positions i, column tile
//     of 64 head dims p, head, batch row).  The [Q, Q] score matrix and a
//     whole [Q, N] tile of C or B do not fit a CTA's shared memory at
//     Q 256, N 128, so the CTA walks the j tiles of 32 positions up to
//     its last row, recomputing C_i B_j^T in chunks of 32 state dims,
//     scales it by the decay and dt_j, masks j > i, and accumulates
//     S_ij x_j.  C and B are read per CTA from global memory; the 50 MB
//     L2 serves the repeats across heads.
//   ssd_state_kernel: one CTA per (64 x 64 tile of h_out, head, batch
//     row), accumulating (tail_j dt_j x_j)^T B_j over j tiles of 32.
// Each thread owns a 4 x 4 (or 4 x 2) micro-tile, rows ty + 16 r and
// columns tx + 16 c, so shared-memory reads are broadcasts or
// consecutive.  Every load masks its tail: Q, P and N need not be
// multiples of anything.  wgmma, TMA and pipelining are left for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kTi = 64;        // rows i (y) per CTA
constexpr int kTp = 64;        // head dims p per CTA
constexpr int kTj = 32;        // positions j per step
constexpr int kKn = 32;        // state dims n per step
constexpr int kTn = 64;        // state dims n (h_out) per CTA

__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ cum, const float* __restrict__ B,
             const float* __restrict__ C, const float* __restrict__ h_in,
             float* __restrict__ y, int H, int Q, int P, int N, int p_tiles) {
  __shared__ float cs[kTi][kKn + 1];   // C rows i, one n chunk
  __shared__ float bs[kTp][kKn + 1];   // B rows j, or h_in rows p
  __shared__ float ss[kTi][kTj + 1];   // masked, decayed scores
  __shared__ float xs[kTj][kTp];       // x rows j
  __shared__ float cum_i[kTi];
  __shared__ float cum_j[kTj];
  __shared__ float dt_j[kTj];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = (blockIdx.x / p_tiles) * kTi;
  const int p0 = (blockIdx.x % p_tiles) * kTp;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* xb = x + bh * Q * P;
  const float* cumb = cum + bh * Q;
  const float* dtb = dt + bh * Q;
  const float* Bb = B + static_cast<int64_t>(b) * Q * N;
  const float* Cb = C + static_cast<int64_t>(b) * Q * N;
  const float* hb = h_in + bh * P * N;

  if (tid < kTi) cum_i[tid] = (i0 + tid < Q) ? cumb[i0 + tid] : 0.f;
  __syncthreads();

  // inbound state: acc[i][p] = exp(cum_i) * sum_n C[i,n] h_in[p,n]
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kKn) {
    for (int e = tid; e < kTi * kKn; e += kThreads) {
      const int r = e / kKn, k = e % kKn;
      const int i = i0 + r, n = n0 + k;
      cs[r][k] = (i < Q && n < N) ? Cb[static_cast<int64_t>(i) * N + n] : 0.f;
    }
    for (int e = tid; e < kTp * kKn; e += kThreads) {
      const int r = e / kKn, k = e % kKn;
      const int p = p0 + r, n = n0 + k;
      bs[r][k] = (p < P && n < N) ? hb[static_cast<int64_t>(p) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKn; ++k) {
      float a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = cs[ty + 16 * r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = bs[tx + 16 * c][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float g = expf(cum_i[ty + 16 * r]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] *= g;
  }

  // intra-chunk term over j <= i: S_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j
  const int j_end = min(Q, i0 + kTi);
  for (int j0 = 0; j0 < j_end; j0 += kTj) {
    if (tid < kTj) {
      const int j = j0 + tid;
      cum_j[tid] = (j < Q) ? cumb[j] : 0.f;
      dt_j[tid] = (j < Q) ? dtb[j] : 0.f;
    }
    __syncthreads();
    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kKn) {
      for (int e = tid; e < kTi * kKn; e += kThreads) {
        const int r = e / kKn, k = e % kKn;
        const int i = i0 + r, n = n0 + k;
        cs[r][k] = (i < Q && n < N) ? Cb[static_cast<int64_t>(i) * N + n] : 0.f;
      }
      for (int e = tid; e < kTj * kKn; e += kThreads) {
        const int r = e / kKn, k = e % kKn;
        const int j = j0 + r, n = n0 + k;
        bs[r][k] = (j < Q && n < N) ? Bb[static_cast<int64_t>(j) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKn; ++k) {
        float a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = cs[ty + 16 * r][k];
        const float w0 = bs[tx][k], w1 = bs[tx + 16][k];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r][0] = fmaf(a[r], w0, s[r][0]);
          s[r][1] = fmaf(a[r], w1, s[r][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jl = tx + 16 * c, j = j0 + jl;
        ss[il][jl] = (j <= i && i < Q)
                         ? s[r][c] * expf(cum_i[il] - cum_j[jl]) * dt_j[jl]
                         : 0.f;
      }
    }
    for (int e = tid; e < kTj * kTp; e += kThreads) {
      const int r = e / kTp, k = e % kTp;
      const int j = j0 + r, p = p0 + k;
      xs[r][k] = (j < Q && p < P) ? xb[static_cast<int64_t>(j) * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jl = 0; jl < kTj; ++jl) {
      float a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ss[ty + 16 * r][jl];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = xs[jl][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* yb = y + bh * Q * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = p0 + tx + 16 * c;
      if (i < Q && p < P) yb[static_cast<int64_t>(i) * P + p] = acc[r][c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ B,
                 const float* __restrict__ h_in, float* __restrict__ h_out,
                 int H, int Q, int P, int N, int n_tiles) {
  __shared__ float us[kTj][kTp];  // exp(cum_Q - cum_j) dt_j x[j, p]
  __shared__ float bs[kTj][kTn];  // B[j, n]
  __shared__ float tail[kTj];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int p0 = (blockIdx.x / n_tiles) * kTp;
  const int n0 = (blockIdx.x % n_tiles) * kTn;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* xb = x + bh * Q * P;
  const float* cumb = cum + bh * Q;
  const float* dtb = dt + bh * Q;
  const float* Bb = B + static_cast<int64_t>(b) * Q * N;
  const float cum_last = cumb[Q - 1];

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int j0 = 0; j0 < Q; j0 += kTj) {
    if (tid < kTj) {
      const int j = j0 + tid;
      tail[tid] = (j < Q) ? expf(cum_last - cumb[j]) * dtb[j] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kTj * kTp; e += kThreads) {
      const int r = e / kTp, k = e % kTp;
      const int j = j0 + r, p = p0 + k;
      us[r][k] = (j < Q && p < P)
                     ? tail[r] * xb[static_cast<int64_t>(j) * P + p]
                     : 0.f;
    }
    for (int e = tid; e < kTj * kTn; e += kThreads) {
      const int r = e / kTn, k = e % kTn;
      const int j = j0 + r, n = n0 + k;
      bs[r][k] = (j < Q && n < N) ? Bb[static_cast<int64_t>(j) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jl = 0; jl < kTj; ++jl) {
      float a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = us[jl][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = bs[jl][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
    __syncthreads();
  }

  const float g = expf(cum_last);
  const float* hb = h_in + bh * P * N;
  float* ob = h_out + bh * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (p < P && n < N) {
        const int64_t o = static_cast<int64_t>(p) * N + n;
        ob[o] = g * hb[o] + acc[r][c];
      }
    }
  }
}

}  // namespace

extern "C" {

// x [bt, H, Q, P], dt and cum [bt, H, Q], B and C [bt, Q, N],
// h_in [bt, H, P, N] -> y [bt, H, Q, P], h_out [bt, H, P, N]; all f32 and
// contiguous.  Returns cudaGetLastError() after both launches.
int ssd_chunk_launch(const float* x, const float* dt, const float* cum,
                     const float* B, const float* C, const float* h_in,
                     float* y, float* h_out, int bt, int H, int Q, int P,
                     int N, void* stream) {
  if (bt == 0 || H == 0 || Q == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p_tiles = (P + kTp - 1) / kTp;
  const int i_tiles = (Q + kTi - 1) / kTi;
  const int n_tiles = (N + kTn - 1) / kTn;
  ssd_y_kernel<<<dim3(i_tiles * p_tiles, H, bt), kThreads, 0, s>>>(
      x, dt, cum, B, C, h_in, y, H, Q, P, N, p_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0) return 0;
  ssd_state_kernel<<<dim3(p_tiles * n_tiles, H, bt), kThreads, 0, s>>>(
      x, dt, cum, B, h_in, h_out, H, Q, P, N, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
