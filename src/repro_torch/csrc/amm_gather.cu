// H-NTX-Rd XOR-banked gather (the paper's AMM read path) for Hopper.
//
// Replaces: src/repro/kernels/amm_gather.py, amm_gather_u32 (block body
// _gather_block), the Pallas kernel behind repro.kernels.ops.amm_gather.
//
// What it computes.  A table [V, D] is split into NB depth banks
// [NB, R, D] (R = V / NB) plus a parity plane parity[o] = XOR_j banks[j, o].
// Request i of the call reads row idx[i] (bank = idx / R, off = idx % R).
// Even requests take the direct path, banks[bank, off]; odd requests take
// the reconstruction path, parity[off] ^ XOR_{j != bank} banks[j, off],
// which is what the second read port of the memory does when both
// requests of a cycle hit one bank.  The parity of the request is its
// index in the whole call (the Pallas block body counts within its block;
// the two agree whenever the block size is even or the call is one block,
// and with a consistent parity plane the output is the same either way).
//
// What bounds it on this card.  Bytes: each request writes one row and
// reads one (even slot) or NB (odd slot: the parity row and the NB - 1
// other banks) rows; no arithmetic beyond XOR.  The least traffic is the
// output rows plus the distinct table rows touched, over 3.35 TB/s.
// Token ids are zipfian, so the hot rows and their bank partners stay in
// the 50 MB L2 and the reconstruction reads mostly hit there: counted at
// the L2, an odd slot moves NB rows, so the L2's own rate may set the
// pace before the HBM does.
//
// Design.  One warp serves a pair of requests, the even slot 2k and the
// odd slot 2k + 1, so every warp reads the same NB + 1 rows and writes
// two (a warp per request left the even warps idle while the odd ones
// read NB rows).  A CTA holds ``pairs`` such warps (1, 2, 4, 8 or 16, a
// launch argument: the JAX block_n is 2 x pairs ids; the default is 4,
// the autotuner's table may pick another).  Its 32 lanes move the rows
// as words of 16, 8, 4 or 2 bytes, also a launch argument: any width
// that divides the row pitch and every base address (the default is the
// widest such word).  A lane
// issues the direct word, the parity word and the bank words four banks
// at a time before their XORs, so up to six loads of 16 bytes are in
// flight per lane.  An instantiation per bank count, with all NB loads of
// a word in flight, was timed against this loop at NB 8 and 65536 ids of
// 4 KB rows: 0.2102 against 0.2066 ms in one call on an H100 80GB HBM3
// (700 W), so load latency does not set the pace, and one loop serves
// every bank count.  The output rows are written with streaming stores
// (st.global.cs) so that they do not push the hot rows and their bank
// partners out of the L2.  Bank and offset come from one 32-bit division
// a request (ids are int32); the per-word index is 32-bit, the row bases
// 64-bit.  XOR is bitwise, so the word width never changes the result:
// the kernel is bit-exact for f32 and bf16 tables alike.  Indices must
// satisfy 0 <= idx < V, as in the Pallas kernel; they are not checked
// here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 word_xor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint2 word_xor(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}
__device__ __forceinline__ uint32_t word_xor(uint32_t a, uint32_t b) {
  return a ^ b;
}
__device__ __forceinline__ uint16_t word_xor(uint16_t a, uint16_t b) {
  return static_cast<uint16_t>(a ^ b);
}

constexpr int kMaxPairs = 16;       // warps (request pairs) a CTA at most
constexpr int kBankBatch = 4;       // bank loads a lane issues together

// acc XOR the banks j != skip at one word, the loads of each batch of
// banks issued before their XORs.
template <typename W>
__device__ __forceinline__ W xor_others(const W* __restrict__ row0,
                                        size_t bank_stride, uint32_t skip,
                                        int n_banks, uint32_t w, W acc) {
  for (int j0 = 0; j0 < n_banks; j0 += kBankBatch) {
    W v[kBankBatch];
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u) {
      const int j = j0 + u;
      v[u] = (j < n_banks && static_cast<uint32_t>(j) != skip)
                 ? __ldg(row0 + j * bank_stride + w) : W{};
    }
#pragma unroll
    for (int u = 0; u < kBankBatch; ++u) acc = word_xor(acc, v[u]);
  }
  return acc;
}

template <typename W>
__global__ void __launch_bounds__(kMaxPairs * 32)
amm_gather_kernel(const W* __restrict__ banks, const W* __restrict__ parity,
                  const int32_t* __restrict__ idx, W* __restrict__ out,
                  int64_t n, int n_banks, uint32_t rows, uint32_t words) {
  const int64_t first =
      2 * ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const uint32_t lane = threadIdx.x & 31;
  if (first >= n) return;
  const bool has_odd = first + 1 < n;
  const size_t bank_stride = static_cast<size_t>(rows) * words;
  const uint32_t i0 = static_cast<uint32_t>(idx[first]);
  const uint32_t i1 = has_odd ? static_cast<uint32_t>(idx[first + 1]) : i0;
  const uint32_t bank0 = i0 / rows, bank1 = i1 / rows;
  const uint32_t off1 = i1 - bank1 * rows;
  const W* direct = banks + bank0 * bank_stride +
                    static_cast<size_t>(i0 - bank0 * rows) * words;
  const W* row0 = banks + static_cast<size_t>(off1) * words;
  const W* par = parity + static_cast<size_t>(off1) * words;
  W* dst = out + static_cast<size_t>(first) * words;
  for (uint32_t w = lane; w < words; w += 32) {
    const W d = __ldg(direct + w);
    if (has_odd) {
      const W acc = xor_others<W>(row0, bank_stride, bank1, n_banks, w,
                                  __ldg(par + w));
      __stcs(dst + w, d);
      __stcs(dst + words + w, acc);
    } else {
      __stcs(dst + w, d);
    }
  }
}

template <typename W>
int launch(const void* banks, const void* parity, const void* idx, void* out,
           int64_t n, int n_banks, uint32_t rows, int64_t row_bytes,
           int pairs, cudaStream_t stream) {
  const auto words = static_cast<uint32_t>(row_bytes / sizeof(W));
  const int64_t n_pairs = (n + 1) / 2;
  const int64_t blocks = (n_pairs + pairs - 1) / pairs;
  amm_gather_kernel<W><<<static_cast<unsigned>(blocks), pairs * 32, 0,
                         stream>>>(
      static_cast<const W*>(banks), static_cast<const W*>(parity),
      static_cast<const int32_t*>(idx), static_cast<W*>(out), n, n_banks,
      rows, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// banks: [n_banks, rows, row_bytes] bytes; parity: [rows, row_bytes];
// idx: [n] int32; out: [n, row_bytes].  word_bytes is 16, 8, 4 or 2 and
// divides row_bytes and every base address; pairs (warps a CTA) is 1, 2,
// 4, 8 or 16.  Any other value returns cudaErrorInvalidValue.  Returns
// cudaGetLastError().
int amm_gather_launch(const void* banks, const void* parity, const void* idx,
                      void* out, long long n, long long n_banks,
                      long long rows, long long row_bytes, int word_bytes,
                      int pairs, void* stream) {
  if (pairs < 1 || pairs > kMaxPairs || (pairs & (pairs - 1)) != 0 ||
      (word_bytes != 16 && word_bytes != 8 && word_bytes != 4 &&
       word_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (n_banks < 1 || rows < 1 || rows > INT32_MAX ||
      row_bytes % word_bytes != 0 || row_bytes / word_bytes > UINT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(n_banks);
  const auto r = static_cast<uint32_t>(rows);
  switch (word_bytes) {
    case 16:
      return launch<uint4>(banks, parity, idx, out, n, nb, r, row_bytes,
                           pairs, s);
    case 8:
      return launch<uint2>(banks, parity, idx, out, n, nb, r, row_bytes,
                           pairs, s);
    case 4:
      return launch<uint32_t>(banks, parity, idx, out, n, nb, r,
                              row_bytes, pairs, s);
    case 2:
      return launch<uint16_t>(banks, parity, idx, out, n, nb, r,
                              row_bytes, pairs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
