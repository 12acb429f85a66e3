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
// reads one (even slot) or NB + 1 (odd slot) rows; no arithmetic beyond
// XOR.  The least traffic is the output rows plus the distinct table rows
// touched, over 3.35 TB/s.  Token ids are zipfian, so the hot rows and
// their bank partners stay in the 50 MB L2 and the reconstruction reads
// mostly hit there.
//
// Design.  One warp per request; its 32 lanes move the row as words of
// 16 bytes (or 8, 4, 2 bytes when the row pitch or a base address is not
// 16-byte aligned: the host picks the widest word that divides both), so
// a warp issues 512-byte coalesced loads and stores.  XOR is bitwise, so
// the word width never changes the result: the kernel is bit-exact for
// f32 and bf16 tables alike.  Indices must satisfy 0 <= idx < V, as in
// the Pallas kernel; they are not checked here.
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

constexpr int kWarpsPerBlock = 8;

template <typename W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
amm_gather_kernel(const W* __restrict__ banks, const W* __restrict__ parity,
                  const int32_t* __restrict__ idx, W* __restrict__ out,
                  int64_t n, int64_t n_banks, int64_t rows, int64_t words) {
  const int64_t req =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (req >= n) return;
  const int64_t i = idx[req];
  const int64_t bank = i / rows;
  const int64_t off = i - bank * rows;
  const int64_t bank_stride = rows * words;
  const W* row0 = banks + off * words;  // the request's row in bank 0
  W* dst = out + req * words;
  if ((req & 1) == 0) {  // first port: direct bank read
    const W* src = row0 + bank * bank_stride;
    for (int64_t w = lane; w < words; w += 32) dst[w] = src[w];
  } else {  // second port: parity XOR every other bank
    const W* par = parity + off * words;
    for (int64_t w = lane; w < words; w += 32) {
      W acc = par[w];
      for (int64_t j = 0; j < n_banks; ++j) {
        if (j != bank) acc = word_xor(acc, row0[j * bank_stride + w]);
      }
      dst[w] = acc;
    }
  }
}

template <typename W>
int launch(const void* banks, const void* parity, const void* idx, void* out,
           int64_t n, int64_t n_banks, int64_t rows, int64_t row_bytes,
           cudaStream_t stream) {
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(W));
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  amm_gather_kernel<W><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                         0, stream>>>(
      static_cast<const W*>(banks), static_cast<const W*>(parity),
      static_cast<const int32_t*>(idx), static_cast<W*>(out), n, n_banks,
      rows, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// banks: [n_banks, rows, row_bytes] bytes; parity: [rows, row_bytes];
// idx: [n] int32; out: [n, row_bytes].  word_bytes is 16, 8, 4 or 2 and
// divides row_bytes and every base address.  Returns cudaGetLastError().
int amm_gather_launch(const void* banks, const void* parity, const void* idx,
                      void* out, long long n, long long n_banks,
                      long long rows, long long row_bytes, int word_bytes,
                      void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16:
      return launch<uint4>(banks, parity, idx, out, n, n_banks, rows,
                           row_bytes, s);
    case 8:
      return launch<uint2>(banks, parity, idx, out, n, n_banks, rows,
                           row_bytes, s);
    case 4:
      return launch<uint32_t>(banks, parity, idx, out, n, n_banks, rows,
                              row_bytes, s);
    case 2:
      return launch<uint16_t>(banks, parity, idx, out, n, n_banks, rows,
                              row_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
