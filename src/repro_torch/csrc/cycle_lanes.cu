// The batched timing backend's lane loop for Hopper: every design lane of
// a DSE grid scheduled over one trace, one CTA a lane, the whole cycle
// loop in one launch.
//
// Replaces: src/repro/core/sim/jax_cycle.py:130 _make_lane_fn (the lane
// of jax_cycle.schedule_batched), a lax.while_loop over simulated cycles
// holding a second while_loop (the deferral scan), vmap-ped over the lanes.
// It is not a Pallas kernel.  Its plain version is
// src/repro_torch/kernels/cycle_lanes.py::cycle_lanes_plain.
//
// What it computes.  The port-constrained list scheduler of the paper
// (III-C) for one trace under L memory designs.  Each simulated cycle:
//   1. retire: a node is retired once issued and finish <= cycle;
//   2. ready: not issued and every predecessor retired;
//   3. a select within each class of the class-grouped priority
//      permutation perm (arrays first, then the 7 FU classes, each sorted
//      by (-height, node)): the ready nodes of an array become its
//      candidates in rank order, at most S of them; an FU-class node
//      issues when its rank within its class is at most the class's
//      budget (beside step 4, which it does not touch);
//   4. the deferral scan: each array pops its candidates in order and
//      issues or defers each one by its design's rules (banked bank
//      ports; multipump/ideal/LVT port budgets; NTX direct or parity leaf
//      paths and B/HB write pairs through the Ref unit; remap live-bank
//      reads and write steering), with the reference's budgets, scan cap
//      (max_failed) and first-deferral stall attribution;
//   5. the clock moves to the next cycle, or jumps to the next finish
//      when nothing is ready and something is in flight.
// The rules are jax_cycle.py's, branch for branch; the results (cycles,
// counters, per-array accesses, final remap maps, the event log) are
// equal to it bit for bit.
//
// What bounds it on this card.  Not bytes: a lane reads its trace
// tensors once (under a megabyte a lane at the full DSE matrix's sizes)
// and writes a few counters and its maps.  The serial chain of simulated
// cycles bounds it: a lane runs up to ~49 000 cycles, each a handful of
// block barriers and a few dependent L2 round trips (the retire's
// pending-count atomics, the select's reads of the chosen positions),
// plus the deferral scan: a round of the array's warp for each issue and
// for each window of 32 deferrals, each round a chain of dependent
// shared-memory loads (candidate, port keys).  Lanes are independent, so
// L lanes run on L SMs at once and the launch takes as long as its
// slowest lane.
//
// Design: a cycle costs work in proportion to what changes in it, as the
// reference's C loop (_cycle_loop.c:237-262) does, not to the trace size.
//   * Everything is in perm-position space: the host relabels the trace
//     by priority position (succ_ptr/succ_pos, the pending seeds, x_pos =
//     lat << 1 | is_load and the memory word of each position), so one
//     position index reaches every per-node datum in one independent load.
//   * Readiness from pending counts: each lane keeps pending[position],
//     seeded from the in-degree, in a global workspace packed 8, 16 or 32
//     bits a count (the narrowest that holds the trace's largest
//     in-degree; a count is decremented by an atomicSub on its 32-bit word,
//     which never borrows).  A position becomes ready when its count
//     reaches 0: its bit is set in the ready bitmap, which lives in shared
//     memory across cycles, with a summary bit per non-empty bitmap word
//     and a ready count per class.  An issue clears its bit.
//   * Retire from a finish wheel: W buckets of in-flight positions indexed
//     by finish mod W, W a power of two above the batch's largest latency,
//     so every bucket holds one finish value.  At the start of cycle c
//     every bucket with finish <= c is drained, the whole CTA walking the
//     drained positions' successors; the next finish for the idle-cycle
//     jump is the least finish of a non-empty bucket.  A bucket holds at
//     most wheel_depth positions (the host's bound on the issues that share
//     a finish; a push beyond it is an error, never a silent drop).
//   * A select in each class's own segment: class g owns the positions
//     [seg_start[g], seg_start[g + 1]), so a ready position's rank in its
//     class is the ready bits before it in that range.  A warp a class
//     (class g on warp g % 16) walks the segment from its start, skipping
//     blocks of 1024 positions with nothing ready through the summary, a
//     bitmap word a thread with a warp prefix of their counts, and stops
//     at the word that holds the k-th ready bit (k: the class's ready
//     count, at most its FU budget, or for an array the candidates its
//     scan can pop, rd + wr + max_failed, at most S).  The work a cycle
//     grows with what issues and what becomes a candidate, not with the
//     ready set.  The arrays' selects lay out the candidates before the
//     scan; the FU classes' issue beside it, on warps that scan no array
//     while there are at most 9 arrays.
//   * Candidates are laid into [A, S] slots in shared memory with their
//     word index, load flag and latency, so the scan reads no node array.
//   * The deferral scan runs one warp per array (arrays share no port
//     state; warp w takes arrays w, w + 16, ...): the reference's lockstep
//     scan unrolled per array and resolved in rounds.  The port state does
//     not change between two issues, so a round judges up to 32 pops at
//     once, a lane each, and a ballot finds the first that issues; the
//     pops before it defer in bulk (see scan_array).  Per-array port state
//     (use, ruse, wuse) sits in shared memory, cleared by the whole CTA
//     during the retire; the rest in the warp's registers, uniform across
//     its lanes; the remap map [A, D] is the maps output.
//   * An NTX word's leaf paths (arbiter.ntx_tables: direct leaf, offset,
//     parity leaves) are computed from its address and the array's tree
//     depth and levels (ntx_walk), never loaded: the walk gives the path's
//     level bits, and each parity leaf is a sum of three entries of one
//     small shared table (binary digits read in base 3), so the scan's
//     parity checks stay straight-line code.
//   * Counters are summed in shared memory, double-buffered by cycle
//     parity so that the clock step needs no trailing barrier.  Launches
//     with record = true also write the event log (cycle, path, resource,
//     slot per node).
//   * A profiling instantiation (PROFILE) sums clock64() per phase per
//     lane: retire, ready counts, candidates (the arrays' selects),
//     deferral scan and FU issue, clock; and counts the cycles visited,
//     the scan's pops and rounds, the bitmap words the selects read and
//     the non-empty words there were (what a walk of the whole bitmap
//     would have read).
//   * Errors as in jax_cycle.py:70: max-cycles (1), deadlock (2) and a
//     memory op on an unconfigured array (3); a finish-wheel overflow (4)
//     cannot happen under the host's bound.  The host raises for them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 0x7fffffff;
constexpr int kFields = 13;              // descriptor row (arbiter.py F_*)
constexpr int kFu = 7;                   // FU classes (prepared.FU_ORDER)
constexpr int kPhases = 5;               // profiled phases (see PROFILE)
constexpr int kProf = kPhases + 3;       // + visited cycles, scan pops, rounds
constexpr int kReads = 2;                // words selected, words non-empty
enum { F_KIND, F_RD, F_WR, F_SLOTS, F_NBANKS, F_DEPTH, F_LEVELS, F_HALF,
       F_SUB, F_MAXFAIL, F_CONFIGURED, F_NLEAVES, F_TREE_DEPTH };
enum { K_IDEAL, K_BANKED, K_MULTIPUMP, K_H_NTX, K_B_NTX, K_HB_NTX, K_LVT,
       K_REMAP };
enum { P_COMPUTE, P_DIRECT, P_PARITY, P_STEERED, P_PAIR_RMW, P_BROADCAST };
enum { ERR_NONE, ERR_MAX_CYCLES, ERR_DEADLOCK, ERR_UNCONFIGURED,
       ERR_WHEEL };
// per-cycle lane counters in shared memory (two buffers, by cycle parity)
enum { C_MEM, C_BANK, C_PARITY, C_PAIR, C_PR, C_RMW, C_UNCONF, C_WHEEL,
       C_N };

struct Params {
  const int* desc;          // [L, A, 13]
  const int* fu_budgets;    // [L, 7]
  const int* mem_latency;   // [L]
  const int* ppb;           // [L]
  const int* max_cycles;    // [L]
  const int* perm;          // [NPAD] node at each position (event log)
  const int* gid_perm;      // [NPAD] class id of each position
  const int* seg_start;     // [A + 8] first position of each class (+ end)
  const int* x_pos;         // [n_real] lat << 1 | is_load by position
  const int* word_pos;      // [n_real] memory word by position
  const int* succ_ptr;      // [n_real + 1] successor CSR by position
  const int* succ_pos;      // [E] successor positions
  const uint32_t* pend0;    // [pend_words] packed in-degree seeds
  int* cycles;              // [L]
  int* cnt;                 // [L, 8]
  int* per_array;           // [L, A]
  int* err;                 // [L]
  int* maps;                // [L, A, D]
  int* events;              // [L, 4, NPAD] or null
  long long* prof;          // [L, kProf] or null
  long long* reads;         // [L, kReads] or null (with prof)
  uint32_t* pend_ws;        // [L, pend_words]
  uint8_t* delayed_ws;      // [L, n_real]
  int* wheel_ws;            // [L, W, wheel_depth]
  int A, npad, n_real, S, U, NB, D;
  int pend_log;             // log2(pending bits / 8): 0, 1 or 2
  int pend_words;
  int W, wheel_depth;
};

struct Smem {
  uint32_t* rbits;   // [W32] ready bit per perm position
  uint32_t* sbits;   // [NSW] bit per non-empty rbits word
  int* cand_pos;     // [A * S]
  int* cand_w;       // [A * S] word index
  int* cand_x;       // [A * S] lat << 1 | is_load
  uint8_t* use;      // [A * (U + 1)] NTX port keys used this cycle
  int* ruse;         // [A * (NB + 1)] bank accesses this cycle
  int* wuse;         // [A * (NB + 1)] bank writes this cycle
  int* cls_ready;    // [A + 8] ready count of each class
  int* red;          // [8 * kWarps] at the end, each warp's scan pops and
                     // rounds, words selected and non-empty (int64, PROFILE)
  int* ctr;          // [2 * C_N] per-cycle lane counters
  int* arr;          // [A] per-array accesses (lane totals)
  int* bcnt;         // [W] positions in each wheel bucket
  int* bfin;         // [W] the finish of each non-empty bucket
  int* seg;          // [A + 8] seg_start
  int* kcap;         // [A + 8] the most a class takes a cycle: an FU
                     // class's budget; an array's scan pops, at most S
  int* tern;         // [1 << tern_levels(U)] x's binary digits in base 3
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// The most NTX levels k a key space of U ids can hold (3 trees of 3**k
// leaves: 3**(k + 1) <= U), so that tern covers every array's 2**k paths.
__host__ __device__ inline int tern_levels(int U) {
  int k = 0;
  for (long long keys = 9; keys <= U; keys *= 3) ++k;
  return k;
}

// Shared-memory layout; returns the bytes used.
__host__ __device__ inline size_t smem_layout(const Params& p, char* base,
                                              Smem* s) {
  const int w32 = (p.n_real + 31) / 32;
  const int nsw = (w32 + 31) / 32;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = base != nullptr ? base + off : nullptr;
    off += align16(bytes);
    return at;
  };
  char* rbits = take(sizeof(uint32_t) * (w32 + 1));
  char* sbits = take(sizeof(uint32_t) * (nsw + 1));
  char* cp = take(sizeof(int) * p.A * p.S);
  char* cw = take(sizeof(int) * p.A * p.S);
  char* cx = take(sizeof(int) * p.A * p.S);
  char* use = take(size_t(p.A) * (p.U + 1));
  char* ruse = take(sizeof(int) * p.A * (p.NB + 1));
  char* wuse = take(sizeof(int) * p.A * (p.NB + 1));
  char* cls = take(sizeof(int) * (p.A + 8));
  char* red = take(sizeof(int) * 8 * kWarps);
  char* ctr = take(sizeof(int) * 2 * C_N);
  char* arr = take(sizeof(int) * p.A);
  char* bcnt = take(sizeof(int) * p.W);
  char* bfin = take(sizeof(int) * p.W);
  char* seg = take(sizeof(int) * (p.A + 8));
  char* kcap = take(sizeof(int) * (p.A + 8));
  char* tern = take(sizeof(int) << tern_levels(p.U));
  if (s != nullptr) {
    s->rbits = reinterpret_cast<uint32_t*>(rbits);
    s->sbits = reinterpret_cast<uint32_t*>(sbits);
    s->cand_pos = reinterpret_cast<int*>(cp);
    s->cand_w = reinterpret_cast<int*>(cw);
    s->cand_x = reinterpret_cast<int*>(cx);
    s->use = reinterpret_cast<uint8_t*>(use);
    s->ruse = reinterpret_cast<int*>(ruse);
    s->wuse = reinterpret_cast<int*>(wuse);
    s->cls_ready = reinterpret_cast<int*>(cls);
    s->red = reinterpret_cast<int*>(red);
    s->ctr = reinterpret_cast<int*>(ctr);
    s->arr = reinterpret_cast<int*>(arr);
    s->bcnt = reinterpret_cast<int*>(bcnt);
    s->bfin = reinterpret_cast<int*>(bfin);
    s->seg = reinterpret_cast<int*>(seg);
    s->kcap = reinterpret_cast<int*>(kcap);
    s->tern = reinterpret_cast<int*>(tern);
  }
  return off;
}

// Every pointer of s as base + an offset the compiler must keep in a
// register: left to itself, the compiler recomputes the layout inside the
// phases' loops (to relieve the deferral scan's register pressure), which
// slowed the FU-issue phase by a tenth.
__device__ __forceinline__ void pin(Smem& s, char* base) {
  auto keep = [base](auto*& ptr) {
    uint32_t off = uint32_t(reinterpret_cast<char*>(ptr) - base);
    asm volatile("" : "+r"(off));
    ptr = reinterpret_cast<decltype(+ptr)>(base + off);
  };
  keep(s.rbits); keep(s.sbits);
  keep(s.cand_pos); keep(s.cand_w); keep(s.cand_x); keep(s.use);
  keep(s.ruse); keep(s.wuse); keep(s.cls_ready);
  keep(s.red); keep(s.ctr); keep(s.arr); keep(s.bcnt); keep(s.bfin);
  keep(s.seg); keep(s.kcap); keep(s.tern);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// floor modulo of a non-negative-or-minus-one word index, as jnp's %; a
// mask where m is a power of two (m is warp-uniform at every call)
__device__ __forceinline__ int fmod_pos(int x, int m) {
  if ((m & (m - 1)) == 0) return x & (m - 1);
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// The direct path of in-tree address ta in an NTX tree of tree_depth
// words and `levels` levels, as arbiter.ntx_tables builds its row ta: each
// level halves the range (tree_depth >> (l + 1)) and gives one bit, is the
// offset in the upper half.  Returns the bits, level 0 the highest, or -1
// where ta >= tree_depth (the zero-padded tables held leaf 0, offset 0 and
// parity leaves 0 there); leaf is the bits read in base 3 (tern[bits]) and
// off what is left of ta.  Parity leaf q takes digit 2 where q has a bit
// and the other child (1 - bit) elsewhere: tern[all] - leaf + tern[q] +
// tern[bits & q] (parity_leaf).  Where every level splits at a bit of ta
// (a power-of-two tree at least 2**levels deep: split = log2 of the leaf
// depth, else -1) the bits are ta's top ones.
__device__ __forceinline__ int ntx_walk(const int* tern, int ta,
                                        int tree_depth, int levels,
                                        int split, int& leaf, int& off) {
  leaf = 0;
  off = 0;
  if (ta >= tree_depth) return -1;
  if (split >= 0) {
    off = ta & ((1 << split) - 1);
    leaf = tern[ta >> split];
    return ta >> split;
  }
  int bits = 0;
  off = ta;
  for (int l = 0; l < levels; ++l) {
    const int h = tree_depth >> (l + 1);
    const int hi = off >= h;
    off -= hi ? h : 0;
    bits = 2 * bits + hi;
    leaf = 3 * leaf + hi;
  }
  return bits;
}

// Parity leaf q of the path ntx_walk gave: base is tern[all] - leaf.
__device__ __forceinline__ int parity_leaf(const int* tern, int bits,
                                           int base, int q) {
  return bits < 0 ? 0 : base + tern[q] + tern[bits & q];
}

// The pending count of position i in a packed word (8 << pend_log bits).
__device__ __forceinline__ uint32_t pend_field(uint32_t word, int i,
                                               int pend_log) {
  const int bits = 8 << pend_log;
  const int sh = (i & ((4 >> pend_log) - 1)) * bits;
  return bits == 32 ? word : (word >> sh) & ((1u << bits) - 1u);
}

// Position i becomes ready: its bit, its word's summary bit, its class.
__device__ __forceinline__ void make_ready(const Params& p, const Smem& s,
                                           int i) {
  const uint32_t old = atomicOr(&s.rbits[i >> 5], 1u << (i & 31));
  if (old == 0) atomicOr(&s.sbits[i >> 10], 1u << ((i >> 5) & 31));
  atomicAdd(&s.cls_ready[__ldg(p.gid_perm + i)], 1);
}

// Position i issued from the scan (any thread): clear its ready bit.
__device__ __forceinline__ void clear_ready(const Smem& s, int i) {
  const uint32_t bit = 1u << (i & 31);
  const uint32_t old = atomicAnd(&s.rbits[i >> 5], ~bit);
  if ((old & ~bit) == 0) atomicAnd(&s.sbits[i >> 10],
                                   ~(1u << ((i >> 5) & 31)));
}

// Position i goes into the finish wheel.
__device__ __forceinline__ void push_wheel(const Params& p, const Smem& s,
                                           int* wheel, int i, int fin,
                                           int* ctr) {
  const int b = fin & (p.W - 1);
  const int k = atomicAdd(&s.bcnt[b], 1);
  s.bfin[b] = fin;                   // every pusher writes the same value
  if (k < p.wheel_depth) wheel[b * p.wheel_depth + k] = i;
  else ctr[C_WHEEL] = 1;
}

// Retire position i: its successors' pending counts drop by one.
__device__ __forceinline__ void retire(const Params& p, const Smem& s,
                                       uint32_t* pend, int i) {
  const int e0 = __ldg(p.succ_ptr + i), e1 = __ldg(p.succ_ptr + i + 1);
  const int bits = 8 << p.pend_log;
  const int per_word = 4 >> p.pend_log;
  for (int e = e0; e < e1; ++e) {
    const int q = __ldg(p.succ_pos + e);
    const int sh = (q & (per_word - 1)) * bits;
    const uint32_t old = atomicSub(pend + q / per_word, 1u << sh);
    if (pend_field(old, q, p.pend_log) == 1) make_ready(p, s, q);
  }
}

// The position of the n-th (from 0) set bit of m, which has more than n.
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// The select of class g (an FU class where FU) for one cycle, by one
// warp: the first k (>= 1) ready positions of the class's segment
// [seg[g], seg[g + 1]) in order, each with its rank within the class.  A
// round reads 32 summary words (32 blocks of 1024 positions), one a
// thread; each block that holds a ready word is read a bitmap word a
// thread, masked to the segment.  An array's chosen bits become the
// candidates of their ranks: a warp prefix of the words' counts ranks
// them, each thread lays its own word's positions into their slots, and
// then a slot a thread takes its word and latency.  An FU class's chosen
// bits issue one a thread: where the first word that holds the class's
// bits holds all still wanted (a budget of a few), thread t takes its
// t-th bit; else thread t finds the t-th bit's word by a search over the
// prefix.  The thread of a word then clears its issued bits (with an
// atomic: the segment's first and last words may hold another class's
// bits, which another warp clears at the same time).  PROFILE counts the
// bitmap words read.
template <bool RECORD, bool PROFILE, bool FU>
__device__ void select_class(const Params& p, const Smem& s, int g, int k,
                             int cycle, int lane, int* wheel, int* events,
                             int* ctr, long long& words_read) {
  const int lo = s.seg[g], hi = s.seg[g + 1];     // k >= 1: lo < hi
  // FU position i, of rank r (from 0) in its class, issues
  auto issue = [&](int i, int r) {
    push_wheel(p, s, wheel, i, cycle + (__ldg(p.x_pos + i) >> 1), ctr);
    if (RECORD) {
      const int node = __ldg(p.perm + i);
      events[node] = cycle;
      events[p.npad + node] = P_COMPUTE;
      events[3 * p.npad + node] = r;
    }
  };
  // the first n chosen bits of word wd (its bits as masked) leave it
  auto clear = [&](int wd, uint32_t bits, int n) {
    const uint32_t gone =
        n == __popc(bits) ? bits : bits & ((1u << nth_bit(bits, n)) - 1u);
    const uint32_t old = atomicAnd(&s.rbits[wd], ~gone);
    if ((old & ~gone) == 0) atomicAnd(&s.sbits[wd >> 5], ~(1u << (wd & 31)));
  };
  const int w_first = lo >> 5, w_last = (hi - 1) >> 5;
  const int sb_first = w_first >> 5, sb_last = w_last >> 5;
  int taken = 0;                                  // warp-uniform
  for (int sb0 = sb_first; sb0 <= sb_last && taken < k; sb0 += 32) {
    const int sb = sb0 + lane;
    uint32_t sw = 0;
    if (sb <= sb_last) {
      sw = s.sbits[sb];
      if (sb == sb_first) sw &= ~0u << (w_first & 31);
      if (sb == sb_last) sw &= ~0u >> (31 - (w_last & 31));
    }
    uint32_t blocks = __ballot_sync(0xffffffffu, sw != 0);
    while (blocks != 0 && taken < k) {
      const int src = __ffs(blocks) - 1;
      blocks &= blocks - 1;
      const uint32_t words = __shfl_sync(0xffffffffu, sw, src);
      const int wd = (sb0 + src) * 32 + lane;
      uint32_t bits = 0;
      if ((words >> lane) & 1u) {
        bits = s.rbits[wd];
        if (wd == w_first) bits &= ~0u << (lo & 31);
        if (wd == w_last) bits &= ~0u >> (31 - ((hi - 1) & 31));
      }
      if (PROFILE) words_read += __popc(words);
      const int c = __popc(bits);
      if (FU) {
        // the first word that holds the class's bits holds every issue
        // still wanted (a budget of a few): no prefix, no search
        const uint32_t filled = __ballot_sync(0xffffffffu, c != 0);
        const int j0 = __ffs(filled) - 1;
        const int want = k - taken;
        if (filled != 0 && __shfl_sync(0xffffffffu, c, j0) >= want) {
          const uint32_t wb = __shfl_sync(0xffffffffu, bits, j0);
          const int base = ((sb0 + src) * 32 + j0) * 32;
          for (int t = lane; t < want; t += 32)
            issue(base + nth_bit(wb, t), taken + t);
          if (lane == j0) clear(wd, bits, want);
          taken = k;
          break;
        }
      }
      const int incl = warp_incl_sum(c, lane);
      const int n_take = min(__shfl_sync(0xffffffffu, incl, 31), k - taken);
      // this thread's word: its bits among the block's first n_take
      const int mine = min(max(n_take - (incl - c), 0), c);
      if (!FU) {
        int* slot = s.cand_pos + g * p.S + taken + incl - c;
        uint32_t m = bits;
        for (int q = 0; q < mine; ++q, m &= m - 1)
          slot[q] = wd * 32 + __ffs(m) - 1;
        __syncwarp();
        for (int t = lane; t < n_take; t += 32) {
          const int at = g * p.S + taken + t;
          const int i = s.cand_pos[at];
          s.cand_w[at] = __ldg(p.word_pos + i);
          s.cand_x[at] = __ldg(p.x_pos + i);
        }
        taken += n_take;
        continue;
      }
      for (int t0 = 0; t0 < n_take; t0 += 32) {
        const int t = t0 + lane;          // the t-th ready bit of the block
        int j = 0;                        // its word: the first incl > t
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(0xffffffffu, incl, j + step - 1) <= t) j += step;
        const uint32_t wb = __shfl_sync(0xffffffffu, bits, j);
        const int before = __shfl_sync(0xffffffffu, incl, j) - __popc(wb);
        if (t < n_take)
          issue(((sb0 + src) * 32 + j) * 32 + nth_bit(wb, t - before),
                taken + t);
      }
      if (mine > 0) clear(wd, bits, mine);
      taken += n_take;
    }
  }
}

// The deferral scan of one array for one cycle, by one warp.  Exactly the
// pop / defer / issue procedure of jax_cycle.py:243-378 for this array,
// resolved in rounds.  Between two issues the array's port state does not
// change, so every pop up to the next issue is judged against the same
// state: in a round lane k judges candidate cursor + k (a window of at
// most 32, cut where the one-pop loop would stop on its failure cap), a
// ballot finds the first that issues, the pops before it are deferrals
// (their failed count, first-deferral marks and stall causes in bulk),
// and its lane applies the issue as the one-pop loop does.  The result is
// the one-pop loop's, pop for pop; rounds number at most the issues plus
// the windows of deferrals.  PROFILE counts the pops and rounds.
template <bool RECORD, bool PROFILE>
__device__ void scan_array(const Params& p, const Smem& s, int lane_id,
                           int a, int cycle, int ncand, int lane,
                           uint8_t* delayed, int* events, int* wheel,
                           int* ctr, long long& pops, long long& rounds) {
  const int* d = p.desc + (size_t(lane_id) * p.A + a) * kFields;
  const int kind = d[F_KIND];
  if (d[F_CONFIGURED] <= 0) return;
  const int ppb = p.ppb[lane_id];
  const int mem_latency = p.mem_latency[lane_id];
  const bool is_h = kind == K_H_NTX;
  const bool is_ntx = kind == K_H_NTX || kind == K_B_NTX || kind == K_HB_NTX;
  const bool is_banked = kind == K_BANKED;
  const bool is_remap = kind == K_REMAP;
  const bool is_simple = !(is_ntx || is_banked || is_remap);
  const bool is_lvt = kind == K_LVT;
  const int n_banks = max(d[F_NBANKS], 1);
  const int depth = max(d[F_DEPTH], 1);
  const int half = max(d[F_HALF], 0);
  const int sub = max(d[F_SUB], 1);
  const int max_failed = d[F_MAXFAIL];
  const int nl = max(d[F_NLEAVES], 1);
  const int tree_depth = d[F_TREE_DEPTH];
  const int levels = d[F_LEVELS];
  const int npaths = 1 << levels;
  const int all_paths = s.tern[npaths - 1];        // tern[2**levels - 1]
  const int leaf_depth = tree_depth >> levels;
  const int split = leaf_depth > 0 && (tree_depth & (tree_depth - 1)) == 0
                        ? __ffs(leaf_depth) - 1 : -1;
  // warp-uniform scan state
  int rd = d[F_RD], wr = d[F_WR], slots = d[F_SLOTS];
  int failed = 0, saturated = 0, mem_pa = 0;
  int n_bank = 0, n_par = 0, n_pair = 0, n_pr = 0, n_rmw = 0;
  int wr_half0 = 0, wr_half1 = 0;
  bool stop = false, pair_used = false;
  uint8_t* use = s.use + size_t(a) * (p.U + 1);    // cleared in the retire
  int* ruse = s.ruse + a * (p.NB + 1);
  int* wuse = s.wuse + a * (p.NB + 1);
  int* amap = p.maps + (size_t(lane_id) * p.A + a) * p.D;

  int cursor = 0;
  while (cursor < ncand) {
    const bool have = rd > 0 || wr > 0;
    const bool top = is_banked ? (have && saturated < n_banks &&
                                  failed < max_failed)
                   : is_simple ? (have && slots > 0)
                               : (have && failed < max_failed);
    if (stop || !top) break;
    // the failures left before the one-pop loop stops (a simple kind
    // pops once more and stops on that failure)
    const int room = is_simple ? max(max_failed - failed, 1)
                               : max_failed - failed;
    const int n_win = min(min(ncand - cursor, room), 32);
    const bool valid = lane < n_win;
    // ---- this lane's candidate, judged against the round's port state
    int pos = 0, w = 0, nlat = 0;
    bool ld = false, dir_defer = true, ok = true, was_delayed = false;
    int bankb = 0, used_b = 0, a_w = 0, mb = 0, wbank = 0;
    int key1 = 0, key2 = 0, key_other = 0, tree01 = 0, soff = 0;
    int tree = 0, path_bits = -1, pbase = 0;
    bool direct_free = false, first_w = false;
    if (valid) {
      const int slot = a * p.S + cursor + lane;
      pos = s.cand_pos[slot];
      w = s.cand_w[slot];
      const int x = s.cand_x[slot];
      ld = x & 1;
      nlat = x >> 1;
      dir_defer = ld ? rd <= 0 : wr <= 0;
    }
    if (valid && !dir_defer) {
      // the first-deferral flag: beside the round's other global loads
      // where it has some (NTX, remap), else only for a deferral
      if (is_ntx || is_remap) was_delayed = delayed[pos];
      if (is_banked) {
        bankb = fmod_pos(w, n_banks);
        used_b = ruse[bankb];
        ok = used_b < ppb;
        if (!ok) was_delayed = delayed[pos];
      } else if (is_remap) {
        a_w = fmod_pos(w, depth);
        mb = amap[min(a_w, p.D - 1)];     // the live map, as of this round
        if (ld) {
          ok = ruse[mb] < ppb;
        } else {
          ok = false;
          for (int i = 0; i < n_banks; ++i) {     // first free bank
            const int b = (mb + i) % n_banks;
            if (wuse[b] == 0 && ruse[b] < ppb) {
              ok = true;
              wbank = b;
              break;
            }
          }
        }
      } else if (is_ntx) {
        a_w = fmod_pos(w, depth);
        tree = is_h ? 0 : (a_w >= half ? 1 : 0);
        int leaf, off;
        path_bits = ntx_walk(s.tern, min(a_w - tree * half, p.D - 1),
                             tree_depth, levels, split, leaf, off);
        pbase = all_paths - leaf;
        soff = fmod_pos(off, sub);
        key1 = (tree * nl + leaf) * sub + soff;
        key2 = (2 * nl + leaf) * sub + soff;
        key_other = ((1 - tree) * nl + leaf) * sub + soff;
        const bool u2 = use[key2];
        direct_free = !use[key1] && (is_h || !u2);
        tree01 = min(tree, 1);
        if (ld) {
          ok = direct_free;
          if (!ok) {
            bool busy = false;
            for (int q = 0; q < npaths; ++q) {
              const int leaf_q = parity_leaf(s.tern, path_bits, pbase, q);
              const int kt = (tree * nl + leaf_q) * sub + soff;
              const int kr = (2 * nl + leaf_q) * sub + soff;
              busy |= use[kt] || (!is_h && use[kr]);
            }
            ok = !busy;
          }
        } else {
          first_w = (tree01 ? wr_half1 : wr_half0) == 0;
          const bool pair_ok = !pair_used && !use[key_other] && !u2;
          ok = is_h || first_w || pair_ok;
        }
      }
    }
    // ---- the first issuer; the pops before it defer
    const uint32_t issuers = __ballot_sync(0xffffffffu,
                                           valid && !dir_defer && ok);
    const int n_fail = issuers ? __ffs(issuers) - 1 : n_win;
    // cause: bank (banked/remap), parity (NTX read), pair (NTX write);
    // the simple kinds never defer on ok
    if (!is_simple && n_fail > 0) {
      const bool first = lane < n_fail && !dir_defer && !was_delayed;
      if (first) delayed[pos] = 1;
      const uint32_t firsts = __ballot_sync(0xffffffffu, first);
      if (!is_ntx) {
        n_bank += __popc(firsts);
      } else if (firsts) {
        const int n_ld = __popc(__ballot_sync(0xffffffffu, first && ld));
        n_par += n_ld;
        n_pair += __popc(firsts) - n_ld;
      }
    }
    failed += n_fail;
    if (is_simple && n_fail > 0 && failed >= max_failed) stop = true;
    cursor += n_fail;
    if (PROFILE) {
      pops += n_fail + (issuers != 0);
      ++rounds;
    }
    if (issuers == 0) continue;
    // ---- the issuing pop, exactly the one-pop loop's
    const int src = n_fail;
    const int facts = int(ld) | int(is_banked && used_b + 1 == ppb) << 1 |
                      int(is_ntx && ld && !direct_free) << 2 |
                      int(is_ntx && !is_h && !ld && !first_w) << 3 |
                      int(is_ntx && !is_h && !ld) << 4 | tree01 << 5;
    const int f = __shfl_sync(0xffffffffu, facts, src);
    if (lane == src) {
      int path = P_DIRECT, res = -1;
      if (is_banked) {
        ruse[bankb] += 1;
        res = bankb;
      } else if (is_ntx) {
        if (ld) {
          if (direct_free) {
            use[key1] = 1;
            if (!is_h) use[key2] = 1;
            res = key1;
          } else {
            for (int q = 0; q < npaths; ++q) {
              const int leaf_q = parity_leaf(s.tern, path_bits, pbase, q);
              use[(tree * nl + leaf_q) * sub + soff] = 1;
              if (!is_h) use[(2 * nl + leaf_q) * sub + soff] = 1;
            }
            path = P_PARITY;
          }
        } else if (!is_h && !first_w) {
          use[key2] = 1;
          use[key_other] = 1;
          path = P_PAIR_RMW;
        }
      } else if (is_remap) {
        if (ld) {
          ruse[mb] += 1;
          res = mb;
        } else {
          ruse[wbank] += 1;
          wuse[wbank] = 1;
          amap[a_w] = wbank;
          res = wbank;
          path = P_STEERED;
        }
      } else if (!ld && is_lvt) {
        path = P_BROADCAST;
      }
      clear_ready(s, pos);
      push_wheel(p, s, wheel, pos, cycle + (ld ? mem_latency : nlat), ctr);
      if (RECORD) {
        const int node = __ldg(p.perm + pos);
        events[node] = cycle;
        events[p.npad + node] = path;
        events[2 * p.npad + node] = res;
        events[3 * p.npad + node] = mem_pa;
      }
    }
    if (f & 1) --rd; else --wr;
    if (is_simple) --slots;
    saturated += (f >> 1) & 1;
    n_pr += (f >> 2) & 1;
    if (f & 8) {
      pair_used = true;
      ++n_rmw;
    }
    if (f & 16) {
      if (f & 32) ++wr_half1; else ++wr_half0;
    }
    ++mem_pa;
    ++cursor;
    __syncwarp();              // the issue's port state, for the next round
  }
  if (lane == 0) {
    if (mem_pa) {
      atomicAdd(&ctr[C_MEM], mem_pa);
      s.arr[a] += mem_pa;
      s.cls_ready[a] -= mem_pa;
    }
    if (n_bank) atomicAdd(&ctr[C_BANK], n_bank);
    if (n_par) atomicAdd(&ctr[C_PARITY], n_par);
    if (n_pair) atomicAdd(&ctr[C_PAIR], n_pair);
    if (n_pr) atomicAdd(&ctr[C_PR], n_pr);
    if (n_rmw) atomicAdd(&ctr[C_RMW], n_rmw);
  }
}

template <bool RECORD, bool PROFILE>
__global__ void __launch_bounds__(kThreads, 1)
cycle_lanes_kernel(Params p) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem s;
  smem_layout(p, smem_raw, &s);
  pin(s, smem_raw);
  const int lane_id = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int npad = p.npad, A = p.A, S = p.S, n = p.n_real;
  const int w32 = (n + 31) / 32;
  const int nsw = (w32 + 31) / 32;
  uint32_t* pend = p.pend_ws + size_t(lane_id) * p.pend_words;
  uint8_t* delayed = p.delayed_ws + size_t(lane_id) * n;
  int* wheel = p.wheel_ws + size_t(lane_id) * p.W * p.wheel_depth;
  int* events = RECORD ? p.events + size_t(lane_id) * 4 * npad : nullptr;
  const int max_cycles = p.max_cycles[lane_id];

  // ---- set-up: workspace, counters, the initial ready set -------------
  for (int i = tid; i < p.pend_words; i += kThreads) pend[i] = p.pend0[i];
  for (int i = tid; i < n; i += kThreads) delayed[i] = 0;
  if (RECORD) {
    for (int i = tid; i < npad; i += kThreads)
      events[i] = events[npad + i] = events[2 * npad + i] =
          events[3 * npad + i] = -1;
  }
  int* maps = p.maps + size_t(lane_id) * A * p.D;
  for (int i = tid; i < A * p.D; i += kThreads) maps[i] = 0;
  for (int i = tid; i < A; i += kThreads) s.arr[i] = 0;
  for (int i = tid; i < A + 8; i += kThreads) s.cls_ready[i] = 0;
  for (int i = tid; i < p.W; i += kThreads) s.bcnt[i] = s.bfin[i] = 0;
  for (int i = tid; i < 2 * C_N; i += kThreads) s.ctr[i] = 0;
  if (tid < A + 8) {
    // each class's segment, and the most it takes a cycle: an FU class
    // its budget; an array the pops its scan can make (every pop issues,
    // on a read or write port, or defers, up to max_failed, one at least
    // for the kinds that stop on their first failure past the cap), so
    // the scan never reads a slot past it; nothing for an unconfigured
    // array (its scan returns at once) and the trace's pads
    int cap = 0;
    if (tid < A) {
      const int* d = p.desc + (size_t(lane_id) * A + tid) * kFields;
      const long long most = (long long)max(d[F_RD], 0) + max(d[F_WR], 0) +
                             max(d[F_MAXFAIL], 1);
      if (d[F_CONFIGURED] > 0) cap = most < S ? int(most) : S;
    } else if (tid < A + kFu) {
      cap = max(p.fu_budgets[lane_id * kFu + tid - A], 0);
    }
    s.kcap[tid] = cap;
    s.seg[tid] = min(max(p.seg_start[tid], 0), n);
  }
  for (int x = tid; x < 1 << tern_levels(p.U); x += kThreads) {
    int v = 0;
    for (int b = x, p3 = 1; b != 0; b >>= 1, p3 *= 3) v += (b & 1) * p3;
    s.tern[x] = v;
  }
  __syncthreads();
  // a warp's 32 consecutive positions make one bitmap word
  for (int base = warp * 32; base < w32 * 32; base += kThreads) {
    const int i = base + lane;
    const bool r = i < n && pend_field(p.pend0[i >> (2 - p.pend_log)], i,
                                       p.pend_log) == 0;
    const uint32_t bits = __ballot_sync(0xffffffffu, r);
    if (lane == 0) s.rbits[base >> 5] = bits;
    if (r) atomicAdd(&s.cls_ready[__ldg(p.gid_perm + i)], 1);
  }
  __syncthreads();
  for (int base = warp * 32; base < nsw * 32; base += kThreads) {
    const int wd = base + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu,
                                        wd < w32 && s.rbits[wd] != 0);
    if (lane == 0) s.sbits[base >> 5] = bits;
  }

  int cycle = 0, remaining = n, err = ERR_NONE, parity = 0;
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long ph[kPhases] = {0, 0, 0, 0, 0};
  long long visited = 0, t_mark = 0, pops = 0, rounds = 0;
  long long words_read = 0, words_ready = 0;
  if (PROFILE) t_mark = clock64();
  auto mark = [&](int phase) {
    if (PROFILE) {
      const long long t = clock64();
      ph[phase] += t - t_mark;
      t_mark = t;
    }
  };
  // A block barrier that closes a phase.  A warp reads the clock after a
  // plain barrier as soon as it arrives (the barrier blocks only at the
  // next instruction that needs it), so the wait for the other warps
  // would count in the next phase: under PROFILE the clock read waits
  // for a branch on the barrier's result.
  auto close = [&](int phase) {
    if (PROFILE) {
      if (__syncthreads_or(0)) ph[phase] = -1;     // never taken
      mark(phase);
    } else {
      __syncthreads();
    }
  };
  __syncthreads();

  while (remaining > 0 && err == ERR_NONE) {
    if (err == ERR_NONE && cycle > max_cycles) err = ERR_MAX_CYCLES;
    int* ctr = s.ctr + parity * C_N;
    if (PROFILE) ++visited;

    // ---- retire: drain the wheel's buckets due by this cycle ----------
    int drained = 0;
    for (int b0 = 0; b0 < p.W; b0 += 32) {
      const int b = b0 + lane;
      const bool due = b < p.W && s.bcnt[b] > 0 && s.bfin[b] <= cycle;
      uint32_t m = __ballot_sync(0xffffffffu, due);
      while (m) {
        const int bb = b0 + __ffs(m) - 1;
        m &= m - 1;
        const int c = s.bcnt[bb];
        drained += c;
        for (int k = tid; k < c; k += kThreads)
          retire(p, s, pend, wheel[bb * p.wheel_depth + k]);
      }
    }
    remaining -= drained;
    for (int i = tid; i < A * (p.U + 1); i += kThreads) s.use[i] = 0;
    for (int i = tid; i < A * (p.NB + 1); i += kThreads)
      s.ruse[i] = s.wuse[i] = 0;
    if (tid < C_N) ctr[tid] = 0;
    close(0);
    for (int b = tid; b < p.W; b += kThreads)
      if (s.bcnt[b] > 0 && s.bfin[b] <= cycle) s.bcnt[b] = 0;
    // every warp: the ready total and this cycle's FU issues, a class a
    // thread
    int total_ready = 0, fu_total = 0;
    for (int g0 = 0; g0 < A + kFu; g0 += 32) {
      const int g = g0 + lane;
      const int r = g < A + kFu ? s.cls_ready[g] : 0;
      total_ready += __reduce_add_sync(0xffffffffu, r);
      fu_total += __reduce_add_sync(
          0xffffffffu, g >= A && g < A + kFu ? min(r, s.kcap[g]) : 0);
    }

    if (total_ready > 0) {
      if (PROFILE)
        for (int sb = tid; sb < nsw; sb += kThreads)
          words_ready += __popc(s.sbits[sb]);
      close(1);     // the retire's drained buckets are empty for the pushes

      // ---- candidates: each array's select into its slots -------------
      // (cls_ready holds each class's ready count as of the retire until
      // the scan or the FU issue lowers it)
      for (int a = warp; a < A; a += kWarps) {
        const int k = min(s.cls_ready[a], s.kcap[a]);
        if (k > 0)
          select_class<RECORD, PROFILE, false>(p, s, a, k, cycle, lane,
                                               wheel, events, ctr,
                                               words_read);
      }
      // an unconfigured array (the one kind of array that takes nothing)
      // with ready memory ops
      if (tid < A && s.cls_ready[tid] > 0 && s.kcap[tid] == 0)
        atomicOr(&ctr[C_UNCONF], 1);
      close(2);

      // ---- the deferral scan, one warp an array, beside the FU issue ---
      // (each reads its class's count before it writes it; class g goes
      // to warp g % 16, so an FU class runs on a warp that scans no array
      // while A <= 9)
      for (int a = warp; a < A; a += kWarps)
        scan_array<RECORD, PROFILE>(p, s, lane_id, a, cycle,
                                    min(s.cls_ready[a], s.kcap[a]), lane,
                                    delayed, events, wheel, ctr, pops, rounds);
      for (int g = warp; g < A + kFu; g += kWarps) {
        if (g < A) continue;
        const int k = min(s.cls_ready[g], s.kcap[g]);
        if (k > 0) {
          select_class<RECORD, PROFILE, true>(p, s, g, k, cycle, lane,
                                              wheel, events, ctr,
                                              words_read);
          if (lane == 0) s.cls_ready[g] -= k;
        }
      }
      close(3);
    } else {
      __syncthreads();     // the drained buckets are empty for everyone
    }

    // ---- advance the clock (every thread, from shared values) --------
    // The next retire reads the wheel and writes only the other counter
    // buffer, cls_ready and the bitmap, none of which is read here, so
    // no barrier closes the cycle.
    int next_fin = kInf;
    for (int b0 = 0; b0 < p.W; b0 += 32) {
      const int b = b0 + lane;
      const bool live = b < p.W && s.bcnt[b] > 0 && s.bfin[b] > cycle;
      next_fin = min(next_fin, warp_min(live ? s.bfin[b] : kInf));
    }
    const int mem_add = ctr[C_MEM];
    if (err == ERR_NONE && ctr[C_UNCONF]) err = ERR_UNCONFIGURED;
    if (ctr[C_WHEEL]) err = ERR_WHEEL;
    const bool still_ready = total_ready - fu_total - mem_add > 0;
    const bool any_inflight = next_fin != kInf;
    int ncycle = cycle + 1;
    if (!still_ready && any_inflight && next_fin > ncycle) ncycle = next_fin;
    if (err == ERR_NONE && !still_ready && !any_inflight && remaining > 0)
      err = ERR_DEADLOCK;
    cnt[0] += fu_total + mem_add;
    cnt[1] += mem_add;
    cnt[2] += ctr[C_BANK];
    cnt[3] += ctr[C_PARITY];
    cnt[4] += ctr[C_PAIR];
    cnt[5] += ctr[C_PR];
    cnt[6] += ctr[C_RMW];
    cnt[7] += mem_add > 0;
    cycle = ncycle;
    parity ^= 1;
    mark(4);
  }

  // each warp's scan pops and rounds, the bitmap words its selects read
  // and the non-empty words its threads counted (no thread reads red any
  // more)
  long long* red64 = reinterpret_cast<long long*>(s.red);
  if (PROFILE) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      words_ready += __shfl_xor_sync(0xffffffffu, words_ready, o);
    if (lane == 0) {
      red64[warp] = pops;
      red64[kWarps + warp] = rounds;
      red64[2 * kWarps + warp] = words_read;
      red64[3 * kWarps + warp] = words_ready;
    }
  }
  __syncthreads();
  if (tid == 0) {
    p.cycles[lane_id] = cycle;
    p.err[lane_id] = err;
    for (int i = 0; i < 8; ++i) p.cnt[lane_id * 8 + i] = cnt[i];
    if (PROFILE) {
      long long* out = p.prof + size_t(lane_id) * kProf;
      for (int i = 0; i < kPhases; ++i) out[i] = ph[i];
      out[kPhases] = visited;
      long long sum[4] = {0, 0, 0, 0};
      for (int i = 0; i < kWarps; ++i)
        for (int c = 0; c < 4; ++c) sum[c] += red64[c * kWarps + i];
      out[kPhases + 1] = sum[0];
      out[kPhases + 2] = sum[1];
      p.reads[size_t(lane_id) * kReads] = sum[2];
      p.reads[size_t(lane_id) * kReads + 1] = sum[3];
    }
  }
  for (int i = tid; i < A; i += kThreads) p.per_array[lane_id * A + i] =
      s.arr[i];
}

template <bool RECORD, bool PROFILE>
int launch(const Params& p, int lanes, cudaStream_t stream) {
  const size_t smem = smem_layout(p, nullptr, nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      cycle_lanes_kernel<RECORD, PROFILE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cycle_lanes_kernel<RECORD, PROFILE><<<lanes, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One CTA of kThreads threads crossing `iters` block-wide barriers; thread
// 0 writes the SM clocks they took.
__global__ void __launch_bounds__(kThreads, 1)
barrier_probe_kernel(int iters, long long* clocks) {
  __shared__ volatile int sink;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (threadIdx.x == (i & (kThreads - 1))) sink = i;
    __syncthreads();
  }
  if (threadIdx.x == 0) *clocks = clock64() - t0;
}

}  // namespace

extern "C" {

// Schedules L lanes over one trace (see cycle_lanes.py for the layouts).
// All pointers are device pointers; events may be null when record is 0,
// prof and reads null for the default instantiation (both or neither;
// not both record and prof).
// Returns a cudaError_t: cudaErrorInvalidValue for sizes the kernel does
// not take (more than 504 arrays, fewer than one lane, a wheel that is not
// a power of two, more than 2**19 nodes, or a shared-memory layout beyond
// the card's 227 KB).
int cycle_lanes_launch(const int* desc, const int* fu_budgets,
                       const int* mem_latency, const int* ppb,
                       const int* max_cycles, const int* perm,
                       const int* gid_perm, const int* seg_start,
                       const int* x_pos,
                       const int* word_pos, const int* succ_ptr,
                       const int* succ_pos,
                       const uint32_t* pend0, int* cycles, int* cnt,
                       int* per_array, int* err, int* maps, int* events,
                       long long* prof, long long* reads,
                       uint32_t* pend_ws,
                       uint8_t* delayed_ws, int* wheel_ws, int lanes, int A,
                       int npad, int n_real, int S, int U, int NB, int D,
                       int pend_log, int pend_words, int W,
                       int wheel_depth, int record, void* stream) {
  if (lanes < 1) return 0;
  Params p{desc, fu_budgets, mem_latency, ppb, max_cycles, perm, gid_perm,
           seg_start, x_pos, word_pos, succ_ptr, succ_pos, pend0, cycles,
           cnt, per_array, err, maps, record ? events : nullptr, prof,
           reads, pend_ws, delayed_ws, wheel_ws, A, npad, n_real, S, U, NB,
           D, pend_log, pend_words, W, wheel_depth};
  const bool pow2_w = W >= 1 && (W & (W - 1)) == 0;
  if (A < 1 || A + 8 > kThreads || n_real > npad || n_real < 0 ||
      n_real > (kThreads * 32) * 32 || S < 1 || U < 1 || NB < 1 || D < 1 ||
      pend_log < 0 || pend_log > 2 ||
      pend_words * (4 >> pend_log) < n_real || !pow2_w || wheel_depth < 1 ||
      (record && events == nullptr) || (record && prof != nullptr) ||
      (prof == nullptr) != (reads == nullptr) ||
      smem_layout(p, nullptr, nullptr) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prof != nullptr) return launch<false, true>(p, lanes, s);
  return record ? launch<true, false>(p, lanes, s)
                : launch<false, false>(p, lanes, s);
}

// The SM clocks one CTA of 512 threads takes for `iters` block barriers
// (written to *clocks, a device pointer).
int cycle_lanes_barrier_probe(int iters, long long* clocks, void* stream) {
  barrier_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, clocks);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
