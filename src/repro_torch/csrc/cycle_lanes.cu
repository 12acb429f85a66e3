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
//   2. ready: not issued and every predecessor finished (finish <= cycle;
//      the pad predecessor NPAD has finish -1);
//   3. one segmented rank over the class-grouped priority permutation
//      perm (arrays first, then the 7 FU classes, each sorted by
//      (-height, node)): an FU-class node issues when its rank within
//      its class is at most the class's budget; the ready nodes of an
//      array become its candidates in rank order, at most S of them;
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
// tensors and leaf tables once (under a megabyte a lane at the full DSE
// matrix's sizes) and writes a few counters and its maps.  The serial chain of simulated cycles bounds it: a lane
// runs up to ~41 000 cycles and each costs a handful of block barriers, a
// pass of O(n_real / threads) node tests a thread (each a dependent chain
// of L2 reads: perm -> finish / preds -> finish), and the deferral scan,
// which is serial per array.  Lanes are independent, so L lanes run on L
// SMs at once and the launch takes as long as its slowest lane.
//
// Design (a simple kernel that is right; making it fast is later work).
//   * One CTA of 512 threads a lane; the lane runs to completion.  A
//     lane that finishes early exits.  No host round trip per cycle.
//   * Node-sized state lives in a global workspace the wrapper allocates
//     (finish [NPAD + 1], delayed [NPAD]); a node is issued exactly when
//     its finish is below INT32_MAX, so no issued array is kept.
//   * The ready set is a bitmap in shared memory in perm order, one word
//     per 32 positions, built by warp ballots; its rank is a block-wide
//     prefix sum of the words' popcounts (warp shuffles, then the warp
//     totals).  A word's prefix plus the popcount below a bit is the
//     exclusive rank of a position.
//   * Candidates are laid into [A, S] slots in shared memory with their
//     word index, load flag and latency, so the scan reads no node array.
//   * The deferral scan runs one thread per array (arrays share no port
//     state): the reference's lockstep scan unrolled per array.  Per-array
//     port state (use, ruse, wuse) sits in shared memory, the rest in the
//     scan thread's registers; the remap map [A, D] is the maps output.
//   * Counters are summed after a barrier.  Launches with record = true
//     also write the event log (cycle, path, resource, slot per node).
//   * Errors as in jax_cycle.py:70: max-cycles (1), deadlock (2) and a
//     memory op on an unconfigured array (3); the host raises for them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // perm words a warp tests together
constexpr int kInf = 0x7fffffff;
constexpr int kFields = 13;              // descriptor row (arbiter.py F_*)
constexpr int kFu = 7;                   // FU classes (prepared.FU_ORDER)
enum { F_KIND, F_RD, F_WR, F_SLOTS, F_NBANKS, F_DEPTH, F_LEVELS, F_HALF,
       F_SUB, F_MAXFAIL, F_CONFIGURED, F_NLEAVES, F_TREE_DEPTH };
enum { K_IDEAL, K_BANKED, K_MULTIPUMP, K_H_NTX, K_B_NTX, K_HB_NTX, K_LVT,
       K_REMAP };
enum { P_COMPUTE, P_DIRECT, P_PARITY, P_STEERED, P_PAIR_RMW, P_BROADCAST };
enum { ERR_NONE, ERR_MAX_CYCLES, ERR_DEADLOCK, ERR_UNCONFIGURED };
// per-cycle lane counters in shared memory
enum { C_MEM, C_BANK, C_PARITY, C_PAIR, C_PR, C_RMW, C_UNCONF, C_MINFIN,
       C_N };

struct Params {
  const int* desc;          // [L, A, 13]
  const int* fu_budgets;    // [L, 7]
  const int* mem_latency;   // [L]
  const int* ppb;           // [L]
  const int* max_cycles;    // [L]
  const int* direct;        // [L, A, D]
  const int* offset;        // [L, A, D]
  const int* parity;        // [L, A, D, PP]
  const int* preds;         // [NPAD, P]
  const int* lat;           // [NPAD]
  const uint8_t* is_load;   // [NPAD]
  const int* word_idx;      // [NPAD]
  const int* perm;          // [NPAD]
  const int* gid_perm;      // [NPAD]
  const int* seg_start;     // [A + 8]
  int* cycles;              // [L]
  int* cnt;                 // [L, 8]
  int* per_array;           // [L, A]
  int* err;                 // [L]
  int* maps;                // [L, A, D]
  int* events;              // [L, 4, NPAD] or null
  int* finish_ws;           // [L, NPAD + 1]
  uint8_t* delayed_ws;      // [L, NPAD]
  int A, npad, P, n_real, S, U, NB, D, PP;
};

struct Smem {
  uint32_t* rbits;   // [W32] ready bit per perm position
  int* wpre;         // [W32] ready count before each word
  int* cand_node;    // [A * S]
  int* cand_w;       // [A * S] word index
  int* cand_x;       // [A * S] lat << 1 | is_load
  uint8_t* use;      // [A * (U + 1)] NTX port keys used this cycle
  int* ruse;         // [A * (NB + 1)] bank accesses this cycle
  int* wuse;         // [A * (NB + 1)] bank writes this cycle
  int* segpre;       // [A + 8] ready count before each class segment
  int* red;          // [4 * kWarps] reduction scratch
  int* ctr;          // [C_N] per-cycle lane counters
  int* arr;          // [A] per-array accesses (lane totals)
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared-memory layout; returns the bytes used.
__host__ __device__ inline size_t smem_layout(const Params& p, char* base,
                                              Smem* s) {
  const int w32 = (p.n_real + 31) / 32;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = base != nullptr ? base + off : nullptr;
    off += align16(bytes);
    return at;
  };
  char* rbits = take(sizeof(uint32_t) * (w32 + 1));
  char* wpre = take(sizeof(int) * (w32 + 1));
  char* cn = take(sizeof(int) * p.A * p.S);
  char* cw = take(sizeof(int) * p.A * p.S);
  char* cx = take(sizeof(int) * p.A * p.S);
  char* use = take(size_t(p.A) * (p.U + 1));
  char* ruse = take(sizeof(int) * p.A * (p.NB + 1));
  char* wuse = take(sizeof(int) * p.A * (p.NB + 1));
  char* segpre = take(sizeof(int) * (p.A + 8));
  char* red = take(sizeof(int) * 4 * kWarps);
  char* ctr = take(sizeof(int) * C_N);
  char* arr = take(sizeof(int) * p.A);
  if (s != nullptr) {
    s->rbits = reinterpret_cast<uint32_t*>(rbits);
    s->wpre = reinterpret_cast<int*>(wpre);
    s->cand_node = reinterpret_cast<int*>(cn);
    s->cand_w = reinterpret_cast<int*>(cw);
    s->cand_x = reinterpret_cast<int*>(cx);
    s->use = reinterpret_cast<uint8_t*>(use);
    s->ruse = reinterpret_cast<int*>(ruse);
    s->wuse = reinterpret_cast<int*>(wuse);
    s->segpre = reinterpret_cast<int*>(segpre);
    s->red = reinterpret_cast<int*>(red);
    s->ctr = reinterpret_cast<int*>(ctr);
    s->arr = reinterpret_cast<int*>(arr);
  }
  return off;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// floor modulo of a non-negative-or-minus-one word index, as jnp's %
__device__ __forceinline__ int fmod_pos(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// The deferral scan of one array for one cycle (one thread).  Exactly the
// pop / defer / issue procedure of jax_cycle.py:243-378 for this array.
template <bool RECORD>
__device__ void scan_array(const Params& p, const Smem& s, int lane_id,
                           int a, int cycle, int ncand, int* finish,
                           uint8_t* delayed, int* events, int& min_fin) {
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
  const int npaths = 1 << d[F_LEVELS];
  int rd = d[F_RD], wr = d[F_WR], slots = d[F_SLOTS];
  int failed = 0, saturated = 0, mem_pa = 0;
  int n_bank = 0, n_par = 0, n_pair = 0, n_pr = 0, n_rmw = 0;
  bool stop = false, pair_used = false;
  int wr_half[2] = {0, 0};
  uint8_t* use = s.use + size_t(a) * (p.U + 1);
  int* ruse = s.ruse + a * (p.NB + 1);
  int* wuse = s.wuse + a * (p.NB + 1);
  for (int k = 0; k <= p.U; ++k) use[k] = 0;
  for (int k = 0; k <= p.NB; ++k) ruse[k] = wuse[k] = 0;
  int* amap = p.maps + (size_t(lane_id) * p.A + a) * p.D;
  const size_t tab = (size_t(lane_id) * p.A + a) * p.D;

  for (int j = 0; j < ncand; ++j) {
    const bool have = rd > 0 || wr > 0;
    const bool top = is_banked ? (have && saturated < n_banks &&
                                  failed < max_failed)
                   : is_simple ? (have && slots > 0)
                               : (have && failed < max_failed);
    if (stop || !top) break;
    const int slot = a * p.S + j;
    const int node = s.cand_node[slot];
    const int w = s.cand_w[slot];
    const bool ld = s.cand_x[slot] & 1;
    const int nlat = s.cand_x[slot] >> 1;
    const bool dir_defer = ld ? rd <= 0 : wr <= 0;
    bool ok = true;
    // values the issue needs, per kind
    int bankb = 0, used_b = 0, a_w = 0, mb = 0, wbank = 0;
    int key1 = 0, key2 = 0, key_other = 0, tree01 = 0, soff = 0, ta = 0;
    int tree = 0;
    bool direct_free = false, first_w = false;
    if (!dir_defer) {
      if (is_banked) {
        bankb = fmod_pos(w, n_banks);
        used_b = ruse[bankb];
        ok = used_b < ppb;
      } else if (is_remap) {
        a_w = fmod_pos(w, depth);
        mb = amap[min(a_w, p.D - 1)];
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
        ta = min(a_w - tree * half, p.D - 1);
        const int leaf = p.direct[tab + ta];
        soff = fmod_pos(p.offset[tab + ta], sub);
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
            const int* pl = p.parity + (tab + ta) * p.PP;
            for (int q = 0; q < npaths && q < p.PP; ++q) {
              const int kt = (tree * nl + pl[q]) * sub + soff;
              const int kr = (2 * nl + pl[q]) * sub + soff;
              busy = busy || use[kt] || (!is_h && use[kr]);
            }
            ok = !busy;
          }
        } else {
          first_w = wr_half[tree01] == 0;
          const bool pair_ok = !pair_used && !use[key_other] && !u2;
          ok = is_h || first_w || pair_ok;
        }
      }
    }
    const bool issue = !dir_defer && ok;
    const bool defer = !dir_defer && !ok;
    if (issue) {
      if (ld) --rd; else --wr;
      if (is_simple) --slots;
      int path = P_DIRECT, res = -1;
      if (is_banked) {
        saturated += (used_b + 1 == ppb);
        ruse[bankb] += 1;
        res = bankb;
      } else if (is_ntx) {
        if (ld) {
          if (direct_free) {
            use[key1] = 1;
            if (!is_h) use[key2] = 1;
            res = key1;
          } else {
            const int* pl = p.parity + (tab + ta) * p.PP;
            for (int q = 0; q < npaths && q < p.PP; ++q) {
              use[(tree * nl + pl[q]) * sub + soff] = 1;
              if (!is_h) use[(2 * nl + pl[q]) * sub + soff] = 1;
            }
            ++n_pr;
            path = P_PARITY;
          }
        } else if (!is_h) {
          if (!first_w) {
            use[key2] = 1;
            use[key_other] = 1;
            pair_used = true;
            ++n_rmw;
            path = P_PAIR_RMW;
          }
          wr_half[tree01] += 1;
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
      const int fin = cycle + (ld ? mem_latency : nlat);
      finish[node] = fin;
      if (fin > cycle) min_fin = min(min_fin, fin);
      if (RECORD) {
        events[node] = cycle;
        events[p.npad + node] = path;
        events[2 * p.npad + node] = res;
        events[3 * p.npad + node] = mem_pa;
      }
      ++mem_pa;
    } else {
      ++failed;
      if (is_simple && dir_defer && failed >= max_failed) stop = true;
      if (defer && !delayed[node]) {
        delayed[node] = 1;
        if (is_ntx) { if (ld) ++n_par; else ++n_pair; } else { ++n_bank; }
      }
    }
  }
  if (mem_pa) {
    atomicAdd(&s.ctr[C_MEM], mem_pa);
    s.arr[a] += mem_pa;
  }
  if (n_bank) atomicAdd(&s.ctr[C_BANK], n_bank);
  if (n_par) atomicAdd(&s.ctr[C_PARITY], n_par);
  if (n_pair) atomicAdd(&s.ctr[C_PAIR], n_pair);
  if (n_pr) atomicAdd(&s.ctr[C_PR], n_pr);
  if (n_rmw) atomicAdd(&s.ctr[C_RMW], n_rmw);
}

template <bool RECORD>
__global__ void __launch_bounds__(kThreads, 1)
cycle_lanes_kernel(Params p) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem s;
  smem_layout(p, smem_raw, &s);
  const int lane_id = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int npad = p.npad, A = p.A, S = p.S;
  const int w32 = (p.n_real + 31) / 32;
  int* finish = p.finish_ws + size_t(lane_id) * (npad + 1);
  uint8_t* delayed = p.delayed_ws + size_t(lane_id) * npad;
  int* events = RECORD ? p.events + size_t(lane_id) * 4 * npad : nullptr;
  const int max_cycles = p.max_cycles[lane_id];
  const int* budgets = p.fu_budgets + lane_id * kFu;

  for (int i = tid; i < npad; i += kThreads) {
    finish[i] = kInf;
    delayed[i] = 0;
    if (RECORD) {
      events[i] = events[npad + i] = events[2 * npad + i] =
          events[3 * npad + i] = -1;
    }
  }
  if (tid == 0) finish[npad] = -1;               // the always-retired pred
  int* maps = p.maps + size_t(lane_id) * A * p.D;
  for (int i = tid; i < A * p.D; i += kThreads) maps[i] = 0;
  for (int i = tid; i < A; i += kThreads) s.arr[i] = 0;
  // threads own contiguous ranges of bitmap words for the prefix sum
  const int wpt = (w32 + kThreads - 1) / kThreads;

  int cycle = 0, remaining = p.n_real, err = ERR_NONE;
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  __syncthreads();

  while (remaining > 0 && err == ERR_NONE) {
    if (err == ERR_NONE && cycle > max_cycles) err = ERR_MAX_CYCLES;
    if (tid < C_N) s.ctr[tid] = tid == C_MINFIN ? kInf : 0;

    // ---- pass A: retire count, in-flight nodes, ready bitmap ----------
    int retired = 0, prev_min = kInf;
    for (int base = warp * kUnroll; base < w32; base += kWarps * kUnroll) {
      int node[kUnroll], fin[kUnroll];
      bool rdy[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = (base + u) * 32 + lane;
        node[u] = (base + u < w32 && i < p.n_real) ? __ldg(p.perm + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        fin[u] = node[u] >= 0 ? finish[node[u]] : kInf;
        rdy[u] = node[u] >= 0 && fin[u] == kInf;
        retired += node[u] >= 0 && fin[u] <= cycle;
        if (fin[u] != kInf && fin[u] > cycle) prev_min = min(prev_min,
                                                             fin[u]);
      }
      for (int k = 0; k < p.P; ++k) {
        int pr[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          pr[u] = rdy[u] ? __ldg(p.preds + size_t(node[u]) * p.P + k) : npad;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (rdy[u]) rdy[u] = finish[pr[u]] <= cycle;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t bits = __ballot_sync(0xffffffffu, rdy[u]);
        if (lane == 0 && base + u < w32) s.rbits[base + u] = bits;
      }
    }
    retired = warp_sum(retired);
    prev_min = warp_min(prev_min);
    if (lane == 0) {
      s.red[warp] = retired;
      s.red[kWarps + warp] = prev_min;
    }
    __syncthreads();
    retired = 0;
    prev_min = kInf;
    for (int i = 0; i < kWarps; ++i) {
      retired += s.red[i];
      prev_min = min(prev_min, s.red[kWarps + i]);
    }
    remaining = p.n_real - retired;

    // ---- pass B: exclusive prefix of the ready words ----------------
    int mine = 0;
    const int w_lo = min(tid * wpt, w32), w_hi = min(w_lo + wpt, w32);
    for (int wd = w_lo; wd < w_hi; ++wd) mine += __popc(s.rbits[wd]);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s.red[2 * kWarps + warp] = incl;
    __syncthreads();
    int before = 0, total_ready = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int v = s.red[2 * kWarps + i];
      if (i < warp) before += v;
      total_ready += v;
    }
    int run = before + incl - mine;
    for (int wd = w_lo; wd < w_hi; ++wd) {
      s.wpre[wd] = run;
      run += __popc(s.rbits[wd]);
    }
    if (tid == 0) {
      s.wpre[w32] = total_ready;
      s.rbits[w32] = 0;
    }
    __syncthreads();
    // ready count before each class segment start
    if (tid < A + 8) {
      const int st = min(__ldg(p.seg_start + tid), p.n_real);
      const int wd = st >> 5;
      s.segpre[tid] = s.wpre[wd] +
          __popc(s.rbits[wd] & ((1u << (st & 31)) - 1u));
    }
    __syncthreads();

    // ---- pass C: FU issue by rank, memory candidates into slots ------
    int fu_issued = 0, fu_min = kInf;
    for (int wd = warp; wd < w32; wd += kWarps) {
      const uint32_t bits = s.rbits[wd];
      if (bits == 0) continue;
      if (!((bits >> lane) & 1u)) continue;
      const int i = wd * 32 + lane;
      const int node = __ldg(p.perm + i);
      const int g = __ldg(p.gid_perm + i);
      const int rank = s.wpre[wd] + __popc(bits & ((1u << lane) - 1u)) + 1 -
                       s.segpre[g];
      if (g >= A) {
        if (g < A + kFu && rank <= budgets[g - A]) {
          const int fin = cycle + __ldg(p.lat + node);
          finish[node] = fin;
          if (fin > cycle) fu_min = min(fu_min, fin);
          ++fu_issued;
          if (RECORD) {
            events[node] = cycle;
            events[npad + node] = P_COMPUTE;
            events[3 * npad + node] = rank - 1;
          }
        }
      } else if (rank - 1 < S) {
        const int slot = g * S + rank - 1;
        s.cand_node[slot] = node;
        s.cand_w[slot] = __ldg(p.word_idx + node);
        s.cand_x[slot] = (__ldg(p.lat + node) << 1) | (p.is_load[node] & 1);
      }
    }
    fu_issued = warp_sum(fu_issued);
    fu_min = warp_min(fu_min);
    if (lane == 0) {
      s.red[warp] = fu_issued;
      s.red[kWarps + warp] = fu_min;
    }
    // unconfigured array with ready memory ops
    if (tid < A) {
      const int* d = p.desc + (size_t(lane_id) * A + tid) * kFields;
      const int n_ready = s.segpre[tid + 1] - s.segpre[tid];
      if (n_ready > 0 && d[F_CONFIGURED] <= 0) atomicOr(&s.ctr[C_UNCONF], 1);
    }
    __syncthreads();

    // ---- the deferral scan: one thread an array ----------------------
    if (tid < A) {
      const int n_ready = s.segpre[tid + 1] - s.segpre[tid];
      int scan_min = kInf;
      scan_array<RECORD>(p, s, lane_id, tid, cycle, min(n_ready, S), finish,
                         delayed, events, scan_min);
      if (scan_min != kInf) atomicMin(&s.ctr[C_MINFIN], scan_min);
    }
    __syncthreads();

    // ---- advance the clock (every thread, from shared values) --------
    int fu_total = 0, next_fin = min(prev_min, s.ctr[C_MINFIN]);
    for (int i = 0; i < kWarps; ++i) {
      fu_total += s.red[i];
      next_fin = min(next_fin, s.red[kWarps + i]);
    }
    const int mem_add = s.ctr[C_MEM];
    if (err == ERR_NONE && s.ctr[C_UNCONF]) err = ERR_UNCONFIGURED;
    const bool still_ready = total_ready - fu_total - mem_add > 0;
    const bool any_inflight = next_fin != kInf;
    int ncycle = cycle + 1;
    if (!still_ready && any_inflight && next_fin > ncycle) ncycle = next_fin;
    if (err == ERR_NONE && !still_ready && !any_inflight && remaining > 0)
      err = ERR_DEADLOCK;
    cnt[0] += fu_total + mem_add;
    cnt[1] += mem_add;
    cnt[2] += s.ctr[C_BANK];
    cnt[3] += s.ctr[C_PARITY];
    cnt[4] += s.ctr[C_PAIR];
    cnt[5] += s.ctr[C_PR];
    cnt[6] += s.ctr[C_RMW];
    cnt[7] += mem_add > 0;
    cycle = ncycle;
    __syncthreads();     // everyone has read the counters before a reset
  }

  if (tid == 0) {
    p.cycles[lane_id] = cycle;
    p.err[lane_id] = err;
    for (int i = 0; i < 8; ++i) p.cnt[lane_id * 8 + i] = cnt[i];
  }
  for (int i = tid; i < A; i += kThreads) p.per_array[lane_id * A + i] =
      s.arr[i];
}

template <bool RECORD>
int launch(const Params& p, int lanes, cudaStream_t stream) {
  const size_t smem = smem_layout(p, nullptr, nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      cycle_lanes_kernel<RECORD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cycle_lanes_kernel<RECORD><<<lanes, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Schedules L lanes over one trace (see cycle_lanes.py for the layouts).
// All pointers are device pointers; events may be null when record is 0.
// Returns a cudaError_t: cudaErrorInvalidValue for sizes the kernel does
// not take (more than 256 arrays, fewer than one lane, or a shared-memory
// layout beyond the card's 227 KB).
int cycle_lanes_launch(const int* desc, const int* fu_budgets,
                       const int* mem_latency, const int* ppb,
                       const int* max_cycles, const int* direct,
                       const int* offset, const int* parity,
                       const int* preds, const int* lat,
                       const uint8_t* is_load, const int* word_idx,
                       const int* perm, const int* gid_perm,
                       const int* seg_start, int* cycles, int* cnt,
                       int* per_array, int* err, int* maps, int* events,
                       int* finish_ws, uint8_t* delayed_ws, int lanes, int A,
                       int npad, int P, int n_real, int S, int U, int NB,
                       int D, int PP, int record, void* stream) {
  if (lanes < 1) return 0;
  Params p{desc, fu_budgets, mem_latency, ppb, max_cycles, direct, offset,
           parity, preds, lat, is_load, word_idx, perm, gid_perm, seg_start,
           cycles, cnt, per_array, err, maps, record ? events : nullptr,
           finish_ws, delayed_ws, A, npad, P, n_real, S, U, NB, D, PP};
  if (A < 1 || A + 8 > kThreads || n_real > npad || P < 1 || S < 1 ||
      U < 1 || NB < 1 || D < 1 || PP < 1 || (record && events == nullptr) ||
      smem_layout(p, nullptr, nullptr) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch<true>(p, lanes, s) : launch<false>(p, lanes, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
