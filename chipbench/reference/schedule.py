"""The reference's port-constrained list scheduler, in plain Python.

Semantics (the paper's cycle-accurate simulator, Sec. III-C): each
cycle, nodes whose predecessors have all finished retire into their
resource class's ready set (a memory op's class is its array, a compute
op's its functional-unit kind); each class then issues from its ready
set in priority order (longest latency-weighted path to a sink first,
then node id) under its per-cycle rules:

* a functional-unit class issues up to its unit count;
* an array issues up to its read and write ports, subject to its
  memory's structure: ``banked`` serialises accesses that share a bank
  (two ports a bank), ``multipump`` shares its pumped slots, the NTX
  kinds give a read its direct leaf or else its whole parity path and
  pair same-half writes through one re-pointing unit, ``remap`` reads
  the live bank and steers writes to a free one;
* a candidate that cannot issue is skipped; at most ``max_failed``
  skips a cycle; a node's first skip for a structural conflict is one
  stall of that cause.

A load finishes ``mem_latency`` cycles after it issues, anything else
after its op latency.  Cycles in which nothing can issue are jumped.

The ready set of a class is a sorted list scanned front to back, where
the program keeps heaps: the decisions are the same, the code is not.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq

import numpy as np

from chipbench.reference import model as M
from chipbench.reference.trace import FU_OF_KIND, FU_ORDER, LATENCY, LOAD, \
    STORE, Trace

STALL_CAUSES = ("bank_conflict", "parity_fanout", "write_pair")
_BANK, _PARITY, _PAIR = 0, 1, 2


@dataclasses.dataclass
class Prepared:
    """What the loop needs of one trace, built once for every lane."""
    name: str
    n: int
    n_arrays: int
    array_ids: list           # trace order
    word_bytes: list          # bytes a word, by array id
    depths: list              # power-of-two words, by array id
    loads: list               # loads, by array id
    stores: list              # stores, by array id
    succ: list                # successor ids, by node
    indegree: list
    prio: list                # -height * n + node: smaller issues first
    klass: list               # resource class, by node
    is_load: list
    latency: list             # op latency (a load's is the lane's)
    word: list                # word index, -1 for compute ops


def prepare(tr: Trace) -> Prepared:
    n = tr.n_nodes
    kinds = tr.kinds.astype(np.int64)
    pred_ptr, pred_idx = tr.pred_ptr, tr.pred_idx
    counts = (pred_ptr[1:] - pred_ptr[:-1]).astype(np.int64)
    succ: list = [[] for _ in range(n)]
    dst = np.repeat(np.arange(n, dtype=np.int64), counts)
    for p, d in zip(pred_idx.tolist(), dst.tolist()):
        succ[p].append(d)
    lat = [LATENCY[k] for k in kinds.tolist()]
    height = [0] * n
    for i in range(n - 1, -1, -1):        # successors have larger ids
        s = succ[i]
        if s:
            height[i] = max(height[j] for j in s) + lat[i]
    n_arrays = max(tr.array_names) + 1 if tr.array_names else 0
    mem = kinds <= STORE
    word = np.full(n, -1, np.int64)
    for aid, wb in tr.word_bytes.items():
        sel = mem & (tr.array_ids == aid)
        word[sel] = tr.addrs[sel] // wb
    depths, loads, stores = [16] * n_arrays, [0] * n_arrays, [0] * n_arrays
    for aid in tr.array_names:
        sel = mem & (tr.array_ids == aid)
        if sel.any():
            depths[aid] = max(16, 1 << (int(word[sel].max()) + 1)
                              .bit_length())
        loads[aid] = int(np.sum(sel & (kinds == LOAD)))
        stores[aid] = int(np.sum(sel & (kinds == STORE)))
    fu_class = {k: n_arrays + FU_ORDER.index(v) for k, v in FU_OF_KIND.items()}
    klass = [int(a) if k <= STORE else fu_class[k]
             for k, a in zip(kinds.tolist(), tr.array_ids.tolist())]
    wb = [tr.word_bytes.get(a, 0) for a in range(n_arrays)]
    return Prepared(name=tr.name, n=n, n_arrays=n_arrays,
                    array_ids=list(tr.array_names), word_bytes=wb,
                    depths=depths, loads=loads, stores=stores, succ=succ,
                    indegree=counts.tolist(),
                    prio=[-h * n + i for i, h in enumerate(height)],
                    klass=klass, is_load=(kinds == LOAD).tolist(),
                    latency=lat, word=word.tolist())


def lane_mems(pp: Prepared, kind: str, n_read: int, n_write: int,
              n_banks: int) -> "list[M.Mem]":
    """Each array's memory under one design, in trace order."""
    return [M.array_mem(kind, n_read, n_write, n_banks, pp.depths[a],
                        pp.word_bytes[a] * 8) for a in pp.array_ids]


def _ntx_masks(pp: Prepared, aid: int, d: M.Arb):
    """Per node of array ``aid``: the port-key bit masks of its direct
    read, its parity read and (B/HB-NTX) its paired write, and its
    address half."""
    direct, offset, parity = M.ntx_paths(d.tree_depth, d.levels)
    direct, offset, parity = direct.tolist(), offset.tolist(), \
        parity.tolist()
    h = d.kind == M.K_H_NTX

    def bit(tree, leaf, s):
        return 1 << ((tree * d.n_leaves + leaf) * d.sub + s)

    out = {}
    for node in range(pp.n):
        if pp.klass[node] != aid:
            continue
        a = pp.word[node] % d.depth
        tree = 0 if h or a < d.half else 1
        ta = a - (d.half if tree else 0)
        leaf, s = direct[ta], offset[ta] % d.sub
        dm = bit(tree, leaf, s) | (0 if h else bit(2, leaf, s))
        pm = 0
        for pl in parity[ta]:
            pm |= bit(tree, pl, s) | (0 if h else bit(2, pl, s))
        wm = 0 if h else bit(1 - tree, leaf, s) | bit(2, leaf, s)
        out[node] = (dm, pm, wm, tree)
    return out


def schedule(pp: Prepared, arbs: "list[M.Arb]", fu_budgets: "list[int]",
             mem_latency: int, ports_per_bank: int = 2,
             max_cycles: int = 50_000_000) -> dict:
    """One lane: ``arbs`` holds each array's arbitration (trace order).
    Returns the cycles, the issue counts, the stalls by cause and the
    average accesses in a cycle with any."""
    n, na = pp.n, pp.n_arrays
    succ, prio, klass = pp.succ, pp.prio, pp.klass
    is_load, lat, word = pp.is_load, pp.latency, pp.word
    ppb = ports_per_bank
    arb_of = [None] * na
    for aid, d in zip(pp.array_ids, arbs):
        arb_of[aid] = d
    masks = [None] * na
    remap_map = [None] * na
    for aid, d in enumerate(arb_of):
        if d is not None and d.kind in M.NTX:
            masks[aid] = _ntx_masks(pp, aid, d)
        elif d is not None and d.kind == M.K_REMAP:
            remap_map[aid] = [0] * d.depth

    ready = [[] for _ in range(na + len(FU_ORDER))]
    pending = list(pp.indegree)
    for i in range(n):
        if pending[i] == 0:
            ready[klass[i]].append(prio[i])
    for r in ready:
        r.sort()
    active = {c for c, r in enumerate(ready) if r}
    inflight: list = []                     # finish * n + node
    delayed = bytearray(n)
    stalls = [0, 0, 0]
    issued = mem_issued = mem_cycles = 0
    parity_reads = pair_rmws = 0
    remaining, cycle = n, 0

    while remaining > 0:
        if cycle > max_cycles:
            raise RuntimeError(f"scheduler exceeded {max_cycles} cycles")
        limit = cycle * n + n - 1           # finishes at or before cycle
        while inflight and inflight[0] <= limit:
            node = heapq.heappop(inflight) % n
            remaining -= 1
            for s in succ[node]:
                pending[s] -= 1
                if pending[s] == 0:
                    c = klass[s]
                    bisect.insort(ready[c], prio[s])
                    active.add(c)

        mem_now = 0
        for c in list(active):
            lst = ready[c]
            if c >= na:                     # functional units
                take = lst[:fu_budgets[c - na]]
                for item in take:
                    node = item % n
                    heapq.heappush(inflight, (cycle + lat[node]) * n + node)
                del lst[:len(take)]
                issued += len(take)
                if not lst:
                    active.discard(c)
                continue
            d = arb_of[c]
            if d is None:
                raise KeyError(f"memory op on array {c} with no design")
            rd, wr, max_failed = d.rd, d.wr, d.max_failed
            kind = d.kind
            failed = 0
            took = []
            L = len(lst)
            i = 0
            if kind == M.K_BANKED:
                nb = d.n_banks
                use = [0] * nb
                saturated = 0
                while i < L and (rd > 0 or wr > 0):
                    if saturated >= nb or failed >= max_failed:
                        break
                    node = lst[i] % n
                    ld = is_load[node]
                    if (rd if ld else wr) <= 0:
                        failed += 1
                        i += 1
                        continue
                    b = word[node] % nb
                    if use[b] >= ppb:
                        if not delayed[node]:
                            delayed[node] = 1
                            stalls[_BANK] += 1
                        failed += 1
                        i += 1
                        continue
                    use[b] += 1
                    if use[b] == ppb:
                        saturated += 1
                    took.append(i)
                    if ld:
                        rd -= 1
                    else:
                        wr -= 1
                    i += 1
            elif kind in M.NTX:
                mk = masks[c]
                use = 0
                wr_half = [0, 0]
                pair_used = False
                while i < L and (rd > 0 or wr > 0):
                    if failed >= max_failed:
                        break
                    node = lst[i] % n
                    ld = is_load[node]
                    if (rd if ld else wr) <= 0:
                        failed += 1
                        i += 1
                        continue
                    dm, pm, wm, tree = mk[node]
                    cause = -1
                    if ld:
                        if not use & dm:
                            use |= dm
                        elif not use & pm:
                            use |= pm
                            parity_reads += 1
                        else:
                            cause = _PARITY
                    elif kind != M.K_H_NTX:
                        if wr_half[tree] == 0:
                            wr_half[tree] = 1
                        elif pair_used or use & wm:
                            cause = _PAIR
                        else:
                            use |= wm
                            pair_used = True
                            wr_half[tree] += 1
                            pair_rmws += 1
                    if cause >= 0:
                        if not delayed[node]:
                            delayed[node] = 1
                            stalls[cause] += 1
                        failed += 1
                        i += 1
                        continue
                    took.append(i)
                    if ld:
                        rd -= 1
                    else:
                        wr -= 1
                    i += 1
            elif kind == M.K_REMAP:
                live = remap_map[c]
                nb = d.n_banks
                ruse = [0] * nb
                wuse = [0] * nb
                while i < L and (rd > 0 or wr > 0):
                    if failed >= max_failed:
                        break
                    node = lst[i] % n
                    ld = is_load[node]
                    if (rd if ld else wr) <= 0:
                        failed += 1
                        i += 1
                        continue
                    a = word[node] % d.depth
                    ok = False
                    if ld:
                        b = live[a]
                        if ruse[b] < ppb:
                            ruse[b] += 1
                            ok = True
                    else:
                        for j in range(nb):
                            b = (live[a] + j) % nb
                            if not wuse[b] and ruse[b] < ppb:
                                wuse[b] = 1
                                ruse[b] += 1
                                live[a] = b
                                ok = True
                                break
                    if not ok:
                        if not delayed[node]:
                            delayed[node] = 1
                            stalls[_BANK] += 1
                        failed += 1
                        i += 1
                        continue
                    took.append(i)
                    if ld:
                        rd -= 1
                    else:
                        wr -= 1
                    i += 1
            else:                           # ideal, multipump, lvt
                slots = d.slots
                while i < L and (rd > 0 or wr > 0) and slots > 0:
                    if failed >= max_failed:
                        break
                    node = lst[i] % n
                    ld = is_load[node]
                    if (rd if ld else wr) <= 0:
                        failed += 1
                        i += 1
                        continue
                    took.append(i)
                    slots -= 1
                    if ld:
                        rd -= 1
                    else:
                        wr -= 1
                    i += 1
            for i in reversed(took):
                node = lst.pop(i) % n
                done = cycle + (mem_latency if is_load[node] else lat[node])
                heapq.heappush(inflight, done * n + node)
            issued += len(took)
            mem_issued += len(took)
            mem_now += len(took)
            if not lst:
                active.discard(c)
        if mem_now:
            mem_cycles += 1

        cycle += 1
        if not active:
            if not inflight:
                if remaining > 0:
                    raise RuntimeError("deadlock: nodes remain but nothing "
                                       "is ready or in flight")
            elif inflight[0] // n > cycle:
                cycle = inflight[0] // n    # jump the idle cycles

    out = {"cycles": cycle, "issued": issued, "mem_issued": mem_issued,
           "avg_mem_parallelism": mem_issued / max(mem_cycles, 1),
           "parity_path_reads": parity_reads, "write_pair_rmws": pair_rmws}
    out.update({f"{k}_stalls": v for k, v in zip(STALL_CAUSES, stalls)})
    return out
