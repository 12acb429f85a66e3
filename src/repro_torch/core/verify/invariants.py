"""Declarative legality rules, validated over issue-event logs (copy of
the JAX package's ``core/verify/invariants.py``).

Given a :class:`~repro_torch.core.sim.prepared.PreparedTrace`, a
``ScheduleConfig`` and the
:class:`~repro_torch.core.sim.events.EventLog` a backend recorded,
:func:`verify_events` checks every invariant the paper's arbitration
semantics imply:

* **completeness** — every trace op issues exactly once, inside the
  reported cycle horizon;
* **dependence** — no op issues before every predecessor's value is
  available (predecessor issue + effective latency);
* **fu_budget** — at most ``fu_counts[class]`` compute issues per
  class per cycle, occupying distinct unit slots;
* **port_budget / slot_budget** — per-array read/write port budgets,
  plus multipump's pumped total-access cap;
* **slot_collision** — per-cycle per-class issue ordinals are the
  dense sequence 0..m-1 (no two ops share a port slot);
* **path_kind** — each design kind only emits its legal path kinds
  (LVT writes broadcast, remap writes steer, …);
* **bank_conflict** — banked accesses hit ``word % n_banks`` with at
  most ``ports_per_bank`` per bank; remap reads hit the *live* bank;
* **steering** — remap writes land exactly where the first-free-bank
  scan (re-implemented here) says they must;
* **parity_fanout / write_pair** — NTX leaf read-port exclusivity:
  direct reads claim their leaf (+Ref twin), parity reads claim the
  whole ``2**k`` fan-out, same-half write pairs claim the other-tree
  and Ref leaves through the single per-cycle Ref unit;
* **counter** — the ``ScheduleResult`` aggregates (issued counts,
  parity reads, pair RMWs, cycles, memory parallelism) must equal
  what the event log implies.

The implementation is numpy over the event arrays plus a per-cycle
replay for the stateful remap kind; it shares *no* code with
``repro_torch.core.sim.arbiter`` (see
:mod:`repro_torch.core.verify.geometry`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sim.arbiter import STALL_KEYS
from repro_torch.core.sim.events import (PATH_BROADCAST, PATH_COMPUTE,
                                         PATH_DIRECT, PATH_PAIR_RMW,
                                         PATH_PARITY, PATH_STEERED,
                                         PATH_NAMES, EventLog)
from repro_torch.core.sim.prepared import FU_ORDER, PreparedTrace
from repro_torch.core.verify.geometry import (ArrayRules, compile_rules,
                                             leaf_paths)

# every class a violation can carry; the structural-hazard classes are
# exactly the scheduler's stall taxonomy (STALL_KEYS) plus "steering"
# for remap write-placement errors
RULE_CLASSES: tuple[str, ...] = (
    "completeness", "dependence", "fu_budget", "port_budget",
    "slot_budget", "slot_collision", "path_kind", "steering", "counter",
    "static_bound") + STALL_KEYS


@dataclasses.dataclass(frozen=True)
class Violation:
    """One legality violation; ``rule`` is drawn from RULE_CLASSES."""

    rule: str
    detail: str
    node: int = -1
    array: int = -1
    cycle: int = -1

    def __str__(self) -> str:
        loc = []
        if self.node >= 0:
            loc.append(f"node {self.node}")
        if self.array >= 0:
            loc.append(f"array {self.array}")
        if self.cycle >= 0:
            loc.append(f"cycle {self.cycle}")
        where = f" [{', '.join(loc)}]" if loc else ""
        return f"{self.rule}: {self.detail}{where}"


_MAX_PER_RULE = 8          # cap repeated reports of one failure mode


class _Sink:
    def __init__(self) -> None:
        self.violations: "list[Violation]" = []
        self._per_rule: dict[str, int] = {}

    def add(self, rule: str, detail: str, node: int = -1, array: int = -1,
            cycle: int = -1) -> None:
        assert rule in RULE_CLASSES, rule
        seen = self._per_rule.get(rule, 0)
        self._per_rule[rule] = seen + 1
        if seen < _MAX_PER_RULE:
            self.violations.append(Violation(
                rule, detail, node=int(node), array=int(array),
                cycle=int(cycle)))


def _effective_latency(pt: PreparedTrace, mem_latency: int) -> np.ndarray:
    """Issue-to-result cycles per node: loads take ``mem_latency``,
    everything else its trace latency (stores 1, FU per class)."""
    return np.where(pt.is_load_np.astype(bool), np.int64(mem_latency),
                    pt.latency_np)


def verify_events(pt: PreparedTrace, cfg, res, events: EventLog,
                  ) -> "list[Violation]":
    """Validate one schedule's event log; returns all violations found."""
    sink = _Sink()
    n = pt.trace.n_nodes
    n_arrays = pt.n_arrays
    cyc = events.cycle
    path = events.path
    resr = events.resource
    slot = events.slot

    if events.n_nodes != n:
        sink.add("completeness",
                 f"event log has {events.n_nodes} entries, trace has {n}")
        return sink.violations
    if n == 0:
        if res.cycles != 0 or res.issued != 0 or res.mem_issued != 0:
            sink.add("counter", "empty trace with nonzero result counters")
        return sink.violations

    lat_eff = _effective_latency(pt, cfg.mem_latency)
    issued_ok = cyc >= 0

    # ---- completeness: every op issues exactly once, inside the horizon
    for node in np.flatnonzero(~issued_ok)[:_MAX_PER_RULE]:
        sink.add("completeness", "op never issued", node=node)
    finish = np.where(issued_ok, cyc + lat_eff, -1)
    horizon_bad = issued_ok & (finish > res.cycles - 1)
    for node in np.flatnonzero(horizon_bad)[:_MAX_PER_RULE]:
        sink.add("completeness",
                 f"op finishes at {int(finish[node])} beyond the reported "
                 f"{res.cycles}-cycle schedule", node=node,
                 cycle=int(cyc[node]))

    # ---- dependence: issue[s] >= issue[p] + effective_latency[p]
    succ_counts = np.diff(pt.succ_ptr)
    src = np.repeat(np.arange(n, dtype=np.int64), succ_counts)
    dst = pt.succ_idx
    edge_ok = issued_ok[src] & issued_ok[dst]
    viol = edge_ok & (cyc[dst] < cyc[src] + lat_eff[src])
    for e in np.flatnonzero(viol)[:_MAX_PER_RULE]:
        sink.add("dependence",
                 f"op issued at {int(cyc[dst[e]])} but its producer "
                 f"{int(src[e])} (issued {int(cyc[src[e]])}, latency "
                 f"{int(lat_eff[src[e]])}) was not complete",
                 node=int(dst[e]), cycle=int(cyc[dst[e]]))

    klass = pt.klass_np
    is_mem = klass < n_arrays
    # ---- path-kind sanity: compute <-> PATH_COMPUTE, memory never
    for node in np.flatnonzero(
            issued_ok & ~is_mem & (path != PATH_COMPUTE))[:_MAX_PER_RULE]:
        sink.add("path_kind", "compute op with a memory path kind",
                 node=node, cycle=int(cyc[node]))
    for node in np.flatnonzero(
            issued_ok & is_mem & (path == PATH_COMPUTE))[:_MAX_PER_RULE]:
        sink.add("path_kind", "memory op recorded as compute",
                 node=node, cycle=int(cyc[node]))

    # ---- FU budgets + slot uniqueness per (class, cycle)
    for f, name in enumerate(FU_ORDER):
        budget = cfg.fu_counts.get(name, 1)
        sel = issued_ok & (klass == n_arrays + f)
        if not sel.any():
            continue
        _check_slots(sink, np.flatnonzero(sel), cyc, slot, budget,
                     "fu_budget", f"FU class {name!r}", array=-1)

    # ---- per-array invariants
    rules: "list[ArrayRules | None]" = [None] * n_arrays
    for aid in range(n_arrays):
        spec = cfg.mem.get(aid)
        if spec is not None:
            rules[aid] = compile_rules(spec, cfg.ports_per_bank)
    word = pt.word_index_np
    is_load = pt.is_load_np.astype(bool)
    for aid in range(n_arrays):
        nodes = np.flatnonzero(issued_ok & (klass == aid))
        if nodes.size == 0:
            continue
        r = rules[aid]
        if r is None:
            sink.add("completeness",
                     "memory ops issued on an array with no AMMSpec",
                     node=int(nodes[0]), array=aid)
            continue
        _check_array(sink, aid, r, nodes, cyc, path, resr, slot, word,
                     is_load, cfg.ports_per_bank)

    # ---- result-counter reconciliation
    _check_counters(sink, pt, res, events, issued_ok, is_mem, finish)
    return sink.violations


def _check_slots(sink: _Sink, nodes: np.ndarray, cyc, slot, budget: int,
                 rule: str, what: str, array: int) -> None:
    """Per-cycle issue count <= budget and slots are dense 0..m-1."""
    cycles = cyc[nodes]
    slots = slot[nodes]
    order = np.lexsort((slots, cycles))
    cycles, slots, nodes = cycles[order], slots[order], nodes[order]
    boundaries = np.flatnonzero(np.diff(cycles)) + 1
    for grp, sl, nd in zip(np.split(cycles, boundaries),
                           np.split(slots, boundaries),
                           np.split(nodes, boundaries)):
        c = int(grp[0])
        if grp.size > budget:
            sink.add(rule,
                     f"{what}: {grp.size} issues in one cycle exceeds the "
                     f"budget of {budget}", node=int(nd[0]), array=array,
                     cycle=c)
        if not np.array_equal(sl, np.arange(grp.size)):
            sink.add("slot_collision",
                     f"{what}: issue slots {sl.tolist()} are not the dense "
                     f"sequence 0..{grp.size - 1}", node=int(nd[0]),
                     array=array, cycle=c)


def _check_array(sink: _Sink, aid: int, r: ArrayRules, nodes: np.ndarray,
                 cyc, path, resr, slot, word, is_load,
                 ports_per_bank: int) -> None:
    cycles = cyc[nodes]
    paths = path[nodes]
    ress = resr[nodes]
    slots = slot[nodes]
    loads = is_load[nodes]
    addrs = word[nodes] % r.depth

    # ---- per-direction port budgets (every kind)
    for sel, budget, what in ((loads, r.rd, "reads"),
                              (~loads, r.wr, "writes")):
        if not sel.any():
            continue
        cnt = np.bincount(cycles[sel])
        over = np.flatnonzero(cnt > budget)
        for c in over[:_MAX_PER_RULE]:
            nd = nodes[sel & (cycles == c)][0]
            sink.add("port_budget",
                     f"{int(cnt[c])} {what} in one cycle exceeds the "
                     f"{budget}-port budget", node=int(nd), array=aid,
                     cycle=int(c))

    # ---- slot density over the whole class (reads+writes share slots)
    _check_slots(sink, nodes, cyc, slot,
                 budget=r.rd + r.wr if r.slot_cap is None
                 else min(r.rd + r.wr, r.slot_cap),
                 rule="port_budget", what=f"array {aid}", array=aid)

    # ---- multipump pumped-slot accounting
    if r.slot_cap is not None:
        cnt = np.bincount(cycles)
        for c in np.flatnonzero(cnt > r.slot_cap)[:_MAX_PER_RULE]:
            nd = nodes[cycles == c][0]
            sink.add("slot_budget",
                     f"{int(cnt[c])} pumped accesses in one external cycle "
                     f"exceed {r.slot_cap} internal slots", node=int(nd),
                     array=aid, cycle=int(c))

    # ---- legal path kinds per design kind
    if r.is_ntx:
        legal_rd = (PATH_DIRECT, PATH_PARITY)
        legal_wr = (PATH_DIRECT,) if not r.has_ref \
            else (PATH_DIRECT, PATH_PAIR_RMW)
    elif r.kind == "remap":
        legal_rd, legal_wr = (PATH_DIRECT,), (PATH_STEERED,)
    elif r.lvt_broadcast:
        legal_rd, legal_wr = (PATH_DIRECT,), (PATH_BROADCAST,)
    else:
        legal_rd, legal_wr = (PATH_DIRECT,), (PATH_DIRECT,)
    bad = np.where(loads, ~np.isin(paths, legal_rd),
                   ~np.isin(paths, legal_wr))
    for i in np.flatnonzero(bad)[:_MAX_PER_RULE]:
        side = "read" if loads[i] else "write"
        sink.add("path_kind",
                 f"{r.kind} {side} took path "
                 f"{PATH_NAMES.get(int(paths[i]), '?')}",
                 node=int(nodes[i]), array=aid, cycle=int(cycles[i]))

    if r.kind == "banked":
        _check_banked(sink, aid, r, nodes, cycles, ress, addrs,
                      ports_per_bank)
    elif r.kind == "remap":
        _check_remap(sink, aid, r, nodes, cycles, slots, ress, addrs,
                     loads, ports_per_bank)
    elif r.is_ntx:
        _check_ntx(sink, aid, r, nodes, cycles, paths, ress, addrs, loads)


def _check_banked(sink, aid, r: ArrayRules, nodes, cycles, ress, addrs,
                  ports_per_bank: int) -> None:
    banks = addrs % r.n_banks
    wrong = ress != banks
    for i in np.flatnonzero(wrong)[:_MAX_PER_RULE]:
        sink.add("bank_conflict",
                 f"access to word {int(addrs[i])} served by bank "
                 f"{int(ress[i])}, but words interleave to bank "
                 f"{int(banks[i])}", node=int(nodes[i]), array=aid,
                 cycle=int(cycles[i]))
    # <= ports_per_bank accesses per (cycle, bank)
    key = cycles * r.n_banks + banks
    uniq, cnt = np.unique(key, return_counts=True)
    for kky in uniq[cnt > ports_per_bank][:_MAX_PER_RULE]:
        c, b = divmod(int(kky), r.n_banks)
        nd = nodes[key == kky][0]
        sink.add("bank_conflict",
                 f"bank {b} served {int(cnt[uniq == kky][0])} accesses in "
                 f"one cycle (dual-port macro allows {ports_per_bank})",
                 node=int(nd), array=aid, cycle=c)


def _check_remap(sink, aid, r: ArrayRules, nodes, cycles, slots, ress,
                 addrs, loads, ports_per_bank: int) -> None:
    """Ordered replay of the remap steering invariants.

    The live map mutates as writes issue, so per-cycle legality depends
    on within-cycle order — the recorded issue slots provide it.  The
    scan rule is re-implemented from the spec (first bank from the
    word's live bank with no write yet and a read port left), not
    imported from the arbiter.
    """
    nb = r.n_banks
    live = [0] * r.depth              # banks start compacted at bank 0
    order = np.lexsort((slots, cycles))
    ruse = [0] * nb
    wuse = [0] * nb
    cur_cycle = -1
    for i in order:
        c = int(cycles[i])
        if c != cur_cycle:
            ruse = [0] * nb
            wuse = [0] * nb
            cur_cycle = c
        a = int(addrs[i])
        got = int(ress[i])
        if loads[i]:
            want = live[a]
            if got != want:
                sink.add("bank_conflict",
                         f"read of word {a} served by bank {got}, but the "
                         f"live map holds it in bank {want}",
                         node=int(nodes[i]), array=aid, cycle=c)
                continue
        else:
            want = -1
            for j in range(nb):
                b = (live[a] + j) % nb
                if not wuse[b] and ruse[b] < ports_per_bank:
                    want = b
                    break
            if got != want:
                sink.add("steering",
                         f"write of word {a} steered to bank {got}; the "
                         f"first conflict-free bank scanning from "
                         f"{live[a]} is {want}", node=int(nodes[i]),
                         array=aid, cycle=c)
                if not 0 <= got < nb:
                    continue
            if wuse[got]:
                sink.add("bank_conflict",
                         f"two live writes share bank {got} in one cycle",
                         node=int(nodes[i]), array=aid, cycle=c)
            wuse[got] = 1
            live[a] = got
        ruse[got] += 1
        if ruse[got] > ports_per_bank:
            sink.add("bank_conflict",
                     f"bank {got} served {ruse[got]} accesses in one cycle "
                     f"(ports_per_bank={ports_per_bank})",
                     node=int(nodes[i]), array=aid, cycle=c)


def _check_ntx(sink, aid, r: ArrayRules, nodes, cycles, paths, ress,
               addrs, loads) -> None:
    """Leaf read-port exclusivity + write-pair (Ref unit) accounting."""
    geo = leaf_paths(r.tree_depth, r.k)
    trees = np.where(addrs >= r.half, 1, 0) if r.has_ref \
        else np.zeros(addrs.shape, np.int64)
    tas = addrs - trees * r.half

    # collect every (cycle, leaf-port key) claim; pair claims are
    # tagged so a duplicate involving one classifies as write_pair
    claim_cycle: "list[int]" = []
    claim_key: "list[int]" = []
    claim_pair: "list[bool]" = []
    claim_node: "list[int]" = []

    def claim(c, key, is_pair, node):
        claim_cycle.append(c)
        claim_key.append(key)
        claim_pair.append(is_pair)
        claim_node.append(node)

    pair_by_cycle: dict[int, int] = {}
    writes_by_cycle_half: dict[tuple[int, int], list[int]] = {}

    for i in range(nodes.shape[0]):
        c = int(cycles[i])
        node = int(nodes[i])
        tree = int(trees[i])
        direct, off, parity = geo[int(tas[i])]
        s = off % r.sub
        p = int(paths[i])
        if loads[i]:
            if p == PATH_DIRECT:
                want = r.key(tree, direct, s)
                if int(ress[i]) != want:
                    sink.add("parity_fanout",
                             f"direct read of word {int(addrs[i])} "
                             f"recorded leaf port {int(ress[i])}, its "
                             f"direct leaf is port {want}", node=node,
                             array=aid, cycle=c)
                claim(c, want, False, node)
                if r.has_ref:
                    claim(c, r.key(2, direct, s), False, node)
            elif p == PATH_PARITY:
                for pl in parity:
                    claim(c, r.key(tree, pl, s), False, node)
                    if r.has_ref:
                        claim(c, r.key(2, pl, s), False, node)
        else:
            if p == PATH_PAIR_RMW:
                pair_by_cycle[c] = pair_by_cycle.get(c, 0) + 1
                if pair_by_cycle[c] > 1:
                    sink.add("write_pair",
                             "two Ref re-pointing flows in one cycle "
                             "(the RMW unit is single)", node=node,
                             array=aid, cycle=c)
                claim(c, r.key(1 - tree, direct, s), True, node)
                claim(c, r.key(2, direct, s), True, node)
            if r.has_ref:
                writes_by_cycle_half.setdefault((c, tree), []).append(i)

    # ---- same-half write pairing: 2nd write per half must be the pair
    for (c, tree), idxs in writes_by_cycle_half.items():
        n_pair = sum(1 for i in idxs if paths[i] == PATH_PAIR_RMW)
        if len(idxs) > 2:
            sink.add("write_pair",
                     f"{len(idxs)} writes into one address half in one "
                     "cycle (a half takes a plain write plus one pair "
                     "RMW)", node=int(nodes[idxs[0]]), array=aid, cycle=c)
        if n_pair != max(len(idxs) - 1, 0):
            sink.add("write_pair",
                     f"{len(idxs)} same-half writes recorded {n_pair} "
                     f"pair RMWs (expected {max(len(idxs) - 1, 0)})",
                     node=int(nodes[idxs[0]]), array=aid, cycle=c)

    # ---- leaf-port exclusivity: each (cycle, key) claimed at most once
    if claim_key:
        ck = np.asarray(claim_cycle, np.int64) * (3 * r.n_leaves * r.sub) \
            + np.asarray(claim_key, np.int64)
        pair_f = np.asarray(claim_pair, bool)
        node_f = np.asarray(claim_node, np.int64)
        uniq, inv, cnt = np.unique(ck, return_inverse=True,
                                   return_counts=True)
        dup = np.flatnonzero(cnt[inv] > 1)
        seen: set[int] = set()
        for i in dup:
            g = int(inv[i])
            if g in seen:
                continue
            seen.add(g)
            members = np.flatnonzero(inv == g)
            rule = "write_pair" if pair_f[members].any() else \
                "parity_fanout"
            c = claim_cycle[int(members[0])]
            sink.add(rule,
                     f"leaf port {claim_key[int(members[0])]} claimed "
                     f"{members.size} times in one cycle by nodes "
                     f"{sorted(set(int(node_f[m]) for m in members))}",
                     node=int(node_f[members[0]]), array=aid, cycle=c)
            if len(seen) >= _MAX_PER_RULE:
                break


def _check_counters(sink: _Sink, pt: PreparedTrace, res, events: EventLog,
                    issued_ok, is_mem, finish) -> None:
    n = pt.trace.n_nodes
    cyc = events.cycle
    path = events.path
    mem_ev = issued_ok & is_mem
    checks = [
        ("issued", res.issued, int(issued_ok.sum())),
        ("mem_issued", res.mem_issued, int(mem_ev.sum())),
        ("parity_path_reads", res.parity_path_reads,
         int((mem_ev & (path == PATH_PARITY)).sum())),
        ("write_pair_rmws", res.write_pair_rmws,
         int((mem_ev & (path == PATH_PAIR_RMW)).sum())),
    ]
    expected_cycles = int(finish.max()) + 1 if n else 0
    checks.append(("cycles", res.cycles, expected_cycles))
    for aid, got in res.per_array_accesses.items():
        checks.append((f"per_array_accesses[{aid}]", got,
                       int((mem_ev & (pt.klass_np == aid)).sum())))
    for name, got, want in checks:
        if got != want:
            sink.add("counter",
                     f"result reports {name}={got}, the event log implies "
                     f"{want}")
    mem_cycles = np.unique(cyc[mem_ev]).size
    want_par = int(mem_ev.sum()) / max(mem_cycles, 1)
    if abs(res.avg_mem_parallelism - want_par) > 1e-9:
        sink.add("counter",
                 f"result reports avg_mem_parallelism="
                 f"{res.avg_mem_parallelism:.6f}, the event log implies "
                 f"{want_par:.6f}")
