"""Static hazard certificates: provable cycle lower bounds (copy of
the JAX package's ``core/verify/static_bounds.py``).

Each bound is derived from the trace + config alone (no simulation) and
is *sound*: no legal schedule under the paper's arbitration semantics
can finish in fewer cycles.  The schedulers' measured ``cycles`` must
therefore satisfy ``cycles >= max(bounds)`` — a measured count below
any bound is a scheduler bug (or a checker bug), and
:func:`check_bounds` reports it as a ``static_bound`` violation.

All bounds use the repo-wide convention ``cycles == last finish + 1``:
an op stream of ``m`` accesses through a throughput-``t`` resource
issues its last op no earlier than cycle ``ceil(m/t) - 1``, which
finishes ``lmin`` cycles later (``lmin`` = the smallest latency among
those ops), so ``cycles >= ceil(m/t) + lmin``.

Bound kinds:

* ``critical_path`` — longest dependence chain (loads weighted at
  ``mem_latency``, other ops at their FU/store latency), plus one.
* ``port_pressure`` — per-array read/write port throughput, the
  multipump pumped-slot cap, and per-class FU counts.
* ``bank_conflict`` — banked: the fullest ``word % n_banks`` residue
  class through ``ports_per_bank`` macro ports; remap: the most-read
  single word (all live reads of a word target one bank per cycle).
* ``parity_pressure`` — NTX: a single address serves at most two reads
  per cycle (direct + one parity reconstruction; one when ``k == 0``),
  a (tree, sub-bank) group at most ``3**k`` reads per cycle (each read
  claims at least one leaf port), and a B/HB address half at most two
  stores per cycle (a plain write plus the single pair RMW).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sim.prepared import FU_ORDER, PreparedTrace
from repro_torch.core.verify.geometry import compile_rules

BOUND_KINDS: tuple[str, ...] = ("critical_path", "port_pressure",
                                "bank_conflict", "parity_pressure")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _lat_eff(pt: PreparedTrace, mem_latency: int) -> np.ndarray:
    return np.where(pt.is_load_np.astype(bool), np.int64(mem_latency),
                    pt.latency_np)


def _critical_path(pt: PreparedTrace, mem_latency: int) -> int:
    """Longest-finish chain + 1.  Node ids are already topologically
    ordered (trace deps always reference earlier nodes), so one forward
    pass over the predecessor CSR suffices."""
    n = pt.trace.n_nodes
    if n == 0:
        return 0
    lat = _lat_eff(pt, mem_latency).tolist()
    pp = pt.trace.pred_ptr.tolist()
    pi = pt.trace.pred_idx.tolist()
    finish = [0] * n
    best = 0
    for v in range(n):
        start = 0
        for e in range(pp[v], pp[v + 1]):
            f = finish[pi[e]]
            if f > start:
                start = f
        fv = start + lat[v]
        finish[v] = fv
        if fv > best:
            best = fv
    return best + 1


def _throughput_bound(count: int, per_cycle: int, lmin: int) -> int:
    if count == 0:
        return 0
    return _ceil_div(count, max(per_cycle, 1)) + lmin


def static_bounds(pt: PreparedTrace, cfg) -> "dict[str, int]":
    """Compute every lower-bound kind for one (trace, config) pair."""
    n_arrays = pt.n_arrays
    klass = pt.klass_np
    is_load = pt.is_load_np.astype(bool)
    word = pt.word_index_np
    ml = cfg.mem_latency

    bounds = {k: 0 for k in BOUND_KINDS}
    bounds["critical_path"] = _critical_path(pt, ml)

    # ---- FU classes under port_pressure
    for f, name in enumerate(FU_ORDER):
        sel = klass == n_arrays + f
        cnt = int(sel.sum())
        if cnt:
            lmin = int(pt.latency_np[sel].min())
            bounds["port_pressure"] = max(
                bounds["port_pressure"],
                _throughput_bound(cnt, cfg.fu_counts.get(name, 1), lmin))

    for aid in range(n_arrays):
        spec = cfg.mem.get(aid)
        sel = klass == aid
        if spec is None or not sel.any():
            continue
        r = compile_rules(spec, cfg.ports_per_bank)
        loads = sel & is_load
        stores = sel & ~is_load
        n_l, n_s = int(loads.sum()), int(stores.sum())
        addrs = word[sel] % r.depth

        # ---- advertised read/write port throughput
        pp = max(_throughput_bound(n_l, r.rd, ml),
                 _throughput_bound(n_s, r.wr, 1))
        if r.slot_cap is not None:      # multipump shares pumped slots
            lmin = ml if n_l and (not n_s or ml < 1) else 1
            pp = max(pp, _throughput_bound(n_l + n_s, r.slot_cap, lmin))
        bounds["port_pressure"] = max(bounds["port_pressure"], pp)

        if r.kind == "banked":
            residues = addrs % r.n_banks
            lat_a = np.where(is_load[sel], ml, 1)
            for b in np.unique(residues):
                in_b = residues == b
                bounds["bank_conflict"] = max(
                    bounds["bank_conflict"],
                    _throughput_bound(int(in_b.sum()), cfg.ports_per_bank,
                                      int(lat_a[in_b].min())))
        elif r.kind == "remap":
            la = word[loads] % r.depth
            if la.size:
                # every live read of a word targets one bank that cycle
                top = int(np.bincount(la).max())
                bounds["bank_conflict"] = max(
                    bounds["bank_conflict"],
                    _throughput_bound(top, cfg.ports_per_bank, ml))
        elif r.is_ntx:
            la = word[loads] % r.depth
            if la.size:
                # one address: direct leaf + at most one parity rebuild
                cap = 2 if r.k > 0 else 1
                top = int(np.bincount(la).max())
                bounds["parity_pressure"] = max(
                    bounds["parity_pressure"],
                    _throughput_bound(top, cap, ml))
                # one (tree, sub-bank) group has 3**k leaf ports and
                # every read claims at least one of them
                trees = np.where(la >= r.half, 1, 0) if r.has_ref else \
                    np.zeros(la.shape, np.int64)
                tas = la - trees * r.half
                # leaf offset after k halvings is addr mod (depth >> k)
                span = max(r.tree_depth >> r.k, 1)
                subs = (tas % span) % r.sub
                grp = trees * r.sub + subs
                for g in np.unique(grp):
                    bounds["parity_pressure"] = max(
                        bounds["parity_pressure"],
                        _throughput_bound(int((grp == g).sum()),
                                          r.n_leaves, ml))
            if r.has_ref and n_s:
                sa = word[stores] % r.depth
                halves = np.where(sa >= r.half, 1, 0)
                for h in (0, 1):
                    cnt = int((halves == h).sum())
                    # per half: one plain write + the single pair RMW
                    bounds["parity_pressure"] = max(
                        bounds["parity_pressure"],
                        _throughput_bound(cnt, 2, 1))
    return bounds


def check_bounds(pt: PreparedTrace, cfg, cycles: int
                 ) -> "list[tuple[str, int]]":
    """Return the (kind, bound) pairs a measured cycle count violates."""
    return [(k, b) for k, b in static_bounds(pt, cfg).items()
            if cycles < b]
