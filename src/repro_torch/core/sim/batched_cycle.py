"""Batched timing backend: every design lane of a DSE grid in one
``cycle_lanes`` call (the port of the JAX package's
``core/sim/jax_cycle.py``).

The port-constrained list scheduler is evaluated for many designs over
the *same* trace at once: ``schedule_batched`` builds the same per-lane
inputs as the reference (descriptor rows and FU budgets, with the
limits padded to power-of-two buckets; the kernel computes each NTX
word's leaf paths from its array's descriptor row, so no per-word table
is built), moves them and the trace's ``DeviceViews`` to the device
once, makes one
:func:`repro_torch.kernels.ops.cycle_lanes` call — on the card one
kernel launch, one CTA per lane — and folds the results into
:class:`ScheduleResult`/:class:`EventLog` exactly as the reference does.

Exactness contract (as the reference's): ready nodes are scanned in
exact heap order per resource class (``DeviceViews.perm``); the per-kind
arbitration rules follow the ``ArbDescriptor`` fields and the
``ntx_tables`` geometry; deferral-scan caps, first-deferral stall
attribution and the idle-cycle jump are unchanged.  The port is held to
``tests/golden_schedule.json`` and to the reference's C loop.

A call takes any number of configs: one loop (:func:`_launches`) runs
them in launches of at most :data:`BATCH_LANES` lanes.
``schedule_front`` runs a batch under the reference's front cap (the
pruned sweep's): every lane runs to completion and :func:`front_capped`
drops, on the host, the points the reference's C loop would have
abandoned (:func:`front_eligible` says which take part).

``profile_lanes`` launches the kernel's profiling instantiation and
reads where the slowest lane spends its SM clocks.  The host's work is
spanned (``repro_torch.tracing``: ``batch.descriptors``,
``batch.layout``, ``batch.h2d``, ``dse.fold``, ``dse.front_cap``); the
lanes launched and dropped and the bytes copied to the device are
counted.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.sim.arbiter import (F_KIND, F_LEVELS, F_RD, F_WR,
                                          N_FIELDS, STALL_KEYS, _NTX_KINDS,
                                          compile_descriptors,
                                          descriptor_matrix, device_limits)
from repro_torch.core.sim.events import EventLog
from repro_torch.core.sim.prepared import (FU_ORDER, _flatten_ranges,
                                           _next_pow2, prepare_trace)
from repro_torch.core.sim.scheduler import ScheduleConfig, ScheduleResult
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.cycle_lanes import (ERR_DEADLOCK, ERR_MAX_CYCLES,
                                             ERR_UNCONFIGURED, ERR_WHEEL,
                                             INT32_INF, _steer)

# the most lanes one launch takes: it bounds one launch's device memory
# (the lanes' workspace grows with the trace); the kernel takes any count
BATCH_LANES = 256

# an NTX descriptor with more parity paths than this runs, in the
# reference, in its Python loop, which knows no front cap
# (``scheduler.py:56``, ``:322-327``)
_MAX_C_PARITY_PATHS = 128


@dataclasses.dataclass(frozen=True)
class StaticCfg:
    """The padded dimensions of one batched call (a hashable key)."""

    n_pad: int
    n_preds_max: int
    a_pad: int                  # array-axis bucket
    scan_slots: int             # S: per-cycle candidate slots per array
    key_space: int              # U: NTX port-key ids per array
    bank_slots: int             # NB: bank-usage counters per array
    table_depth: int            # D: per-word state (remap map, NTX clamp)
    pend_bits: int              # bits of one pending count (8, 16 or 32)
    wheel_slots: int            # W: finish-wheel buckets (pow 2 > latency)
    wheel_depth: int            # positions one bucket can hold


def _bucket_limits(limits: "Sequence[tuple]"
                   ) -> tuple[int, int, int, int, int]:
    """Pow-2 buckets of the per-design device limits."""
    s, u, nb, d, pp = (max(col) for col in zip(*limits))
    return (_next_pow2(max(s, 1)), _next_pow2(max(u, 1)),
            _next_pow2(max(nb, 1)), _next_pow2(max(d, 1)),
            _next_pow2(max(pp, 1)))


def remap_write_step(live_map, ruse, wuse, addr: int, n_banks: int,
                     ppb: int):
    """One remap write-steering decision, the batched backend's rule.

    Single-array view of the lane loop's steering (the same ``_steer``
    core): scan the banks from the word's live bank and take the first
    one with no write this cycle and a port left.  Returns ``(issued,
    bank, live_map, ruse, wuse)``, with ``bank`` -1 and the state
    untouched when the write stalls."""
    live_map = torch.as_tensor(live_map, dtype=torch.int32).clone()
    ruse = torch.as_tensor(ruse, dtype=torch.int32).clone()
    wuse = torch.as_tensor(wuse, dtype=torch.int32).clone()
    order = (live_map[addr] + torch.arange(n_banks, dtype=torch.int32)) \
        % n_banks
    ok, pos = _steer(wuse[order.long()], ruse[order.long()],
                     torch.ones(n_banks, dtype=torch.bool), ppb)
    if not bool(ok):
        return False, -1, live_map, ruse, wuse
    bank = int(order[int(pos)])
    ruse[bank] += 1
    wuse[bank] = 1
    live_map[addr] = bank
    return True, bank, live_map, ruse, wuse


def _lane_inputs(pt, cfgs) -> "tuple[StaticCfg, dict]":
    """The reference's per-lane numpy inputs for ``cfgs`` over ``pt``,
    and the kernel's position-space view of the trace
    (:func:`_kernel_layout`)."""
    dv = pt.device_views()
    with tracing.span("batch.descriptors"):
        all_descs = [compile_descriptors(c.mem, pt.n_arrays,
                                         c.ports_per_bank) for c in cfgs]
        S, U, NB, D, _ = _bucket_limits([device_limits(d)
                                         for d in all_descs])
        A = dv.a_pad
        B = len(cfgs)
        ins = {"desc": np.zeros((B, A, N_FIELDS), np.int32),
               "fu_budgets": np.zeros((B, len(FU_ORDER)), np.int32),
               "mem_latency": np.zeros((B,), np.int32),
               "ppb": np.zeros((B,), np.int32),
               "max_cycles": np.zeros((B,), np.int32)}
        for b, (cfg, descs) in enumerate(zip(cfgs, all_descs)):
            mat = descriptor_matrix(descs)
            ins["desc"][b, :mat.shape[0]] = mat.astype(np.int32)
            ins["fu_budgets"][b] = [cfg.fu_counts.get(name, 1)
                                    for name in FU_ORDER]
            ins["mem_latency"][b] = cfg.mem_latency
            ins["ppb"][b] = cfg.ports_per_bank
            ins["max_cycles"][b] = min(cfg.max_cycles, INT32_INF - 64)
    for name in ("preds_pad", "lat", "is_load", "word_idx", "perm",
                 "gid_perm", "seg_start"):
        ins[name] = getattr(dv, name)
    with tracing.span("batch.layout"):
        pend_bits, wheel_slots, wheel_depth = _kernel_layout(pt, ins)
    sc = StaticCfg(n_pad=dv.n_pad, n_preds_max=dv.n_preds_max, a_pad=A,
                   scan_slots=S, key_space=U, bank_slots=NB, table_depth=D,
                   pend_bits=pend_bits,
                   wheel_slots=wheel_slots, wheel_depth=wheel_depth)
    return sc, ins


def _pack_pending(indeg: np.ndarray) -> "tuple[int, np.ndarray]":
    """Pending-count seeds packed little-endian into int32 words, in the
    narrowest of 8, 16 or 32 bits a count that holds the largest; at
    least one word."""
    top = int(indeg.max()) if indeg.size else 0
    bits = 8 if top < 2**8 else 16 if top < 2**16 else 32
    per_word = 32 // bits
    packed = np.zeros(max(1, -(-indeg.size // per_word)) * per_word,
                      f"<u{bits // 8}")
    packed[:indeg.size] = indeg
    return bits, packed.view("<i4")


def _kernel_layout(pt, ins: dict) -> "tuple[int, int, int]":
    """The trace relabelled by priority position for the kernel, added to
    ``ins``, and its static sizes ``(pend_bits, wheel_slots,
    wheel_depth)``.

    Position ``i`` is ``perm[i]``'s place in the class-grouped priority
    order.  ``succ_ptr``/``succ_pos`` are the successor CSR by position
    (row ``i`` lists the positions of ``perm[i]``'s successors, in
    ``PreparedTrace.succ_idx`` order); ``x_pos`` is ``lat << 1 |
    is_load`` and ``word_pos`` the memory word of each position;
    ``pend0`` the in-degree of each position packed little-endian into
    int32 words, ``pend_bits`` (8, 16 or 32) bits a count, the narrowest
    that holds the largest in-degree.

    The finish wheel: ``wheel_slots`` is the least power of two above
    the batch's largest latency (an FU or store node's ``lat``, a load's
    lane ``mem_latency``), so the in-flight finishes, which span at most
    that latency, fall in distinct buckets.  ``wheel_depth`` bounds the
    positions that share one finish: a class issues at most its budget
    (FU) or its read and write ports (array) a cycle, and a finish ``f``
    takes a class's nodes of latency ``l`` only from cycle ``f - l``; so
    a lane needs the sum over classes of that per-cycle cap times the
    class's distinct latencies, and no more than the trace's nodes."""
    dv = pt.device_views()
    n, A = dv.n_real, dv.a_pad
    perm = dv.perm[:n].astype(np.int64)
    pos = np.empty(n, np.int64)
    pos[perm] = np.arange(n, dtype=np.int64)
    deg = (pt.succ_ptr[1:] - pt.succ_ptr[:-1]).astype(np.int64)
    succ_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg[perm], out=succ_ptr[1:])
    edges = _flatten_ranges(pt.succ_ptr[perm], pt.succ_ptr[perm + 1])
    succ_pos = pos[pt.succ_idx[edges].astype(np.int64)]
    ins["succ_ptr"] = succ_ptr.astype(np.int32)
    ins["succ_pos"] = (succ_pos if succ_pos.size else
                       np.zeros(1, np.int64)).astype(np.int32)

    pend_bits, ins["pend0"] = _pack_pending(pt.indegree[perm])

    lat = dv.lat[perm].astype(np.int64)
    ld = dv.is_load[perm]
    ins["x_pos"] = ((lat << 1) | ld).astype(np.int32)
    ins["word_pos"] = dv.word_idx[perm].astype(np.int32)

    top_lat = max(int(lat[~ld].max()) if (~ld).any() else 0,
                  int(ins["mem_latency"].max()) if ld.any() else 0)
    wheel_slots = _next_pow2(top_lat + 1)
    gid = dv.gid_perm[:n]
    cap = np.zeros(len(ins["desc"]), np.int64)
    for g in range(A + len(FU_ORDER)):
        sel = gid == g
        if not sel.any():
            continue
        if g >= A:
            n_lat = np.unique(lat[sel]).size
            cap += np.minimum(np.maximum(ins["fu_budgets"][:, g - A], 0),
                              int(sel.sum())) * n_lat
            continue
        loads, stores = sel & ld, sel & ~ld
        rd = np.maximum(ins["desc"][:, g, F_RD], 0)
        wr = np.maximum(ins["desc"][:, g, F_WR], 0)
        cap += np.minimum(rd, int(loads.sum()))
        cap += np.minimum(wr, int(stores.sum())) * np.unique(
            lat[stores]).size
    wheel_depth = max(1, min(n, int(cap.max())))
    return pend_bits, wheel_slots, wheel_depth


def lane_outputs(pt, sc: StaticCfg, ins: dict, device, *,
                 record: bool = False, profile: bool = False) -> tuple:
    """``_lane_inputs``' arrays moved to ``device`` and the one
    ``ops.cycle_lanes`` call over them: its raw outputs (see
    ``kernels/cycle_lanes.py``; ``profile`` needs the card)."""
    with tracing.span("batch.h2d"):
        t = {k: torch.from_numpy(v).to(device) for k, v in ins.items()}
    tracing.count("batch.lanes", len(ins["desc"]))
    tracing.count("batch.h2d_bytes", sum(v.nbytes for v in ins.values()))
    return ops.cycle_lanes(
        t["desc"], t["fu_budgets"], t["mem_latency"], t["ppb"],
        t["max_cycles"], sc.table_depth, pt.device_views().n_real,
        t["preds_pad"], t["lat"], t["is_load"], t["word_idx"], t["perm"],
        t["gid_perm"], t["seg_start"], t["x_pos"], t["word_pos"],
        t["succ_ptr"], t["succ_pos"], t["pend0"],
        scan_slots=sc.scan_slots, key_space=sc.key_space,
        bank_slots=sc.bank_slots, pend_bits=sc.pend_bits,
        wheel_slots=sc.wheel_slots, wheel_depth=sc.wheel_depth,
        record=record, profile=profile)


def _raise_for(err: int, cfg: ScheduleConfig, sc: StaticCfg) -> None:
    """The reference loops' exception for a lane's error code (none for
    ``ERR_NONE``)."""
    if err == ERR_MAX_CYCLES:
        raise RuntimeError(f"scheduler exceeded {cfg.max_cycles} cycles")
    if err == ERR_DEADLOCK:
        raise RuntimeError(
            "deadlock: nodes remain but nothing ready/inflight")
    if err == ERR_UNCONFIGURED:
        raise KeyError("memory op on array without a ScheduleConfig.mem spec")
    if err == ERR_WHEEL:
        raise RuntimeError("cycle_lanes: more positions share a finish "
                           f"than the wheel depth {sc.wheel_depth}")


def _result(pt, b: int, cycles, cnt, per_array) -> ScheduleResult:
    """Lane ``b`` of one call's outputs as a :class:`ScheduleResult`."""
    return ScheduleResult(
        cycles=int(cycles[b]),
        issued=int(cnt[b, 0]),
        mem_issued=int(cnt[b, 1]),
        **{f"{k}_stalls": int(cnt[b, i])
           for k, i in zip(STALL_KEYS, (2, 3, 4))},
        parity_path_reads=int(cnt[b, 5]),
        write_pair_rmws=int(cnt[b, 6]),
        per_array_accesses={a: int(per_array[b, a])
                            for a in pt.trace.array_names},
        avg_mem_parallelism=int(cnt[b, 1]) / max(int(cnt[b, 7]), 1),
    )


def _launches(pt, cfgs: "list[ScheduleConfig]", dev, *, maps: bool,
              record: bool = False):
    """``cfgs`` in ``cycle_lanes`` launches of at most
    :data:`BATCH_LANES` lanes, in order.  Yields, per launch, the index of
    its first config, its :class:`StaticCfg` and inputs, and its outputs
    copied to the host: cycles, counters, per-array accesses and error
    codes, then the remap live maps with ``maps`` and the event log with
    ``record``."""
    for lo in range(0, len(cfgs), BATCH_LANES):
        sc, ins = _lane_inputs(pt, cfgs[lo:lo + BATCH_LANES])
        out = lane_outputs(pt, sc, ins, dev, record=record)
        copied = out[:5 if maps else 4] + (out[5:6] if record else ())
        yield lo, sc, ins, [o.cpu().numpy() for o in copied]


def _stack_maps(maps: "list[np.ndarray]") -> np.ndarray:
    """The launches' remap live maps as one ``[batch, a_pad, D]`` array,
    each zero-padded to the widest ``D``, as a launch pads its lanes."""
    if len(maps) == 1:
        return maps[0]
    depth = max(m.shape[2] for m in maps)
    return np.concatenate([np.pad(m, ((0, 0), (0, 0),
                                      (0, depth - m.shape[2])))
                           for m in maps])


def schedule_batched(tr, cfgs: "Sequence[ScheduleConfig]", *, device=None,
                     return_maps: bool = False,
                     collect_events: bool = False):
    """Run the cycle-accurate scheduler for many designs, one
    ``cycle_lanes`` launch per :data:`BATCH_LANES` of them.

    Every ``cfg`` is one design point over the *same* trace (a ``Trace``
    or ``PreparedTrace``).  Returns ``list[ScheduleResult]`` in ``cfgs``
    order, each equal to what the reference scheduler computes for that
    config.  With ``return_maps=True`` also the final remap live maps
    ``[batch, a_pad, table_depth]``; with ``collect_events=True`` also a
    list of per-config :class:`EventLog` (the recording variant runs).
    ``device=None`` means the CUDA device."""
    cfgs = list(cfgs)
    if not cfgs:
        empty: tuple = ([],)
        if return_maps:
            empty = empty + (np.zeros((0, 0, 0), np.int32),)
        if collect_events:
            empty = empty + ([],)
        return empty if len(empty) > 1 else empty[0]
    dev = resolve_device(device)
    pt = prepare_trace(tr)

    results: "list[ScheduleResult]" = []
    maps: "list[np.ndarray]" = []
    logs: "list[EventLog]" = []
    n = pt.trace.n_nodes
    for lo, sc, _, out in _launches(pt, cfgs, dev, maps=True,
                                    record=collect_events):
        cycles, cnt, per_array, err, live = out[:5]
        with tracing.span("dse.fold"):
            for b, cfg in enumerate(cfgs[lo:lo + len(err)]):
                _raise_for(int(err[b]), cfg, sc)
            results += [_result(pt, b, cycles, cnt, per_array)
                        for b in range(len(err))]
            maps.append(live)
            if collect_events:
                ev = out[5]
                logs += [EventLog(cycle=ev[b, 0, :n].astype(np.int64),
                                  path=ev[b, 1, :n].astype(np.int64),
                                  resource=ev[b, 2, :n].astype(np.int64),
                                  slot=ev[b, 3, :n].astype(np.int64))
                         for b in range(len(err))]
    ret: tuple = (results,)
    if return_maps:
        ret = ret + (_stack_maps(maps),)
    if collect_events:
        ret = ret + (logs,)
    return ret if len(ret) > 1 else ret[0]


def front_eligible(cfgs: "Sequence[ScheduleConfig]",
                   desc: np.ndarray) -> np.ndarray:
    """Which configs take part in the front cap, as in the reference's
    C batch loop, read from their descriptor rows ``desc`` [batch, a_pad,
    N_FIELDS] (``_lane_inputs``' ``desc``): none when the batch mixes
    ``ports_per_bank`` or ``max_cycles`` (the reference then runs every
    config in its Python loop), else every config whose NTX descriptors
    have at most ``_MAX_C_PARITY_PATHS`` parity paths
    (``scheduler.py:313-327``)."""
    if any(c.ports_per_bank != cfgs[0].ports_per_bank
           or c.max_cycles != cfgs[0].max_cycles for c in cfgs):
        return np.zeros(len(cfgs), bool)
    paths = np.left_shift(1, desc[..., F_LEVELS].astype(np.int64))
    wide = np.isin(desc[..., F_KIND], _NTX_KINDS) & \
        (paths > _MAX_C_PARITY_PATHS)
    return ~wide.any(axis=1)


def front_capped(areas: "Sequence[float]", cycle_ns: "Sequence[float]",
                 cycles: "Sequence[int]", max_cycles: int,
                 eligible: "Sequence[bool]") -> "list[bool]":
    """Which points the reference's front cap keeps (``True``) and which
    it abandons (``False``), from each point's area, cycle time and
    exact cycle count: the arithmetic of ``_cycle_loop.c:599-650``
    (``run_schedule_batch``) written out.

    The points are walked in the given order (the reference's
    ``evaluate_points`` gives them in stable ascending-area order).
    ``tmin`` is the least ``cycles_q * ns_q`` over kept, eligible
    earlier points ``q`` with ``area_q <= area_c - 1e-12``; where
    ``tmin / ns_c < max_cycles`` the budget is ``int(tmin / ns_c) + 1``
    (unless that reaches ``max_cycles``), and ``c`` is abandoned iff
    ``cycles_c - 1 > budget`` (the loop checks its budget at the top of
    every cycle it visits, the last one ``cycles_c - 1``).  An
    ineligible point is never abandoned and never sets ``tmin``."""
    kept: "list[bool]" = []
    for c in range(len(areas)):
        budget = max_cycles
        if eligible[c]:
            tmin = -1.0
            for q in range(c):
                if not (kept[q] and eligible[q]) or \
                        areas[q] > areas[c] - 1e-12:
                    continue
                t = float(cycles[q]) * cycle_ns[q]
                if tmin < 0.0 or t < tmin:
                    tmin = t
            if tmin >= 0.0:
                cap = tmin / cycle_ns[c]
                if cap < float(max_cycles):
                    budget = min(budget, int(cap) + 1)
        kept.append(not (budget < max_cycles
                         and cycles[c] - 1 > budget))
    return kept


def schedule_front(tr, cfgs: "Sequence[ScheduleConfig]",
                   areas: "Sequence[float] | None",
                   cycle_ns: "Sequence[float] | None", *, device=None
                   ) -> "list[ScheduleResult | None]":
    """``cfgs`` under the reference's front cap, ``areas`` and
    ``cycle_ns`` one per config: every lane run to completion (one
    ``cycle_lanes`` launch per :data:`BATCH_LANES` configs), then
    :func:`front_capped` once over all of them on the exact cycles.
    Results in ``cfgs`` order, ``None`` where the rule drops the config.

    A dropped lane may have run past ``max_cycles`` (its budget was
    lower, so the reference abandons it first); a kept one that did
    raises the reference's "scheduler exceeded", and any other lane
    error raises as in :func:`schedule_batched`."""
    cfgs = list(cfgs)
    n = len(cfgs)
    if areas is None or cycle_ns is None:
        raise ValueError("front_cap=True requires areas and cycle_ns")
    if len(areas) != n or len(cycle_ns) != n:
        raise ValueError(f"{n} configs but {len(areas)} areas and "
                         f"{len(cycle_ns)} cycle times")
    if not cfgs:
        return []
    dev = resolve_device(device)
    pt = prepare_trace(tr)
    cycles = np.zeros(n, np.int64)
    found: "list[ScheduleResult | None]" = [None] * n
    desc = []
    for lo, sc, ins, (c, cnt, per_array, err) in _launches(pt, cfgs, dev,
                                                           maps=False):
        desc.append(ins["desc"])
        with tracing.span("dse.fold"):
            for b, cfg in enumerate(cfgs[lo:lo + len(err)]):
                if err[b] != ERR_MAX_CYCLES:
                    _raise_for(int(err[b]), cfg, sc)
                    found[lo + b] = _result(pt, b, c, cnt, per_array)
                cycles[lo + b] = c[b]
    with tracing.span("dse.front_cap"):
        kept = front_capped(areas, cycle_ns, cycles, cfgs[0].max_cycles,
                            front_eligible(cfgs, np.concatenate(desc)))
    tracing.count("dse.front_cap.dropped", n - sum(kept))
    for i in range(n):
        if not kept[i]:
            found[i] = None
        elif found[i] is None:
            _raise_for(ERR_MAX_CYCLES, cfgs[i], sc)
    return found


# the phases ``cycle_lanes``' profiling instantiation clocks, in the
# order of its profile columns
LANE_PHASES = ("retire", "ready counts", "candidates", "scan and FU issue",
               "clock")


def profile_lanes(tr, cfgs: "Sequence[ScheduleConfig]", device=None
                  ) -> dict:
    """Where the slowest lane of one ``cycle_lanes`` launch over ``cfgs``
    spends its time: one launch of the kernel's profiling instantiation
    on the CUDA ``device`` (``None``: the CUDA device).

    The slowest lane is the one with the most profiled SM clocks; it
    sets the launch's time.  Returns its index in ``cfgs`` (``lane``),
    its ``cycles``, the cycles it ``visited`` (the idle-cycle jump skips
    the rest), its SM ``clocks`` in each of :data:`LANE_PHASES`,
    ``clocks_per_visit``, each phase's ``shares`` of its clocks, the
    candidates its deferral scan popped (``scan_pops``) in how many
    warp rounds (``scan_rounds``; pops a round is the parallelism the
    scan's warps found), and, summed over its visited cycles, the
    ready-bitmap words its selects read (``select_words``) and the
    bitmap's non-empty words (``ready_words``, what a walk of the whole
    bitmap would have read); and the five slowest lanes, slowest first
    (``slowest``: each lane's index and clocks), so that the lane next
    in line is known.
    Raises ``ValueError`` off the card: the plain lanes keep no
    clocks."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"profile_lanes needs the CUDA device, not {dev}")
    pt = prepare_trace(tr)
    sc, ins = _lane_inputs(pt, list(cfgs))
    out = lane_outputs(pt, sc, ins, dev, profile=True)
    cycles = out[0].cpu().numpy()
    prof, reads = out[-2].cpu().numpy(), out[-1].cpu().numpy()
    k = len(LANE_PHASES)
    total = prof[:, :k].sum(1)
    order = np.argsort(-total, kind="stable")
    lane = int(order[0])
    clocks = prof[lane, :k]
    return {"lane": lane, "cycles": int(cycles[lane]),
            "visited": int(prof[lane, k]),
            "clocks": dict(zip(LANE_PHASES, map(int, clocks))),
            "clocks_per_visit": float(clocks.sum() / prof[lane, k]),
            "shares": [float(c / clocks.sum()) for c in clocks],
            "scan_pops": int(prof[lane, k + 1]),
            "scan_rounds": int(prof[lane, k + 2]),
            "select_words": int(reads[lane, 0]),
            "ready_words": int(reads[lane, 1]),
            "slowest": [{"lane": int(i), "clocks": int(total[i])}
                        for i in order[:5]]}
