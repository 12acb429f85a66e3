"""Port-constrained cycle-accurate list scheduler (paper III-C): its
configuration and result types (copies of the JAX package's
``core/sim/scheduler.py:60-90``) and ``schedule``, which runs the
batched timing backend (``core/sim/batched_cycle.py``) on a batch of
one design, ``schedule_events``, the same with its event log, and
``schedule_batch``, many designs at once, with the reference's front
cap (``front_capped``, the rule that decides which capped points are
returned).

'The cycle-accurate simulator schedules the data flow graph [...] The
DAG allows multiple accesses and the scheduler then issues the number of
accesses requested, accordingly from the read-write port configurations
and port width defined by the user.'  The per-kind issue rules are in
``core/sim/arbiter.py``; functional units issue ``fu_counts[kind]`` ops
a cycle; priority is the longest latency-weighted path to a sink.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.sim.arbiter import STALL_KEYS
from repro_torch.core.sim.events import EventLog

__all__ = ["ScheduleConfig", "ScheduleResult", "schedule", "schedule_events",
           "schedule_batch", "front_capped"]

# an NTX descriptor with more parity paths than this runs, in the
# reference, in its Python loop, which knows no front cap
# (``scheduler.py:56``, ``:322-327``)
_MAX_C_PARITY_PATHS = 128


@dataclasses.dataclass
class ScheduleConfig:
    mem: dict[int, AMMSpec]                 # per-array memory design
    fu_counts: dict[str, int]               # parallel FUs per class
    mem_latency: int = 2                    # issue-to-data cycles for loads
    ports_per_bank: int = 2                 # dual-port leaf macros
    max_cycles: int = 50_000_000


@dataclasses.dataclass
class ScheduleResult:
    cycles: int
    issued: int
    mem_issued: int
    bank_conflict_stalls: int               # unique accesses delayed >=1 cycle
                                            #   by bank/steering conflicts
    parity_fanout_stalls: int               # NTX reads with direct leaf AND
                                            #   parity path busy
    write_pair_stalls: int                  # B/HB-NTX same-half write pairs
                                            #   blocked on the Ref RMW path
    parity_path_reads: int                  # reads served via XOR parity path
    write_pair_rmws: int                    # successful Ref re-pointing flows
    per_array_accesses: dict[int, int]
    avg_mem_parallelism: float

    def stall_breakdown(self) -> dict[str, int]:
        """Per-cause unique-access stall counts (paper Sec. II timing)."""
        return {k: getattr(self, f"{k}_stalls") for k in STALL_KEYS}

    def summary(self) -> dict:
        return dataclasses.asdict(self)


def schedule(tr, cfg: ScheduleConfig, *, device=None) -> ScheduleResult:
    """Schedule one trace (``Trace`` or ``PreparedTrace``) under one
    design: the batched engine on a batch of one.  ``device=None`` runs
    the ``cycle_lanes`` kernel on the CUDA device; ``device="cpu"`` runs
    its plain version."""
    from repro_torch.core.sim.batched_cycle import schedule_one
    return schedule_one(tr, cfg, device=device)


def schedule_events(tr, cfg: ScheduleConfig, *, device=None
                    ) -> "tuple[ScheduleResult, EventLog]":
    """``schedule`` with issue-event logging: the (unchanged, recording
    never influences an arbitration decision) result and the
    node-indexed :class:`~repro_torch.core.sim.events.EventLog`, from the
    recording variant of the batched engine on a batch of one.
    ``device`` as for ``schedule``."""
    from repro_torch.core.sim.batched_cycle import schedule_batched
    (res,), (log,) = schedule_batched(tr, [cfg], device=device,
                                      collect_events=True)
    return res, log


def schedule_batch(tr, cfgs: "Sequence[ScheduleConfig]", *,
                   areas: "Sequence[float] | None" = None,
                   cycle_ns: "Sequence[float] | None" = None,
                   front_cap: bool = False, device=None,
                   batch_lanes: int = 256) -> "list[ScheduleResult | None]":
    """Schedule many designs over one trace on the batched timing
    backend, one ``cycle_lanes`` launch per ``batch_lanes`` configs;
    results in ``cfgs`` order, each equal to ``schedule``'s.

    With ``front_cap=True`` (``areas`` and ``cycle_ns`` given, one per
    config, ideally in ascending-area order) a config is dropped once it
    provably misses the time/area front: its slot is ``None`` exactly
    where the reference's C batch loop abandons it (:func:`front_capped`
    over the configs in the given order, on the exact cycles of lanes
    run to completion).  ``device`` as for ``schedule``."""
    from repro_torch.core.sim.batched_cycle import (schedule_batched,
                                                    schedule_front)
    cfgs = list(cfgs)
    if front_cap and (areas is None or cycle_ns is None):
        raise ValueError("front_cap=True requires areas and cycle_ns")
    if not cfgs:
        return []
    if not front_cap:
        return [r for lo in range(0, len(cfgs), batch_lanes)
                for r in schedule_batched(tr, cfgs[lo:lo + batch_lanes],
                                          device=device)]
    return schedule_front(tr, cfgs, areas, cycle_ns, device=device,
                          batch_lanes=batch_lanes)


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
