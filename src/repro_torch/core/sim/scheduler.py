"""Port-constrained cycle-accurate list scheduler (paper III-C): its
configuration and result types (copies of the JAX package's
``core/sim/scheduler.py:60-90``) and ``schedule``, which runs the
batched timing backend (``core/sim/batched_cycle.py``) on a batch of
one design, ``schedule_events``, the same with its event log, and
``schedule_batch``, many designs at once, with the reference's front
cap (``batched_cycle.front_capped``, the rule that decides which capped
points are returned).

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
           "schedule_batch"]


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
    from repro_torch.core.sim.batched_cycle import schedule_batched
    return schedule_batched(tr, [cfg], device=device)[0]


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
                   front_cap: bool = False, device=None
                   ) -> "list[ScheduleResult | None]":
    """Schedule many designs over one trace on the batched timing
    backend; results in ``cfgs`` order, each equal to ``schedule``'s.

    With ``front_cap=True`` (``areas`` and ``cycle_ns`` given, one per
    config, ideally in ascending-area order) a config is dropped once it
    provably misses the time/area front: its slot is ``None`` exactly
    where the reference's C batch loop abandons it
    (``batched_cycle.schedule_front``).  ``device`` as for
    ``schedule``."""
    from repro_torch.core.sim.batched_cycle import (schedule_batched,
                                                    schedule_front)
    if front_cap:
        return schedule_front(tr, cfgs, areas, cycle_ns, device=device)
    return schedule_batched(tr, cfgs, device=device)
