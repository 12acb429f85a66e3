"""Design-space sweep (paper IV-A): 'different compositions are possible
by loop-unrolling, array-partitioning, changing word-size and number of
read and write ports.'

One :class:`DSEPoint` = one accelerator composition: a memory design
applied per array (banked partitioning or an AMM port config) x a loop
unroll factor (scaling functional units).  Cycles come from the
port-constrained scheduler; time/area/power from the cost models.

The names here are copies of the JAX package's ``core/dse/sweep.py``
(:class:`DesignPoint`, :data:`DEFAULT_DESIGNS`, :func:`_spec_for`,
:class:`DSEPoint`, :func:`schedule_config_for`,
:func:`point_from_schedule`; ``tests/test_torch_fault.py`` and
``tests/test_torch_sched_copies.py`` hold them equal to the reference),
and the reference's public functions over the batched timing backend:
:func:`evaluate_points`, any list of ``(design, unroll)`` points of one
trace scheduled by ``scheduler.schedule_batch`` and costed on the host
(with the front cap of the pruned sweep, its static costs from
:func:`_point_static_cost`, a copy of the reference's),
:func:`evaluate_point`, a list of one, and :func:`sweep`, over the
cached sweep runner :mod:`repro_torch.core.dse.runner`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch import tracing
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.cost import (FU_AREA_MM2, FU_LEAK_MW, FU_POWER_MW,
                                   memory_cost)
from repro_torch.core.sim.arbiter import STALL_KEYS
from repro_torch.core.sim.prepared import prepare_trace
from repro_torch.core.sim.scheduler import ScheduleConfig, schedule_batch

__all__ = ["DesignPoint", "DEFAULT_DESIGNS", "DEFAULT_UNROLLS", "DSEPoint",
           "schedule_config_for", "point_from_schedule", "evaluate_point",
           "evaluate_points", "sweep"]

# ScheduleResult / DSEPoint stall-field names, in STALL_KEYS order
_STALL_FIELDS = tuple(f"{k}_stalls" for k in STALL_KEYS)

# base FU mix at unroll=1 (Aladdin constructs multi-issue ALUs by unrolling)
_BASE_FU = {"fadd": 1, "fmul": 1, "fdiv": 1, "iadd": 2, "imul": 1,
            "icmp": 2, "logic": 4}
_MIN_CYCLE_NS = 0.9  # FU critical path floor at 45nm


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """A memory design template, instantiated per array.

    ``n_banks`` is the banking-structure axis (paper Sec. III: depth x
    port config x banking): the partitioning factor for ``banked`` and
    the *leaf sub-banking* factor for AMM kinds (each internal leaf
    macro split into ``n_banks`` word-interleaved sub-banks).
    """
    kind: str
    n_read: int = 1
    n_write: int = 1
    n_banks: int = 1

    @property
    def label(self) -> str:
        if self.kind == "banked":
            return f"banked{self.n_banks}"
        base = f"{self.kind}-{self.n_read}R{self.n_write}W"
        if self.is_amm and self.n_banks > 1:
            return f"{base}-b{self.n_banks}"
        return base

    @property
    def is_amm(self) -> bool:
        return self.kind in ("h_ntx_rd", "b_ntx_wr", "hb_ntx", "lvt", "remap")


DEFAULT_DESIGNS: tuple[DesignPoint, ...] = (
    DesignPoint("banked", n_banks=1),
    DesignPoint("banked", n_banks=2),
    DesignPoint("banked", n_banks=4),
    DesignPoint("banked", n_banks=8),
    DesignPoint("banked", n_banks=16),
    DesignPoint("banked", n_banks=32),
    DesignPoint("multipump", 2, 2),
    DesignPoint("h_ntx_rd", 2, 1),
    DesignPoint("h_ntx_rd", 4, 1),
    DesignPoint("b_ntx_wr", 1, 2),
    DesignPoint("hb_ntx", 2, 2),
    DesignPoint("hb_ntx", 4, 2),
    DesignPoint("lvt", 2, 2),
    DesignPoint("lvt", 4, 2),
    DesignPoint("remap", 2, 2),
    DesignPoint("remap", 4, 2),
    # banking-structure axis: AMM internal leaf sub-banking
    DesignPoint("h_ntx_rd", 4, 1, n_banks=4),
    DesignPoint("hb_ntx", 4, 2, n_banks=4),
    DesignPoint("lvt", 4, 2, n_banks=4),
    DesignPoint("remap", 4, 2, n_banks=4),
)

DEFAULT_UNROLLS: tuple[int, ...] = (1, 2, 4, 8)


@dataclasses.dataclass
class DSEPoint:
    bench: str
    design: str
    is_amm: bool
    unroll: int
    cycles: int
    cycle_ns: float
    time_us: float
    area_mm2: float
    power_mw: float
    bank_conflict_stalls: int
    parity_fanout_stalls: int
    write_pair_stalls: int
    avg_mem_parallelism: float
    # resilience record from a seeded fault campaign on this point's
    # design (core/fault).  Sentinels ("-" / -1.0, not NaN: NaN breaks
    # dataclass equality) mean no campaign was attached.
    res_cover: str = "-"
    res_sdc_rate: float = -1.0
    res_corrected: float = -1.0
    res_detected: float = -1.0
    res_latency: float = -1.0

    @property
    def total_stalls(self) -> int:
        return sum(getattr(self, f) for f in _STALL_FIELDS)

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _spec_for(dp: DesignPoint, depth: int, width_bits: int) -> AMMSpec:
    if dp.kind == "banked":
        nb = min(dp.n_banks, max(depth // 4, 1))
        return AMMSpec("banked", n_read=2 * nb, n_write=2 * nb,
                       depth=depth, width=width_bits, n_banks=nb)
    depth = max(depth, 4 * max(dp.n_read, dp.n_write, 1))
    sub = 1
    if dp.is_amm and dp.n_banks > 1:
        # clamp leaf sub-banking to the leaf depth (pow2, like banked's
        # depth//4 clamp) so tiny arrays never over-partition
        leaf_depth = AMMSpec(dp.kind, dp.n_read, dp.n_write, depth,
                             width_bits).leaf_banks()[1]
        sub = min(dp.n_banks, 1 << max(leaf_depth.bit_length() - 1, 0))
    return AMMSpec(dp.kind, dp.n_read, dp.n_write, depth, width_bits,
                   n_banks=sub)


def schedule_config_for(tr, dp: DesignPoint, unroll: int,
                        mem_latency: int = 2) -> ScheduleConfig:
    """The scheduler configuration one ``(design, unroll)`` point implies
    (``tr`` is a ``Trace`` or ``PreparedTrace``)."""
    pt = prepare_trace(tr)
    trace = pt.trace
    depths = pt.array_depths
    specs = {
        aid: _spec_for(dp, depths[aid], trace.word_bytes[aid] * 8)
        for aid in trace.array_names
    }
    return ScheduleConfig(
        mem=specs,
        fu_counts={k: v * unroll for k, v in _BASE_FU.items()},
        mem_latency=mem_latency,
    )


def _static_cost(costs: "Sequence", unroll: int) -> tuple[float, float]:
    """(area_mm2, cycle_ns) of a point from its arrays' memory costs (in
    array order) and its unroll: the one place both are computed, for
    :func:`point_from_schedule`, the front cap's static costs and the
    surrogate's grid."""
    cycle_ns = max([_MIN_CYCLE_NS] + [c.cycle_ns for c in costs])
    area = sum(c.area_mm2 for c in costs)
    area += sum(FU_AREA_MM2[k] * v * unroll for k, v in _BASE_FU.items())
    return area, cycle_ns


def _point_static_cost(cfg: ScheduleConfig, unroll: int
                       ) -> tuple[float, float]:
    """(area_mm2, cycle_ns) of a point before any simulation (the
    reference's ``_point_static_cost``)."""
    return _static_cost([memory_cost(s) for s in cfg.mem.values()], unroll)


def point_from_schedule(tr, dp: DesignPoint, unroll: int,
                        cfg: ScheduleConfig, res) -> DSEPoint:
    """Fold one ``ScheduleResult`` into a costed :class:`DSEPoint`.

    Deterministic given its inputs, so a point is bitwise identical
    whichever backend produced the schedule."""
    pt = prepare_trace(tr)
    trace = pt.trace
    specs = cfg.mem

    costs = {aid: memory_cost(s) for aid, s in specs.items()}
    area, cycle_ns = _static_cost(list(costs.values()), unroll)
    time_us = res.cycles * cycle_ns * 1e-3

    # dynamic memory energy (per-array access counts precomputed on the
    # prepared trace)
    e_pj = 0.0
    for aid in trace.array_names:
        e_pj += (pt.loads_per_array[aid] * costs[aid].read_energy_pj
                 + pt.stores_per_array[aid] * costs[aid].write_energy_pj)
    p_mem_dyn = e_pj / max(time_us, 1e-9) * 1e-3          # pJ/us -> mW
    p_leak = sum(c.leakage_mw for c in costs.values())
    # FU power at achieved utilization
    fu_total = sum(v * unroll for v in _BASE_FU.values())
    util = min(1.0, res.issued / max(res.cycles * fu_total, 1))
    p_fu = sum(FU_POWER_MW[k] * v * unroll * util + FU_LEAK_MW[k] * v * unroll
               for k, v in _BASE_FU.items())

    return DSEPoint(
        bench=trace.name,
        design=dp.label,
        is_amm=dp.is_amm,
        unroll=unroll,
        cycles=res.cycles,
        cycle_ns=cycle_ns,
        time_us=time_us,
        area_mm2=area,
        power_mw=p_mem_dyn + p_leak + p_fu,
        avg_mem_parallelism=res.avg_mem_parallelism,
        **{f: getattr(res, f) for f in _STALL_FIELDS},
    )


def evaluate_point(tr, dp: DesignPoint, unroll: int, mem_latency: int = 2,
                   *, device=None) -> DSEPoint:
    """One ``(design, unroll)`` point of one trace, costed: a batch of
    one on the batched timing backend.  ``device`` as for
    :func:`evaluate_points`."""
    return evaluate_points(tr, [(dp, unroll)], mem_latency,
                           device=device)[0]


def evaluate_points(tr, points: "Sequence[tuple[DesignPoint, int]]",
                    mem_latency: int = 2, *, front_cap: bool = False,
                    device=None) -> "list[DSEPoint | None]":
    """Evaluate many ``(design, unroll)`` points of one trace, in input
    order: their configs scheduled by ``scheduler.schedule_batch`` (one
    ``cycle_lanes`` launch per ``batched_cycle.BATCH_LANES`` points),
    each result costed on the host by :func:`point_from_schedule`.
    ``device=None`` runs on the CUDA device, ``device="cpu"`` on the
    kernel's plain version.

    With ``front_cap=True`` the points run in stable ascending-area
    order (their static costs, :func:`_point_static_cost`), and a point
    is ``None`` where the reference's C loop abandons it once its time
    provably exceeds that of a strictly cheaper completed point (it
    cannot be on the time/area front); the rule runs once over all of
    them, as the reference's cap spans its whole C call.  The surviving
    points hold every member of the exact time/area front, each bitwise
    equal to its exhaustive point."""
    pt = prepare_trace(tr)
    with tracing.span("dse.configs"):
        cfgs = [schedule_config_for(pt, dp, u, mem_latency)
                for dp, u in points]
    if not front_cap:
        results = schedule_batch(pt, cfgs, device=device)
        with tracing.span("dse.fold"):
            return [point_from_schedule(pt, dp, u, cfg, res)
                    for (dp, u), cfg, res in zip(points, cfgs, results)]

    with tracing.span("dse.front_cap"):
        statics = [_point_static_cost(cfg, u)
                   for cfg, (_, u) in zip(cfgs, points)]
        order = sorted(range(len(points)), key=lambda i: statics[i][0])
    results = schedule_batch(
        pt, [cfgs[i] for i in order],
        areas=[statics[i][0] for i in order],
        cycle_ns=[statics[i][1] for i in order],
        front_cap=True, device=device)
    out: "list[DSEPoint | None]" = [None] * len(points)
    with tracing.span("dse.fold"):
        for rank, i in enumerate(order):
            if results[rank] is not None:
                dp, u = points[i]
                out[i] = point_from_schedule(pt, dp, u, cfgs[i],
                                             results[rank])
    return out


def sweep(tr, designs: Sequence[DesignPoint] = DEFAULT_DESIGNS,
          unrolls: Iterable[int] = DEFAULT_UNROLLS, *, mem_latency: int = 2,
          cache_dir=None, prune: "str | None" = None,
          margin: "float | None" = None, verbose: bool = False,
          device=None) -> list[DSEPoint]:
    """Evaluate ``designs x unrolls`` on one trace: a thin wrapper over
    :func:`repro_torch.core.dse.runner.run_sweep` (``cache_dir`` for the
    on-disk result cache, ``prune="surrogate"`` for the pruned sweep,
    which returns a subset of the grid holding the exact Pareto front).
    Points come back ``designs``-major, ``unrolls``-minor."""
    from repro_torch.core.dse.runner import run_sweep
    return run_sweep(tr, designs, unrolls, mem_latency=mem_latency,
                     cache_dir=cache_dir, prune=prune, margin=margin,
                     verbose=verbose, device=device)
