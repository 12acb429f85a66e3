"""Pareto-front utilities for the (execution-time, area) and
(execution-time, power) trade-off plots (paper Fig 4); a copy of the JAX
package's ``core/dse/pareto.py``."""
from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.core.dse.sweep import DSEPoint


def pareto_front(
    points: Sequence[DSEPoint],
    cost: Callable[[DSEPoint], float] = lambda p: p.area_mm2,
) -> list[DSEPoint]:
    """Non-dominated set in (time_us, cost), sorted by time."""
    pts = sorted(points, key=lambda p: (p.time_us, cost(p)))
    front: list[DSEPoint] = []
    best = float("inf")
    for p in pts:
        c = cost(p)
        if c < best - 1e-12:
            front.append(p)
            best = c
    return front


def cost_at_time(
    front: Sequence[DSEPoint],
    t_us: float,
    cost: Callable[[DSEPoint], float] = lambda p: p.area_mm2,
) -> float:
    """Min cost achievable within time budget t (step interpolation on the
    front); inf if the family cannot reach t at all."""
    feas = [cost(p) for p in front if p.time_us <= t_us * (1 + 1e-9)]
    return min(feas) if feas else float("inf")


def design_space_expansion(
    banking: Sequence[DSEPoint], amm: Sequence[DSEPoint]
) -> float:
    """How much faster the fastest AMM design is vs the fastest banking
    design (>1 means AMM expands the high-performance design space —
    the blue-shaded region of Fig 4).  ``nan`` when either family is
    empty (a sweep restricted to one family has no expansion to report).
    """
    if not banking or not amm:
        return float("nan")
    tb = min(p.time_us for p in banking)
    ta = min(p.time_us for p in amm)
    return tb / ta
