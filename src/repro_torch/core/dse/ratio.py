"""Performance Ratio (paper IV-C), a copy of the JAX package's
``core/dse/ratio.py``:

    PerfRatio = ((a_1 * ... * a_n) / (b_1 * ... * b_n))^(1/n)

where a_i is the area of the banking structure and b_i the area of the
AMM design *at similar execution times* — the geometric mean of the
area advantage over the common reachable time range.  >1 means AMM needs
less area than banking for the same speed (higher is better, Fig 5).

:func:`spearman_rho` quantifies the paper's Fig-5 claim across a suite:
the rank correlation between per-benchmark spatial locality and
performance ratio (the claim holds when it is clearly negative).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from repro_torch.core.dse.pareto import cost_at_time, pareto_front
from repro_torch.core.dse.sweep import DSEPoint

__all__ = ["performance_ratio", "spearman_rho"]


def performance_ratio(points: Sequence[DSEPoint], n_samples: int = 12) -> float:
    banking = [p for p in points if not p.is_amm]
    amm = [p for p in points if p.is_amm]
    if not banking or not amm:
        return float("nan")
    fb = pareto_front(banking)
    fa = pareto_front(amm)
    # common reachable range: both families must reach t.  The lower
    # bound is the slower family's fastest point; the upper bound is the
    # *min* of the per-front maxima — sampling beyond the slower front's
    # last point would only re-measure both fronts' flat tails and pad
    # the geomean with constant ratios.
    t_lo = max(min(p.time_us for p in fb), min(p.time_us for p in fa))
    t_hi = min(max(p.time_us for p in fb), max(p.time_us for p in fa))
    if t_hi <= t_lo:
        t_hi = t_lo * 1.01
    ts = np.geomspace(t_lo, t_hi, n_samples)
    logs = []
    for t in ts:
        a = cost_at_time(fb, float(t))
        b = cost_at_time(fa, float(t))
        if math.isfinite(a) and math.isfinite(b) and a > 0 and b > 0:
            logs.append(math.log(a / b))
    if not logs:
        return float("nan")
    return math.exp(sum(logs) / len(logs))


def _ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share the mean of their rank range)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(x.shape[0], np.float64)
    ranks[order] = np.arange(x.shape[0], dtype=np.float64)
    for v in np.unique(x):
        m = x == v
        if m.sum() > 1:
            ranks[m] = ranks[m].mean()
    return ranks


def spearman_rho(x: Sequence[float], y: Sequence[float]) -> float:
    """Spearman rank correlation (Pearson on average ranks), ``nan`` for
    fewer than 3 pairs or a constant sequence."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    keep = np.isfinite(x) & np.isfinite(y)
    x, y = x[keep], y[keep]
    if x.size < 3:
        return float("nan")
    rx, ry = _ranks(x), _ranks(y)
    sx, sy = rx.std(), ry.std()
    if sx == 0 or sy == 0:
        return float("nan")
    return float(np.mean((rx - rx.mean()) * (ry - ry.mean())) / (sx * sy))
