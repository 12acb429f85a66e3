"""Analytic sweep surrogate: predict cycles + stall breakdown per point
(the port of the JAX package's ``core/dse/surrogate.py``; numpy on the
host, float64 in the reference's order of operations, so every
prediction is bit-equal to the reference's).

The exhaustive DSE pays one port-constrained schedule per ``(design,
unroll)`` grid point.  This module predicts the outcome of that schedule
in microseconds from statistics the prepared trace already has
(critical-path height, per-array access/conflict histograms, read/write
mix, first-store cold ranges; :meth:`PreparedTrace.mem_profile`)
combined with the compiled
:class:`~repro_torch.core.sim.arbiter.ArbDescriptor` of each design
(port budgets, banking modulus, parity fan-out ``2^k``, remap steering
banks, multipump slot ratio).

Model shape (per point)::

    compute  = b0 * max(dep, fu) + b1 * min(dep, fu)
    port     = p0 * max(port_pressure, conflict) + p1 * band
               + p2 * couple + p3 * min(compute_max, mem_max) + p4
    interf   = compute + ic * max(0, conflict - compute_max / 2)
    cycles   = max(compute, port, interf)

``compute`` is kind-independent (critical path vs FU throughput);
``port``/``interf`` carry per-kind coefficients fitted by the reference
against the 312 pinned golden rows (the ``_surrogate_coef`` constants,
copied).  Stall fields are per-kind linear models on summed conflict
features.

Pruned sweeps (:func:`select_band`) keep a grid point only if no
cheaper-area point is predicted faster by more than the safety margin;
``repro_torch.core.dse.runner`` schedules the kept band on the card.

The model is calibrated for the default ``mem_latency=2`` /
``ports_per_bank=2`` operating point; callers gate on that (the runner
falls back to exhaustive sweeps elsewhere).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.cost import memory_cost
from repro_torch.core.dse import _surrogate_coef as C
from repro_torch.core.dse.sweep import (DesignPoint, _BASE_FU, _spec_for,
                                        _static_cost)
from repro_torch.core.sim.arbiter import (KIND_BANKED, KIND_H_NTX,
                                          KIND_MULTIPUMP, KIND_REMAP,
                                          _NTX_KINDS, STALL_KEYS,
                                          compile_spec)
from repro_torch.core.sim.prepared import (FU_ORDER, PreparedTrace,
                                           prepare_trace)

# conflict-feature column feeding each stall model, in STALL_KEYS order
_STALL_FEATURES = ("sum_conf", "sum_top2", "sum_wr")
assert len(_STALL_FEATURES) == len(STALL_KEYS), \
    "a new STALL_KEYS entry needs a surrogate feature column here"

# height-band width (cycles of schedule height per access-histogram bin)
BAND_W = 8
# Default pruning band: keep points predicted within 10% of the best
# cheaper-area prediction (the reference's margin, sized there against
# the worst observed ranking error of a true-front point with ~9x
# headroom; tests/test_torch_surrogate.py holds the band's front equal
# to the exhaustive front on all twelve TINY calibrated benches).
DEFAULT_MARGIN = 0.10
# the model is fitted at the default operating point only
CALIBRATED_MEM_LATENCY = 2
_AREA_EPS = 1e-12

# the 12-bench x 13-design calibration/regression matrix (one point per
# arbitration kind + the -b4 leaf-sub-banked variants; the pinned golden
# matrix of tests/golden_schedule.json)
CALIBRATION_DESIGNS: dict[str, DesignPoint] = {
    "banked4": DesignPoint("banked", 1, 1, 4),
    "banked32": DesignPoint("banked", 1, 1, 32),
    "multipump-2R2W": DesignPoint("multipump", 2, 2, 1),
    "hb_ntx-2R2W": DesignPoint("hb_ntx", 2, 2, 1),
    "lvt-4R2W": DesignPoint("lvt", 4, 2, 1),
    "ideal-2R2W": DesignPoint("ideal", 2, 2, 1),
    "h_ntx_rd-4R1W": DesignPoint("h_ntx_rd", 4, 1, 1),
    "b_ntx_wr-1R2W": DesignPoint("b_ntx_wr", 1, 2, 1),
    "remap-2R2W": DesignPoint("remap", 2, 2, 1),
    "h_ntx_rd-4R1W-b4": DesignPoint("h_ntx_rd", 4, 1, n_banks=4),
    "hb_ntx-4R2W-b4": DesignPoint("hb_ntx", 4, 2, n_banks=4),
    "lvt-4R2W-b4": DesignPoint("lvt", 4, 2, n_banks=4),
    "remap-4R2W-b4": DesignPoint("remap", 4, 2, n_banks=4),
}
CALIBRATION_UNROLLS: tuple[int, ...] = (1, 4)

# trace families the coefficients are fitted on (the MachSuite golden
# matrix).  Benches outside this set — today the LLM-serving family
# (kv_decode / paged_kv / moe_route) — carry golden rows for backend
# conformance and legality audits but are NOT calibrated: a from-scratch
# refit over the mixed matrix degrades the MachSuite ranking fidelity
# (bfs_queue/nw drop below rho 0.6), so ``run_sweep(prune="surrogate")``
# falls back to the exhaustive grid for them instead.
CALIBRATED_BENCHES = frozenset({
    "fft_strided", "gemm_ncubed", "kmp", "md_knn", "sort_merge",
    "stencil2d", "aes", "spmv_crs", "bfs_queue", "nw", "viterbi",
    "radix_sort"})


@dataclasses.dataclass(frozen=True)
class SurrogatePrediction:
    """Predicted schedule outcome of one ``(design, unroll)`` point."""
    cycles: float
    bank_conflict_stalls: float
    parity_fanout_stalls: float
    write_pair_stalls: float
    # model-term diagnostics (cycles == max of the three)
    compute_term: float
    port_term: float
    interference_term: float


assert all(f"{k}_stalls" in SurrogatePrediction.__dataclass_fields__
           for k in STALL_KEYS), \
    f"SurrogatePrediction is missing stall fields for STALL_KEYS={STALL_KEYS}"


class TraceFeatures:
    """Per-trace feature extractor shared across a whole sweep grid.

    Wraps the trace's :class:`~repro_torch.core.sim.prepared.MemProfile` and
    memoizes the design-dependent conflict reductions (bank-modulus
    histograms, NTX leaf top-2 pressure) that repeat across grid points
    sharing a banking geometry.
    """

    def __init__(self, tr: "PreparedTrace", ports_per_bank: int = 2):
        self.pt = prepare_trace(tr)
        self.prof = self.pt.mem_profile(BAND_W)
        self.ppb = ports_per_bank
        self._memo: dict = {}

    def _words(self, aid: int, what: str) -> np.ndarray:
        prof = self.prof
        if what == "l":
            return prof.load_words[aid]
        key = ("w", aid)
        if key not in self._memo:
            self._memo[key] = np.concatenate(
                [prof.load_words[aid], prof.store_words[aid]])
        return self._memo[key]

    def max_mod(self, aid: int, n_banks: int, what: str = "all") -> int:
        """Worst-bank access count under ``word % n_banks`` banking."""
        key = ("mod", aid, n_banks, what)
        if key not in self._memo:
            w = self._words(aid, what)
            self._memo[key] = (int(np.bincount(w % n_banks,
                                               minlength=n_banks).max())
                               if w.size else 0)
        return self._memo[key]

    def top2_leaf(self, aid: int, depth: int, levels: int, sub: int,
                  split: bool) -> float:
        """Mean of the two worst NTX leaf-bank load counts.

        Mirrors the descriptor's address -> (tree, leaf, sub-bank)
        projection: parity fan-out serializes when one leaf (or its Ref
        twin) concentrates the load stream, and two hot leaves bound
        the sustainable rate at 2 accesses/cycle.
        """
        key = ("leaf", aid, depth, levels, sub, split)
        if key not in self._memo:
            w = self.prof.load_words[aid]
            if not w.size:
                self._memo[key] = 0.0
            else:
                a = w % depth
                if split:
                    half = depth // 2
                    tree = (a >= half).astype(np.int64)
                    ta = a - tree * half
                    td = half
                else:
                    tree = np.zeros_like(a)
                    ta = a
                    td = depth
                if levels:
                    leaf = ta >> max((td.bit_length() - 1) - levels, 0)
                else:
                    leaf = np.zeros_like(ta)
                b = (tree * (1 << levels) + leaf) * sub + ta % sub
                cnt = np.sort(np.bincount(b))[::-1]
                top2 = cnt[0] + (cnt[1] if cnt.size > 1 else 0)
                self._memo[key] = float(top2) / 2.0
        return self._memo[key]

    def features(self, dp: DesignPoint, unroll: int) -> dict:
        """The scalar feature vector of one grid point."""
        pt, prof, ppb = self.pt, self.prof, self.ppb
        dep = float(prof.crit_height)
        fu = 0.0
        for i, name in enumerate(FU_ORDER):
            budget = _BASE_FU[name] * unroll
            if budget:
                fu = max(fu, prof.fu_ops[i] / budget)
        port = conf = couple = 0.0
        sum_conf = sum_top2 = sum_wr = 0.0
        band = np.zeros(prof.n_bands)
        for aid in pt.trace.array_names:
            spec = _spec_for(dp, pt.array_depths[aid],
                             pt.trace.word_bytes[aid] * 8)
            d = compile_spec(spec, ppb)
            loads = pt.loads_per_array[aid]
            stores = pt.stores_per_array[aid]
            pressure = max(loads / d.rd, stores / d.wr)
            cf = 0.0
            if d.kind == KIND_BANKED:
                pressure = max(pressure,
                               (loads + stores) / (d.n_banks * ppb))
                # a single bank has no conflict dimension: every access
                # lands in it and the port-pressure term above already
                # models the serialization exactly (mod-1 "collisions"
                # would double-count it through the interference term)
                if d.n_banks > 1:
                    cf = self.max_mod(aid, d.n_banks) / ppb
            elif d.kind == KIND_MULTIPUMP:
                pressure = max(pressure, (loads + stores) / d.slots)
            elif d.kind == KIND_REMAP:
                # cold loads hit the un-steered bank map; warm loads
                # spread over the write-steered banks
                spread = (max(1, min(d.n_banks - 1, d.wr)) * ppb
                          * max(1.0, d.sub) ** 0.5)
                cold = prof.cold_loads[aid]
                cf = cold / ppb + (loads - cold) / spread
            elif d.kind in _NTX_KINDS:
                cf = self.top2_leaf(aid, d.depth, d.levels, d.sub,
                                    d.kind != KIND_H_NTX)
                sum_top2 += cf
                if d.kind != KIND_H_NTX:
                    sum_wr += stores / d.wr
            band = np.maximum(band,
                              np.maximum(prof.load_bands[aid] / d.rd,
                                         prof.store_bands[aid] / d.wr))
            port = max(port, pressure)
            conf = max(conf, cf)
            couple = max(couple, min(loads / d.rd, stores / d.wr))
            sum_conf += cf
        return {
            "dep": dep, "fu": fu, "port": port, "conf": conf,
            "band": float(band.sum()), "couple": couple,
            "sum_conf": sum_conf, "sum_top2": sum_top2, "sum_wr": sum_wr,
        }


def _predict_from_features(feats: dict, kind: str) -> SurrogatePrediction:
    basemax = max(feats["dep"], feats["fu"])
    memraw = max(feats["port"], feats["conf"])
    b = C.BASE
    compute = b[0] * basemax + b[1] * min(feats["dep"], feats["fu"])
    p = C.PORT[kind]
    port = (p[0] * memraw + p[1] * feats["band"] + p[2] * feats["couple"]
            + p[3] * min(basemax, memraw) + p[4])
    interf = compute + C.INTF[kind] * max(0.0, feats["conf"]
                                          - 0.5 * basemax)
    stalls = {f"{k}_stalls": C.STALL[f"{k}_stalls"].get(kind, 0.0) * feats[x]
              for k, x in zip(STALL_KEYS, _STALL_FEATURES)}
    return SurrogatePrediction(
        cycles=max(compute, port, interf),
        compute_term=compute, port_term=port, interference_term=interf,
        **{f: max(0.0, v) for f, v in stalls.items()})


def _coef_kind(dp: DesignPoint) -> str:
    """Coefficient family for a design point.

    A single-bank banked memory has no conflict dimension — it behaves
    like a plain port-limited macro, so the conflict-heavy banked port
    model (fitted exclusively on multi-bank rows) badly overpredicts it.
    Route it through the ideal/multipump port model instead.
    """
    if dp.kind == "banked" and dp.n_banks == 1:
        return "ideal"
    return dp.kind


def predict(tr: "PreparedTrace", dp: DesignPoint, unroll: int,
            feats: "TraceFeatures | None" = None) -> SurrogatePrediction:
    """Predict the schedule outcome of one grid point.

    Pass a shared :class:`TraceFeatures` when predicting many points of
    one trace (the conflict-histogram memos carry across points).
    """
    tf = feats if feats is not None else TraceFeatures(tr)
    return _predict_from_features(tf.features(dp, unroll), _coef_kind(dp))


@dataclasses.dataclass(frozen=True)
class GridPrediction:
    """One grid point's surrogate ranking entry (pre-simulation)."""
    design: DesignPoint
    unroll: int
    prediction: SurrogatePrediction
    cycle_ns: float
    area_mm2: float

    @property
    def pred_time_us(self) -> float:
        return self.prediction.cycles * self.cycle_ns * 1e-3


def grid_predictions(
    tr: "PreparedTrace",
    designs: Sequence[DesignPoint],
    unrolls: Iterable[int],
    feats: "TraceFeatures | None" = None,
) -> list[GridPrediction]:
    """Surrogate predictions + exact pre-sim costs for a whole grid.

    ``cycle_ns`` and ``area_mm2`` come from the real cost model (they
    do not depend on the schedule), so only predicted *cycles* are
    approximate.  Order is designs-major, unrolls-minor — the same
    order every sweep entry point uses.
    """
    pt = prepare_trace(tr)
    tf = feats if feats is not None else TraceFeatures(pt)
    unrolls = list(unrolls)
    out = []
    for dp in designs:
        specs = [_spec_for(dp, pt.array_depths[aid],
                           pt.trace.word_bytes[aid] * 8)
                 for aid in pt.trace.array_names]
        costs = [memory_cost(s) for s in specs]
        for u in unrolls:
            area, cycle_ns = _static_cost(costs, u)
            out.append(GridPrediction(
                design=dp, unroll=u,
                prediction=_predict_from_features(
                    tf.features(dp, u), _coef_kind(dp)),
                cycle_ns=cycle_ns, area_mm2=area))
    return out


def select_band(
    preds: Sequence[GridPrediction],
    margin: float = DEFAULT_MARGIN,
) -> list[bool]:
    """Keep the predicted Pareto band: mask of grid points to simulate.

    A point is dropped only when some strictly-cheaper-area point is
    predicted faster by more than the safety margin — i.e. kept iff::

        pred_time <= (1 + margin) * min(pred_time of cheaper points)

    Ties and near-ties always survive (their true ordering is beyond
    the model's resolution), so the kept set provably contains the true
    Pareto front whenever the relative prediction error stays within
    ``margin``.
    """
    t = [p.pred_time_us for p in preds]
    a = [p.area_mm2 for p in preds]
    n = len(preds)
    keep = []
    for i in range(n):
        lo = min((t[j] for j in range(n) if a[j] <= a[i] - _AREA_EPS),
                 default=float("inf"))
        keep.append(t[i] <= (1.0 + margin) * lo)
    return keep
