"""Fit the PyTorch port's analytic sweep-surrogate coefficients
against the golden matrix.

Deterministic, dependency-free calibration of
``repro_torch.core.dse.surrogate`` over the port's ``TraceFeatures``: a
weighted least-squares init followed by fixed-step coordinate descent
on a rank-aware loss over the calibrated 312-row subset of the pinned
golden matrix (``tests/golden_schedule.json`` restricted to
``surrogate.CALIBRATED_BENCHES`` — golden rows for uncalibrated trace
families like the LLM-serving benches are conformance pins, not fit
data; the pruned sweep runs those exhaustively), then closed-form
least-squares slopes for the per-kind stall models.  Writes the result
to ``src/repro_torch/core/dse/_surrogate_coef.py`` as checked-in
constants; ``tools/fit_surrogate.py`` fits the same constants for the
JAX package.

The loss couples the relative cycle error with a per-bench Spearman
shortfall penalty — the pruned-sweep use case needs *ranking* fidelity
within each bench at least as much as absolute accuracy::

    loss = mean(rel_err^2) + 5.0 * sum_b max(0, 0.93 - rho_b)

Usage::

    PYTHONPATH=src python tools/fit_surrogate_torch.py [--dry-run]
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.bench import get_trace  # noqa: E402
from repro_torch.core.dse.ratio import spearman_rho  # noqa: E402
from repro_torch.core.dse.surrogate import (  # noqa: E402
    CALIBRATED_BENCHES, CALIBRATION_DESIGNS, TraceFeatures)
from repro_torch.core.sim import prepare_trace  # noqa: E402

GOLDEN_PATH = ROOT / "tests" / "golden_schedule.json"
COEF_PATH = ROOT / "src" / "repro_torch" / "core" / "dse" / "_surrogate_coef.py"

STEPS = (0.2, 0.08, 0.03, 0.01)
RHO_TARGET = 0.93
RHO_WEIGHT = 5.0

# which design kinds can produce which stall field (matches the C
# cycle loop's arbitration branches)
STALL_KINDS = {
    "bank_conflict_stalls": ("banked", "remap"),
    "parity_fanout_stalls": ("h_ntx_rd", "b_ntx_wr", "hb_ntx"),
    "write_pair_stalls": ("b_ntx_wr", "hb_ntx"),
}
STALL_FEATURE = {
    "bank_conflict_stalls": "sum_conf",
    "parity_fanout_stalls": "sum_top2",
    "write_pair_stalls": "sum_wr",
}


def _collect_rows():
    golden = json.loads(GOLDEN_PATH.read_text())
    feats_of = {}
    rows = []
    kind_of = {name: dp.kind for name, dp in CALIBRATION_DESIGNS.items()}
    for g in golden:
        if g["bench"] not in CALIBRATED_BENCHES:
            continue
        tf = feats_of.get(g["bench"])
        if tf is None:
            tf = TraceFeatures(prepare_trace(get_trace(g["bench"])))
            feats_of[g["bench"]] = tf
        r = tf.features(CALIBRATION_DESIGNS[g["design"]], g["unroll"])
        r["g"] = g
        r["kind"] = kind_of[g["design"]]
        r["y"] = g["cycles"]
        rows.append(r)
    return rows


def _basemax(r):
    return max(r["dep"], r["fu"])


def _memraw(r):
    return max(r["port"], r["conf"])


def _base_x(r):
    return [_basemax(r), min(r["dep"], r["fu"])]


def _port_x(r):
    return [_memraw(r), r["band"], r["couple"],
            min(_basemax(r), _memraw(r)), 1.0]


def _excess(r):
    return max(0.0, r["conf"] - 0.5 * _basemax(r))


def _wfit(x, y, fallback):
    """Least squares weighted by 1/max(y, 1) (relative-error flavored)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if len(y) <= x.shape[1]:
        return np.array(fallback, float)
    w = 1.0 / np.maximum(y, 1.0)
    coef, *_ = np.linalg.lstsq(x * w[:, None], y * w, rcond=None)
    return coef


def _predict_with(r, bc, pc, ic):
    bv = float(np.dot(_base_x(r), bc))
    pv = float(np.dot(_port_x(r), pc))
    iv = bv + ic * _excess(r)
    return max(bv, pv, iv)


def fit(rows):
    kinds = sorted({r["kind"] for r in rows})
    bench_of = collections.defaultdict(list)
    for r in rows:
        bench_of[r["g"]["bench"]].append(r)

    # ---- least-squares init ----
    base_rows = [r for r in rows if _basemax(r) >= _memraw(r)]
    bc = _wfit([_base_x(r) for r in base_rows],
               [r["y"] for r in base_rows], [1.0, 0.05])
    pcs, ics = {}, {}
    for k in kinds:
        strict = [r for r in rows
                  if r["kind"] == k and _memraw(r) > _basemax(r)]
        pcs[k] = (_wfit([_port_x(r) for r in strict],
                        [r["y"] for r in strict],
                        [0.9, 0.1, 0.1, 0.1, 1.0])
                  if len(strict) >= 6
                  else np.array([0.9, 0.1, 0.1, 0.1, 1.0]))
        ics[k] = 0.1

    def loss(bc, pcs, ics):
        s = 0.0
        preds = {}
        for r in rows:
            p = _predict_with(r, bc, pcs[r["kind"]], ics[r["kind"]])
            preds[id(r)] = p
            s += ((p - r["y"]) / r["y"]) ** 2
        s /= len(rows)
        for b, rs in bench_of.items():
            rho = spearman_rho([preds[id(r)] for r in rs],
                               [r["y"] for r in rs])
            if rho == rho:          # nan (constant bench) counts as met
                s += RHO_WEIGHT * max(0.0, RHO_TARGET - rho)
        return s

    # ---- coordinate descent through the max() (non-smooth, so no
    # gradients; fixed step schedule keeps it deterministic) ----
    for step in STEPS:
        for _ in range(6):
            improved = False
            for ci in range(len(bc)):
                for sgn in (1, -1):
                    cand = bc.copy()
                    cand[ci] += sgn * step
                    if loss(cand, pcs, ics) < loss(bc, pcs, ics) - 1e-9:
                        bc = cand
                        improved = True
            for k in kinds:
                for ci in range(len(pcs[k])):
                    for sgn in (1, -1):
                        cand = pcs[k].copy()
                        cand[ci] += sgn * step * (
                            10.0 if ci == len(cand) - 1 else 1.0)
                        new = {**pcs, k: cand}
                        if loss(bc, new, ics) < loss(bc, pcs, ics) - 1e-9:
                            pcs[k] = cand
                            improved = True
                for sgn in (1, -1):
                    cand = max(0.0, ics[k] + sgn * step)
                    new = {**ics, k: cand}
                    if loss(bc, pcs, new) < loss(bc, pcs, ics) - 1e-9:
                        ics[k] = cand
                        improved = True
            if not improved:
                break
    return bc, pcs, ics, bench_of


def fit_stalls(rows):
    """Closed-form nonneg slope per (stall field, kind): y = slope*x."""
    out = {}
    for field, kinds in STALL_KINDS.items():
        feat = STALL_FEATURE[field]
        slopes = {}
        for k in kinds:
            pts = [(r[feat], r["g"].get(field))
                   for r in rows if r["kind"] == k and field in r["g"]]
            sxx = sum(x * x for x, _ in pts)
            sxy = sum(x * y for x, y in pts)
            slopes[k] = max(0.0, sxy / sxx) if sxx > 0 else 0.0
        out[field] = slopes
    return out


def main(argv=None) -> dict:
    """Fit, then write the constants (print them with ``--dry-run``);
    returns the per-bench stats and the file's text."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="print the file's text instead of writing it")
    args = ap.parse_args(argv)

    rows = _collect_rows()
    bc, pcs, ics, bench_of = fit(rows)
    stalls = fit_stalls(rows)

    stats = {}
    allrel = []
    for b, rs in sorted(bench_of.items()):
        preds = [_predict_with(r, bc, pcs[r["kind"]], ics[r["kind"]])
                 for r in rs]
        rel = [abs(p - r["y"]) / r["y"] for p, r in zip(preds, rs)]
        rho = spearman_rho(preds, [r["y"] for r in rs])
        allrel.extend(rel)
        stats[b] = {"rho": None if rho != rho else round(rho, 4),
                    "medrel": round(float(np.median(rel)), 4),
                    "maxrel": round(float(np.max(rel)), 4)}
        print(f"{b:12s} rho={stats[b]['rho']} medrel={stats[b]['medrel']} "
              f"maxrel={stats[b]['maxrel']}")
    stats["_all"] = {"n_rows": len(rows),
                     "medrel": round(float(np.median(allrel)), 4),
                     "maxrel": round(float(np.max(allrel)), 4)}
    print(f"ALL medrel={stats['_all']['medrel']} "
          f"maxrel={stats['_all']['maxrel']}")

    bad = [b for b, s in stats.items()
           if b != "_all" and s["rho"] is not None and s["rho"] < 0.9]
    assert not bad, f"fit below rank target on {bad}"
    assert stats["_all"]["medrel"] <= 0.06, stats["_all"]
    assert stats["_all"]["maxrel"] <= 0.25, stats["_all"]

    kinds = sorted(pcs)
    lines = ['"""Fitted surrogate coefficients — GENERATED, '
             'do not edit by hand.',
             "",
             "Regenerate with::",
             "",
             "    PYTHONPATH=src python tools/fit_surrogate_torch.py",
             "",
             "The fit is deterministic (weighted least-squares init + "
             "fixed-step",
             "coordinate descent on the 312 pinned golden rows), so "
             "regeneration is",
             "reproducible; tests/test_torch_surrogate.py pins the "
             "resulting",
             "accuracy and the constants' equality with the JAX "
             "package's fit.",
             '"""',
             "",
             f"BASE = ({bc[0]:.6f}, {bc[1]:.6f})",
             "",
             "PORT = {"]
    for k in kinds:
        vals = ", ".join(f"{v:.6f}" for v in pcs[k])
        lines.append(f'    "{k}": ({vals}),')
    lines += ["}", "", "INTF = {"]
    for k in kinds:
        lines.append(f'    "{k}": {ics[k]:.6f},')
    lines += ["}", "", "STALL = {"]
    for field in sorted(stalls):
        entries = ", ".join(f'"{k}": {v:.6f}'
                            for k, v in sorted(stalls[field].items()))
        lines.append(f'    "{field}": {{{entries}}},')
    lines += [
        "}",
        "",
        "# drift guard: the fitted stall models must cover exactly the",
        "# scheduler's stall taxonomy (re-fit after changing STALL_KEYS)",
        "from repro_torch.core.sim.arbiter import STALL_KEYS as "
        "_STALL_KEYS  # noqa: E402",
        "",
        "assert set(STALL) == {f\"{k}_stalls\" for k in _STALL_KEYS}, \\",
        "    \"surrogate STALL coefficients out of sync with STALL_KEYS; "
        "re-run \" \\",
        "    \"tools/fit_surrogate_torch.py\"",
    ]
    stats_py = json.dumps(stats, indent=4).replace("null", "None")
    lines += ["", f"FIT_STATS = {stats_py}", ""]

    text = "\n".join(lines)
    if args.dry_run:
        print(text)
    else:
        COEF_PATH.write_text(text)
        print(f"wrote {COEF_PATH}")
    return {"stats": stats, "text": text}


if __name__ == "__main__":
    main()
