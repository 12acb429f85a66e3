"""Surrogate-error report on the PyTorch port: the port's analytic
predictions vs the golden matrix.

Emits one CSV row per pinned golden schedule row (the 15-bench x
13-design x {1,4} matrix) with the surrogate's predicted cycles
(``repro_torch.core.dse.surrogate``, numpy on the host), the pinned
true cycles, the relative error, and the per-bench Spearman rank
correlation.  Rows for uncalibrated trace families (the serving
benches, where the pruned sweep falls back to exhaustive) are flagged
``calibrated=0`` and excluded from the summary stats.  It writes what
``tools/surrogate_report.py`` writes; the accuracy gates live in
``tests/test_torch_surrogate.py``.

Usage::

    PYTHONPATH=src python tools/surrogate_report_torch.py [--csv out.csv]

With no ``--csv`` the report goes to stdout.  The trailing ``#``
summary line carries the aggregate stats (median/max relative error,
worst per-bench rho).
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.bench import get_trace  # noqa: E402
from repro_torch.core.dse.ratio import spearman_rho  # noqa: E402
from repro_torch.core.dse.surrogate import (  # noqa: E402
    CALIBRATED_BENCHES, CALIBRATION_DESIGNS, TraceFeatures, predict)
from repro_torch.core.sim import prepare_trace  # noqa: E402

GOLDEN_PATH = ROOT / "tests" / "golden_schedule.json"
COLS = ("bench", "design", "unroll", "true_cycles", "pred_cycles",
        "rel_err", "bench_rho", "calibrated")


def build_report() -> "tuple[list[dict], dict]":
    """Per-row records plus aggregate stats over the golden matrix."""
    golden = json.loads(GOLDEN_PATH.read_text())
    by_bench: dict = collections.defaultdict(list)
    for g in golden:
        by_bench[g["bench"]].append(g)

    records, rhos = [], {}
    for bench in sorted(by_bench):
        pt = prepare_trace(get_trace(bench))
        feats = TraceFeatures(pt)
        preds, truths = [], []
        for g in by_bench[bench]:
            dp = CALIBRATION_DESIGNS[g["design"]]
            p = predict(pt, dp, g["unroll"], feats)
            rel = abs(p.cycles - g["cycles"]) / g["cycles"]
            preds.append(p.cycles)
            truths.append(g["cycles"])
            records.append({
                "bench": bench, "design": g["design"],
                "unroll": g["unroll"], "true_cycles": g["cycles"],
                "pred_cycles": p.cycles, "rel_err": rel,
                "calibrated": int(bench in CALIBRATED_BENCHES),
            })
        rhos[bench] = spearman_rho(truths, preds)

    for r in records:
        r["bench_rho"] = rhos[r["bench"]]
    rel_cal = sorted(r["rel_err"] for r in records if r["calibrated"])
    finite = [r for b, r in rhos.items()
              if r == r and b in CALIBRATED_BENCHES]
    stats = {
        "rows": len(records),
        "calibrated_rows": len(rel_cal),
        "median_rel_err": rel_cal[len(rel_cal) // 2],
        "max_rel_err": rel_cal[-1],
        "min_bench_rho": min(finite),
    }
    return records, stats


def main(argv: "list[str] | None" = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Surrogate cycle-predictor error report of the port "
                    "(vs tests/golden_schedule.json).")
    ap.add_argument("--csv", default=None,
                    help="write the report here instead of stdout")
    args = ap.parse_args(argv)

    records, stats = build_report()
    lines = [",".join(COLS)]
    for r in records:
        lines.append(",".join(
            f"{r[c]:.6g}" if isinstance(r[c], float) else str(r[c])
            for c in COLS))
    lines.append(f"# rows={stats['rows']} "
                 f"calibrated_rows={stats['calibrated_rows']} "
                 f"median_rel_err={stats['median_rel_err']:.4f} "
                 f"max_rel_err={stats['max_rel_err']:.4f} "
                 f"min_bench_rho={stats['min_bench_rho']:.4f}")
    text = "\n".join(lines) + "\n"
    if args.csv:
        pathlib.Path(args.csv).write_text(text)
        print(f"wrote {args.csv}: {lines[-1][2:]}")
    else:
        sys.stdout.write(text)
    return stats


if __name__ == "__main__":
    main()
