#!/usr/bin/env python
"""Run the port's legality checker over the full golden matrix.

For every row of ``tests/golden_schedule.json`` (15 benches x 13
designs x unroll points = 390 rows) the schedule is re-run with
issue-event logging, one lane-batched ``schedule_batched`` call a bench
(one ``cycle_lanes`` launch on the CUDA device, its plain version on
the CPU), and ``repro_torch.core.verify.verify_result`` validates each
event log against rules compiled straight from the AMMSpecs, plus the
static hazard lower bounds.  A per-row report lands in ``--out`` (CSV,
the columns of ``tools/check_legality.py``; ``backend`` holds the
device) and the exit status is 1 if any row produced a violation.

Usage:
    PYTHONPATH=src python tools/check_legality_torch.py \
        [--device cpu] [--stride 1] [--out legality_report.csv]
    (the CUDA device unless ``--device`` names another)
"""
from __future__ import annotations

import argparse
import csv
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from repro_torch.core.bench import get_trace  # noqa: E402
from repro_torch.core.sim import prepare_trace  # noqa: E402
from repro_torch.core.sim.batched_cycle import schedule_batched  # noqa: E402
from repro_torch.core.verify import verify_result  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

_FIELDS = ("bench", "design", "unroll", "backend", "cycles", "ok",
           "n_violations", "violations", "bound_critical_path",
           "bound_port_pressure", "bound_bank_conflict",
           "bound_parity_pressure", "tight")


def _bound_cols(bounds: dict, cycles: int) -> dict:
    row = {f"bound_{k}": v for k, v in bounds.items()}
    row["tight"] = ";".join(sorted(k for k, v in bounds.items()
                                   if v == cycles))
    return row


def main(argv=None) -> dict:
    """Check the rows; returns the counts and ``rc``, the exit status."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; cpu "
                         "runs the plain lanes)")
    ap.add_argument("--stride", type=int, default=1,
                    help="check every Nth golden row (default 1 = all)")
    ap.add_argument("--out", default="legality_report.csv")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    golden = json.loads((ROOT / "tests" / "golden_schedule.json").read_text())
    rows = golden[::args.stride]

    from _torch_sched_util import config  # the pinned harness's configs

    by_bench: "dict[str, list]" = {}
    for g in rows:
        by_bench.setdefault(g["bench"], []).append(g)

    report: "list[dict]" = []
    n_bad = 0
    tight_rows = 0
    for bench, bench_rows in sorted(by_bench.items()):
        pt = prepare_trace(get_trace(bench))
        cfgs = [config(pt, g["design"], g["unroll"]) for g in bench_rows]
        results, logs = schedule_batched(pt, cfgs, device=dev,
                                         collect_events=True)
        for g, cfg, res, ev in zip(bench_rows, cfgs, results, logs):
            rep = verify_result(pt, cfg, res, ev, backend=str(dev))
            if not rep.ok:
                n_bad += 1
            if rep.bounds and any(v == rep.result.cycles
                                  for v in rep.bounds.values()):
                tight_rows += 1
            report.append(dict(
                bench=g["bench"], design=g["design"], unroll=g["unroll"],
                backend=str(dev), cycles=rep.result.cycles,
                ok=int(rep.ok), n_violations=len(rep.violations),
                violations=" | ".join(str(v) for v in rep.violations[:5]),
                **_bound_cols(rep.bounds, rep.result.cycles)))
        print(f"[{len(report):4d} rows] {bench}: {len(bench_rows)} designs "
              f"on {dev}, {n_bad} violations so far", flush=True)

    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=_FIELDS)
        w.writeheader()
        w.writerows(report)

    print(f"\nchecked {len(report)} rows on {dev}: {n_bad} with "
          f"violations; static bounds tight on {tight_rows} of them; "
          f"report -> {args.out}")
    out = {"rows": len(report), "violations": n_bad, "tight": tight_rows,
           "rc": 0}
    if n_bad:
        print("LEGALITY CHECK FAILED", file=sys.stderr)
        out["rc"] = 1
    elif tight_rows == 0:
        print("WARNING: no static bound was tight on any golden row",
              file=sys.stderr)
    return out


if __name__ == "__main__":
    raise SystemExit(main()["rc"])
