"""Write tests/golden_schedule_full.json: the full-size DSE matrix.

Every benchmark's full-size trace (``get_trace(name, full=True)``) is
scheduled under every ``DEFAULT_DESIGNS`` point at every
``DEFAULT_UNROLLS`` factor (15 x 20 x 4 = 1200 points) by the reference
scheduler's compiled C cycle loop, with the configuration
``schedule_config_for`` builds.  Each row carries the fields of
``tests/golden_schedule.json``: cycles, issued, mem_issued,
avg_mem_parallelism (rounded to 9 places) and the stall and path
counters.  The PyTorch port's batched timing backend is held to these
rows on the card and, for three benches, on the CPU.

Usage::

    PYTHONPATH=src python tools/gen_golden_schedule_full.py [--out PATH]

It prints each benchmark's C-loop wall time and the total.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

OUT = (pathlib.Path(__file__).resolve().parents[1] / "tests"
       / "golden_schedule_full.json")
STALL_FIELDS = ("bank_conflict_stalls", "parity_fanout_stalls",
                "write_pair_stalls", "parity_path_reads", "write_pair_rmws")


def golden_row(bench: str, design: str, unroll: int, res) -> dict:
    """One schedule result in the golden files' row layout."""
    row = {"bench": bench, "design": design, "unroll": unroll,
           "cycles": res.cycles, "issued": res.issued,
           "mem_issued": res.mem_issued,
           "avg_mem_parallelism": round(res.avg_mem_parallelism, 9)}
    row.update({f: getattr(res, f) for f in STALL_FIELDS})
    return row


def bench_rows(bench: str) -> "tuple[list[dict], float]":
    """The rows of one benchmark and the C loop's wall seconds for them
    (trace generation and preparation not counted)."""
    from repro.core.bench import get_trace
    from repro.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                      schedule_config_for)
    from repro.core.sim import prepare_trace
    from repro.core.sim.scheduler import schedule

    pt = prepare_trace(get_trace(bench, full=True))
    cfgs = [(dp, u, schedule_config_for(pt, dp, u))
            for dp in DEFAULT_DESIGNS for u in DEFAULT_UNROLLS]
    t0 = time.perf_counter()
    results = [schedule(pt, cfg, backend="c") for _, _, cfg in cfgs]
    sec = time.perf_counter() - t0
    return [golden_row(bench, dp.label, u, res)
            for (dp, u, _), res in zip(cfgs, results)], sec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    args = ap.parse_args(argv)
    from repro.core.bench import BENCHMARKS

    rows, total = [], 0.0
    for bench in BENCHMARKS:
        got, sec = bench_rows(bench)
        rows += got
        total += sec
        print(f"{bench}: {len(got)} points, C loop {sec:.3f} s, max cycles "
              f"{max(r['cycles'] for r in got)}", flush=True)
    print(f"{len(rows)} points, C loop {total:.3f} s in all (one core)")
    args.out.write_text(json.dumps(rows, indent=1) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
