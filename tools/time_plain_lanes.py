"""Time the plain lane loop (``cycle_lanes_plain``) on the TINY golden
schedule matrix, one lane-batched call a benchmark, on one CPU thread as
the tests run it.

``--window`` sets how many candidates one step of the plain deferral
scan looks ahead (``kernels/cycle_lanes.py::_WINDOW``); ``--window 1``
is the loop that pops one candidate a step.  Every row is checked
against ``tests/golden_schedule.json``.

    PYTHONPATH=src python tools/time_plain_lanes.py --window 1 --bench aes
"""
import argparse
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from _torch_sched_util import check_row, golden_configs  # noqa: E402

from repro_torch.core.bench import BENCHMARKS  # noqa: E402
from repro_torch.core.sim.batched_cycle import schedule_batched  # noqa: E402
from repro_torch.kernels import cycle_lanes  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--window", type=int, default=cycle_lanes._WINDOW)
    ap.add_argument("--bench", action="append", choices=list(BENCHMARKS),
                    help="benchmarks to time (default: all 15)")
    args = ap.parse_args()
    cycle_lanes._WINDOW = args.window
    torch.set_num_threads(1)
    total = 0.0
    for bench in args.bench or BENCHMARKS:
        pt, rows, cfgs = golden_configs(bench)
        t0 = time.perf_counter()
        results = schedule_batched(pt, cfgs, device="cpu")
        dt = time.perf_counter() - t0
        for res, g in zip(results, rows):
            check_row(res, g)
        total += dt
        print(f"{bench}: {len(rows)} lanes, window {args.window}, "
              f"{dt:.2f} s")
    print(f"in all {total:.2f} s")


if __name__ == "__main__":
    main()
