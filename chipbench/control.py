"""The control of the benchmark's comparison: the reference put in the
program's place with one stated guarantee broken, judged as a run of
the cell would be judged.

The broken guarantee is the deferral-scan cap: the control skips at
most ``SCAN_CAP`` of the blocked candidates a cycle that the paper's
simulator skips (the shortcut that tempts a faster ``cycle_lanes``,
whose time goes mostly to that scan).  For each seed it prints the
cell's compared numbers for the control; a sound benchmark reads them
above their limits.  It needs no CUDA device:

    python3 chipbench/control.py --workload md_knn.grid --seeds 1,2,3
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCAN_CAP = 0.5


def control_numbers(cell, seed: int, workers: int, params=None,
                    traffic=None) -> dict:
    """The compared numbers of ``cell`` with the control in the
    program's place."""
    from chipbench import judge
    from chipbench.reference import model as M
    from chipbench.reference import sweep as ref_sweep

    params = cell.config["params"] if params is None else params
    mix = cell.traffic if traffic is None else traffic
    args = (str(cell.generator), params, seed, mix["designs"],
            mix["unrolls"], mix["mem_latency"])
    ref = ref_sweep.sweep(*args, workers=workers)
    ctl = ref_sweep.sweep(*args, workers=workers, scan_cap=SCAN_CAP)
    fronts = {c: M.pareto(ctl, c) for c in mix["fronts"]}
    return judge.judge(ctl, fronts, ref, exhaustive=mix["prune"] is None,
                       sweeps_differing=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chipbench import catalog
    from chipbench.reference.sweep import cpu_workers

    cell = catalog.find(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        v = control_numbers(cell, seed, cpu_workers())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "scan_cap": SCAN_CAP, **v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
