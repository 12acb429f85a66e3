"""Scenario on the PyTorch port: full paper-style design-space
exploration on one benchmark.

Reproduces the Fig-4 flow for a chosen MachSuite benchmark: sweep
banking factors x AMM designs x unroll through the cached sweep runner
(``run_sweep``: one ``cycle_lanes`` launch per 256 points), print the
(time, area, power) points, both Pareto fronts, the design-space
expansion, and the Fig-5 performance ratio.  It prints what
``examples/dse_machsuite.py`` prints, byte for byte.  There is no
``--jobs``: the reference's process pool is not ported, the grid runs
as lanes of one launch.

Run:  PYTHONPATH=src python examples/dse_machsuite_torch.py [bench]
          [--full] [--cache-dir DIR] [--device cpu]
      (the CUDA device unless ``--device`` names another)
"""
import argparse
import os

from repro_torch.core.bench import BENCHMARKS, get_trace
from repro_torch.core.dse import (DEFAULT_DESIGNS, SweepCache,
                                  design_space_expansion, pareto_front,
                                  performance_ratio, run_sweep)
from repro_torch.core.sim import prepare_trace
from repro_torch.device import resolve_device

UNROLLS = (1, 2, 4, 8)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bench", nargs="?", default="gemm_ncubed",
                    choices=sorted(BENCHMARKS))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    pt = prepare_trace(get_trace(args.bench, full=args.full))
    print(f"benchmark={args.bench}  nodes={pt.n_nodes}  "
          f"mem_ops={pt.trace.n_mem}  L_spatial={pt.locality:.3f}\n")

    # as the runner resolves it: --cache-dir, else REPRO_DSE_CACHE, else
    # none; built here so that its hits and misses can be reported
    cache_dir = args.cache_dir or os.environ.get("REPRO_DSE_CACHE")
    cache = SweepCache(cache_dir) if cache_dir else None
    pts = run_sweep(pt, DEFAULT_DESIGNS, unrolls=UNROLLS, cache=cache,
                    device=dev)
    print(f"{'design':18s} {'unroll':6s} {'cycles':>8s} {'time_us':>9s} "
          f"{'area_mm2':>9s} {'power_mW':>9s} {'bank_st':>8s} "
          f"{'parity_st':>9s} {'pair_st':>7s}")
    for p in sorted(pts, key=lambda p: p.time_us):
        print(f"{p.design:18s} {p.unroll:<6d} {p.cycles:8d} "
              f"{p.time_us:9.2f} {p.area_mm2:9.4f} {p.power_mw:9.1f} "
              f"{p.bank_conflict_stalls:8d} {p.parity_fanout_stalls:9d} "
              f"{p.write_pair_stalls:7d}")

    banking = [p for p in pts if not p.is_amm]
    amm = [p for p in pts if p.is_amm]
    fronts = {"banking": pareto_front(banking), "amm": pareto_front(amm)}
    print("\nbanking Pareto (time, area):",
          [(round(p.time_us, 2), round(p.area_mm2, 4))
           for p in fronts["banking"]])
    print("AMM Pareto     (time, area):",
          [(round(p.time_us, 2), round(p.area_mm2, 4))
           for p in fronts["amm"]])
    expansion = design_space_expansion(banking, amm)
    ratio = performance_ratio(pts)
    print(f"\ndesign-space expansion (fastest banked / fastest AMM): "
          f"{expansion:.2f}x")
    print(f"performance ratio (geomean banked-area / AMM-area at "
          f"iso-time): {ratio:.2f}  (>1 means AMM is the better design)")
    return {"bench": args.bench, "points": pts, "fronts": fronts,
            "expansion": expansion, "ratio": ratio,
            "cache_hits": cache.hits if cache else 0,
            "cache_misses": cache.misses if cache else 0}


if __name__ == "__main__":
    main()
