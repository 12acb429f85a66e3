"""Run one cell of the port's benchmark once, on the CUDA device.

    python3 chipbench/run.py --workload sort_merge.grid --seed 7 \\
        --seconds 30 --trace 0

The cell is looked up by name in ``BENCHMARK.json`` at the root of the
checkout (see ``chipbench/catalog.py``).  ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` trace of the window.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and, traced, ``breakdown``); the
numbers that decide ``correct`` come last in it, under ``checks``, and
are also the last lines of standard error.

Exits non-zero and prints no result without a CUDA device, without the
program (``src/repro_torch``) beside the benchmark, or when JAX or the
JAX package was loaded.  Kernels are built under ``build/`` in the
checkout; nothing else is written outside the temporary directory.
"""
import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_IMPORTED_AT = time.time()


def process_start() -> float:
    """When this process started, on the wall clock (the kernel's record
    of it, so that interpreter start-up counts as set-up)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


def forbidden_modules() -> "list[str]":
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = process_start()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ.pop("REPRO_DSE_CACHE", None)      # no sweep cache serves
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

    from chipbench import catalog, cell
    from chipbench.reference.sweep import cpu_workers

    spec = catalog.find(args.workload, ROOT)
    t = time.perf_counter()
    import torch
    torch_import_s = time.perf_counter() - t
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    out = cell.run(spec, args.seed % 2**63, args.seconds, bool(args.trace),
                   device=torch.device("cuda"), process_start=start,
                   workers=cpu_workers())
    out["phases"]["torch_import_s"] = torch_import_s
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
