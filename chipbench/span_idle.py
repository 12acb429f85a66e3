"""The device's idle time in a traced window, split exactly among the
program's own spans (``repro_torch.tracing.SPANS``), and a traced run of
one cell that reports that split beside the kernel's phase clocks.

``split`` gives every instant of device idle in the window to the
innermost program span open on the host at that instant, and instants
under no program span to ``(none)``; the benchmark's wrappers
(``cell.SPANNED``, the window span) and the profiler's ``cpu_op`` events
are passed over.  The parts sum to the window less the device's busy
time, as ``devtrace.reduce`` measures both.  (``devtrace.reduce``'s
``gaps`` give each whole gap to the innermost host event at its
midpoint instead.)

    python3 chipbench/span_idle.py --workload md_knn.pruned --seed 7 \\
        --seconds 51 [--spans 0]

runs ``cell.run`` traced on the CUDA device, as ``run.py --trace 1``
does, and prints one JSON line: the result line's per-layer metrics and
check, the window's sweeps and ``sweep_s``, the idle ms a sweep under
each span, the program's counters a sweep, and one launch of the
``cycle_lanes`` profiling instantiation over the lanes a sweep of the
cell launches (``batched_cycle.profile_lanes``), made after the window.
``--spans 0`` runs the same window with the program's spans off, for
what they cost when on.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

NONE = "(none)"


def _labelled(spans: "list[tuple[float, float, str]]", lo: float,
              hi: float) -> "list[tuple[float, float, str]]":
    """``[lo, hi]`` cut into ``(start, end, label)`` pieces: the
    innermost of the nested ``spans`` open over each piece, or
    ``NONE``."""
    out: list = []
    stack: list = []                     # (end, name), innermost last
    t = lo

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        if s > t:
            out.append((t, s, stack[-1][1] if stack else NONE))
            t = s
        stack.append((e, name))
    close(float("inf"))
    out.append((t, max(t, hi), NONE))
    return [(max(s, lo), min(e, hi), n) for s, e, n in out
            if min(e, hi) > max(s, lo)]


def split(path: str, window_span: str, names) -> dict:
    """Idle seconds of the traced window at ``path`` under each program
    span in ``names`` (and ``NONE``); empty where the trace has no
    ``window_span``."""
    from chipbench.devtrace import DEVICE_CATS, _merged

    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == window_span]
    if not window:
        return {}
    lo = min(float(e["ts"]) for e in window)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in window)
    busy = _merged([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                         hi))
                    for e in events if e.get("cat") in DEVICE_CATS
                    and lo <= float(e["ts"]) <= hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    names = set(names)
    pieces = _labelled([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in events
                        if e.get("cat") == "user_annotation"
                        and e.get("name") in names], lo, hi)
    out: dict = {}
    i = 0
    for s, e in idle:                    # both sorted, pieces cover all
        while pieces[i][1] <= s:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < e:
            ps, pe, name = pieces[j]
            out[name] = out.get(name, 0.0) + (min(e, pe) - max(s, ps)) * 1e-6
            j += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    os.environ.pop("REPRO_DSE_CACHE", None)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

    import contextlib
    import time

    import torch

    from chipbench import catalog, cell, devtrace
    from chipbench.reference.sweep import cpu_workers
    from repro_torch import tracing
    from repro_torch.core.bench import BENCHMARKS
    from repro_torch.core.dse import surrogate as sg
    from repro_torch.core.dse.sweep import DesignPoint, schedule_config_for
    from repro_torch.core.sim.batched_cycle import profile_lanes
    from repro_torch.core.sim.prepared import prepare_trace

    start = time.time()
    spec = catalog.find(args.workload, root)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    seed = args.seed % 2**63
    seen: dict = {}
    reduce = devtrace.reduce

    def reduce_and_split(path, window_span):
        seen["split"] = split(path, window_span, tracing.SPANS)
        seen["summary"] = reduce(path, window_span)
        return seen["summary"]

    devtrace.reduce = reduce_and_split
    if not args.spans:
        tracing.span = lambda name: contextlib.nullcontext()
    out = cell.run(spec, seed, args.seconds, True, device=dev,
                   process_start=start, workers=cpu_workers())
    sweeps = out["attempted"]
    counts = tracing.counts()

    bench = BENCHMARKS[spec.config["bench"]]
    pt = prepare_trace(bench.gen_trace(bench.Params(**spec.config["params"],
                                                    seed=seed)))
    mix = spec.traffic
    designs = [DesignPoint(*d) for d in mix["designs"]]
    unrolls = tuple(mix["unrolls"])
    grid = [(dp, u) for dp in designs for u in unrolls]
    if mix["prune"] == "surrogate":      # the band, as cell.run has it
        margin = sg.DEFAULT_MARGIN if mix["margin"] is None \
            else mix["margin"]
        keep = sg.select_band(sg.grid_predictions(pt, designs, unrolls),
                              margin)
        grid = [g for g, k in zip(grid, keep) if k]
    phases = profile_lanes(pt, [schedule_config_for(pt, dp, u,
                                                    mix["mem_latency"])
                                for dp, u in grid], dev)
    dp, u = grid[phases["lane"]]
    phases["design"] = f"{dp.label}@u{u}"
    print(json.dumps({
        "workload": args.workload, "seed": seed, "spans": args.spans,
        "card": torch.cuda.get_device_name(dev),
        "correct": out["correct"], "sweeps": sweeps,
        "window_s": out["device"]["window_s"],
        "sweep_s": out["device"]["window_s"] / sweeps,
        "trace_window_s": seen["summary"]["trace_window_s"],
        "busy_s": seen["summary"]["busy_s"],
        "idle_ms_per_sweep": {k: v * 1e3 / sweeps for k, v in sorted(
            seen["split"].items(), key=lambda kv: -kv[1])},
        "counts_per_sweep": {k: v / counts["dse.sweeps"]
                             for k, v in counts.items()},
        "lane_phases": phases, "metrics": out["metrics"],
        "breakdown": out.get("breakdown")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
