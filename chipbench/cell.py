"""One run of one cell: set-up, the measured window, the per-layer
readings, and the comparison with the reference.

The window drives the program's sweep runner,
``repro_torch.core.dse.runner.run_sweep``, over the cell's trace, whole
sweeps one after another until the asked seconds have passed; a sweep
is the grid (or, pruned, its surrogate band) scheduled, costed and
reduced to its Pareto fronts.  Set-up builds the ``cycle_lanes``
library (first run in a checkout only), generates the trace from the
seed, prepares it and runs one sweep, which warms every shape the
window uses.  After the window the reference sweeps the same grid from
its own trace and the judged sweep is compared with it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import operator
import os
import statistics
import tempfile
import time

from chipbench import devtrace, judge
from chipbench.catalog import Cell
from chipbench.reference import sweep as ref_sweep

WINDOW_SPAN = "chipbench.sweep"
RANK_MIN_S = 0.25           # least host time a ranking reading spans

# program functions that get a span in a traced run, where they exist:
# each is looked up through its module when it is called
SPANNED = (
    ("repro_torch.core.dse.runner", "_evaluate"),
    ("repro_torch.core.dse.runner", "_run_pruned"),
    ("repro_torch.core.dse.runner", "evaluate_points"),
    ("repro_torch.core.dse.surrogate", "grid_predictions"),
    ("repro_torch.core.dse.surrogate", "select_band"),
    ("repro_torch.core.dse.sweep", "schedule_config_for"),
    ("repro_torch.core.dse.sweep", "point_from_schedule"),
    ("repro_torch.core.sim.batched_cycle", "schedule_batched"),
    ("repro_torch.core.sim.batched_cycle", "schedule_front"),
    ("repro_torch.core.sim.batched_cycle", "_lane_inputs"),
    ("repro_torch.core.sim.batched_cycle", "lane_outputs"),
    ("repro_torch.core.dse.pareto", "pareto_front"),
)


@dataclasses.dataclass
class Reading:
    """What the per-layer metric readers read (``chipbench/metrics``)."""
    workload: str
    traffic: dict
    sweeps: int
    window_s: float
    points: list              # the judged sweep's points, as dicts
    lanes: int                # lanes the card schedules a sweep
    n_nodes: int
    n_edges: int
    device: dict              # devtrace.reduce's summary ({} if none)
    rank_s: "float | None"    # host seconds of one surrogate ranking


def _point_dict(p) -> dict:
    return dataclasses.asdict(p)


@contextlib.contextmanager
def _spans(record_function):
    saved = []
    try:
        for mod_name, attr in SPANNED:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=f"{mod_name}.{attr}", **k):
                with record_function(_name):
                    return _fn(*a, **k)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
        process_start: float, workers: int, params: "dict | None" = None,
        traffic: "dict | None" = None) -> dict:
    """One run; returns the result line's object.  ``params`` and
    ``traffic`` override the configuration's sizes and the traffic mix
    (the CPU tests' small runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.bench import BENCHMARKS
    from repro_torch.core.dse import pareto as pareto_mod
    from repro_torch.core.dse import runner
    from repro_torch.core.dse.sweep import DesignPoint
    from repro_torch.core.sim.prepared import prepare_trace

    cuda = device.type == "cuda"
    phases = {"imports_s": time.time() - process_start}
    params = dict(cell.config["params"] if params is None else params)
    mix = dict(cell.traffic if traffic is None else traffic)
    build_s = 0.0
    t = time.perf_counter()
    if cuda:
        from repro_torch.kernels import _build
        build_s = _build.build_all(("cycle_lanes",))
        _build.load("cycle_lanes")
        torch.cuda.init()
    phases["load_s"] = time.perf_counter() - t

    bench = BENCHMARKS[cell.config["bench"]]
    t = time.perf_counter()
    tr = bench.gen_trace(bench.Params(**params, seed=seed))
    phases["trace_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pt = prepare_trace(tr)
    phases["prepare_s"] = time.perf_counter() - t
    designs = [DesignPoint(k, r, w, b) for k, r, w, b in mix["designs"]]
    unrolls = tuple(mix["unrolls"])
    fronts = tuple(mix["fronts"])

    def one_sweep():
        with record_function(WINDOW_SPAN):
            pts = runner.run_sweep(pt, designs, unrolls,
                                   mem_latency=mix["mem_latency"],
                                   cache=None, prune=mix["prune"],
                                   margin=mix["margin"], device=device)
            fr = {c: [(p.design, p.unroll) for p in pareto_mod.pareto_front(
                pts, cost=operator.attrgetter(c))] for c in fronts}
        return pts, fr

    t = time.perf_counter()
    one_sweep()                                   # warms every shape
    if cuda:
        torch.cuda.synchronize()
    phases["warm_s"] = time.perf_counter() - t
    setup_s = time.time() - process_start

    results = []
    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]
                       if cuda else [ProfilerActivity.CPU])
        prof.__enter__()
    try:
        with _spans(record_function) if trace \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            ends = []
            while True:
                results.append(one_sweep())
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    summary: dict = {}
    if prof is not None and cuda:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            summary = devtrace.reduce(path, WINDOW_SPAN)
        finally:
            os.remove(path)
    prof = None

    rank_s = None
    lanes = len(designs) * len(unrolls)
    if mix["prune"] == "surrogate":
        from repro_torch.core.dse import surrogate as sg
        margin = sg.DEFAULT_MARGIN if mix["margin"] is None \
            else mix["margin"]
        keep = sg.select_band(sg.grid_predictions(pt, designs, unrolls),
                              margin)
        lanes = sum(keep)
        if trace:
            n, t1 = 0, time.perf_counter()
            while time.perf_counter() - t1 < RANK_MIN_S:
                sg.select_band(sg.grid_predictions(pt, designs, unrolls),
                               margin)
                n += 1
            rank_s = (time.perf_counter() - t1) / n

    last_pts, last_fronts = results[-1]
    judged = [_point_dict(p) for p in last_pts]
    differing = sum(1 for pts, fr in results
                    if fr != last_fronts
                    or [_point_dict(p) for p in pts] != judged)
    reading = Reading(workload=cell.name, traffic=mix, sweeps=len(results),
                      window_s=window_s, points=judged, lanes=lanes,
                      n_nodes=tr.n_nodes, n_edges=int(tr.pred_idx.size),
                      device=summary, rank_s=rank_s)
    n_sweeps = len(results)
    del results, last_pts, pt, tr
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = ref_sweep.sweep(str(cell.generator), params, seed, mix["designs"],
                          unrolls, mix["mem_latency"], workers=workers)
    phases["reference_s"] = time.perf_counter() - t
    verdict = judge.judge(judged, last_fronts, ref,
                          exhaustive=mix["prune"] is None,
                          sweeps_differing=differing)
    correct = judge.passes(verdict["numbers"])

    metrics = {}
    if trace:
        for entry, reader in cell.per_layer:
            v = reader.read(reading)
            if v is not None:
                metrics[entry["name"]] = {"value": float(v),
                                          "unit": entry["unit"]}
    else:
        values = {"sweep_s": window_s / n_sweeps, "setup_s": setup_s}
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": values[entry["name"]],
                                      "unit": entry["unit"]}

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    # a sweep fails when its answer differs from the reference's: all of
    # them where the judged one is wrong, else those that differ from it
    judged_ok = verdict["numbers"]["mismatches"] == differing
    out = {"correct": bool(correct), "attempted": n_sweeps,
           "failed": differing if judged_ok else n_sweeps,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary.get("busy_s", 0.0)
        dev["window_s"] = window_s
        if summary:
            out["breakdown"] = devtrace.breakdown(summary)
    out["build_s"] = build_s
    out["phases"] = phases
    durs = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    out["sweep_quartiles_s"] = (statistics.quantiles(durs, n=4)
                                if len(durs) > 1 else durs * 3)
    out["check_parts"] = verdict["parts"]
    out["checks"] = {k: {"value": v, "limit": judge.LIMITS[k]}
                     for k, v in verdict["numbers"].items()}
    return out
