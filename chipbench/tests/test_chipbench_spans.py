"""The device's idle time split among the program's spans
(``chipbench/span_idle.py``), and the readers of the program's counters
(``batch.lanes``, ``dse.front_cap.dropped``)."""
import json
import sys
from collections import Counter

import pytest

import repro_torch
from chipbench import catalog, cell, devtrace, span_idle
from chipbench.tests._small import ROOT, few
from chipbench.tests.test_chipbench_cell import run_small
from repro_torch import tracing

WINDOW = cell.WINDOW_SPAN


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(tmp_path):
    """A window of 1000 us: the device busy over [100, 300] and [700,
    900]; the gap [300, 700] crosses three nested program spans, the gap
    [0, 100] lies under none; a wrapper of the benchmark's and host ops
    lie over the long gap."""
    events = [
        _x("user_annotation", WINDOW, 0, 1000),
        _x("kernel", "cycle_lanes_kernel", 100, 200),
        _x("gpu_memcpy", "Memcpy HtoD", 700, 200),
        _x("user_annotation", "dse.sweep", 200, 490),
        _x("user_annotation", "dse.fold", 350, 250),
        _x("user_annotation", "batch.h2d", 400, 50),
        _x("user_annotation",
           "repro_torch.core.sim.batched_cycle.schedule_front", 360, 260),
        _x("cpu_op", "aten::copy_", 420, 10),
        _x("cpu_op", "aten::empty", 50, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_idle_is_split_exactly_along_the_program_spans(tmp_path):
    path = _trace(tmp_path)
    got = span_idle.split(path, WINDOW, tracing.SPANS)
    assert got == pytest.approx({"dse.sweep": 140e-6, "dse.fold": 200e-6,
                                 "batch.h2d": 50e-6, "(none)": 210e-6})
    summary = devtrace.reduce(path, WINDOW)
    assert sum(got.values()) == pytest.approx(
        summary["trace_window_s"] - summary["busy_s"])
    # the midpoint rule gives the whole long gap to one label
    assert summary["gaps"] == pytest.approx(
        {"aten::empty": 100e-6, "dse.fold": 400e-6, WINDOW: 100e-6})


def test_split_reads_nothing_without_the_window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        _x("kernel", "k", 0, 10), _x("user_annotation", "dse.sweep", 0, 5)]}))
    assert span_idle.split(str(path), WINDOW, tracing.SPANS) == {}


def _reader(name):
    return catalog.load_reader(ROOT / "chipbench" / "metrics"
                               / f"{name}.py")


def _reading(prune, device):
    return cell.Reading(workload="x", traffic={"prune": prune}, sweeps=3,
                        window_s=1.0, points=[{"cycles": 10}], lanes=29,
                        n_nodes=100, n_edges=100, device=device,
                        rank_s=None)


TRACED = {"busy_s": 0.8, "trace_window_s": 1.0, "ops": {}, "gaps": {}}


@pytest.mark.parametrize("name, prune, want", [
    ("batch.lanes", "surrogate", 29.0), ("batch.lanes", None, 29.0),
    ("dse.front_cap.dropped", "surrogate", 3.0),
    ("dse.front_cap.dropped", None, None)])
def test_counter_readers_read_a_sweeps_share(name, prune, want,
                                             monkeypatch):
    monkeypatch.setattr(tracing, "_COUNTS", Counter(
        {"dse.sweeps": 4, "batch.lanes": 4 * 29,
         "dse.front_cap.dropped": 4 * 3}))
    reader = _reader(name)
    assert reader.read(_reading(prune, TRACED)) == want
    assert reader.read(_reading(prune, {})) is None
    # a program without the counters (no ``repro_torch.tracing``)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert reader.read(_reading(prune, TRACED)) is None


def test_counter_readers_read_the_band_of_a_cpu_run(monkeypatch):
    monkeypatch.setattr(tracing, "_COUNTS", Counter())
    out = run_small("md_knn.pruned", traffic=few, trace=True)
    assert out["correct"] is True
    band = out["metrics"]["surrogate.lanes"]["value"]
    r = _reading("surrogate", TRACED)
    assert _reader("batch.lanes").read(r) == band
    assert 0 <= _reader("dse.front_cap.dropped").read(r) < band
    assert tracing.counts()["dse.sweeps"] == out["attempted"] + 1
