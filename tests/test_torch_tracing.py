"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

A sweep run under ``torch.profiler`` records each span of ``SPANS`` that
its path reaches, nested in ``dse.sweep`` and once per launch or call;
the same sweep with no profiler constructs no ``record_function`` and
returns the same points.  The counters count the lanes handed to
``cycle_lanes``, the lanes the front cap drops and the bytes copied to
the device, which hold no per-word table.

The plain lanes run thousands of torch operators a simulated cycle, so
the profiler's collection is paused inside each ``cycle_lanes`` call:
the spans lie outside it.
"""
import ast
import dataclasses
import json
import pathlib
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_sched_util import golden_configs, one_thread  # noqa: F401
from repro_torch import tracing
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.bench import get_trace
from repro_torch.core.dse.pareto import pareto_front
from repro_torch.core.dse.runner import run_sweep
from repro_torch.core.dse.sweep import DEFAULT_DESIGNS
from repro_torch.core.sim import batched_cycle, prepare_trace
from repro_torch.core.sim.batched_cycle import profile_lanes
from repro_torch.kernels import ops

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
UNROLLS = (1, 4)
BATCH_LANES = 8
# (bench, designs, prune): an exhaustive sweep over a few designs, and a
# pruned one whose front cap drops lanes
CASES = {"exhaustive": ("gemm_ncubed", DEFAULT_DESIGNS[::4], None),
         "pruned": ("sort_merge", DEFAULT_DESIGNS, "surrogate")}


def _forbid_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _sweep(pt, designs, prune):
    return run_sweep(pt, designs, UNROLLS, device="cpu", prune=prune)


def _spans(path) -> "list[tuple[str, float, float]]":
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name") in tracing.SPANS]


def _profile_outside_the_kernel(monkeypatch):
    """A CPU profile whose collection pauses inside each ``cycle_lanes``
    call."""
    prof = profile(activities=[ProfilerActivity.CPU])
    kernel = ops.cycle_lanes

    def quiet(*a, **k):
        prof.toggle_collection_dynamic(False, [ProfilerActivity.CPU])
        try:
            return kernel(*a, **k)
        finally:
            prof.toggle_collection_dynamic(True, [ProfilerActivity.CPU])

    monkeypatch.setattr(ops, "cycle_lanes", quiet)
    return prof


def _parent(child, spans):
    """The innermost other span that holds ``child``, or None."""
    name, s, e = child
    holders = [p for p in spans if p is not child
               and p[1] <= s and e <= p[2]]
    return min(holders, key=lambda p: p[2] - p[1])[0] if holders else None


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", sorted(CASES))
def test_a_traced_sweep_records_its_spans_and_counts_its_lanes(
        case, tmp_path, monkeypatch):
    bench, designs, prune = CASES[case]
    pt = prepare_trace(get_trace(bench))
    monkeypatch.setattr(batched_cycle, "BATCH_LANES", BATCH_LANES)

    with monkeypatch.context() as m:
        _forbid_record_function(m)
        plain = _sweep(pt, designs, prune)

    prof = _profile_outside_the_kernel(monkeypatch)
    before = tracing.counts()
    with prof:
        traced = _sweep(pt, designs, prune)
        pareto_front(traced)
    after = tracing.counts()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = _spans(tmp_path / "trace.json")

    assert [dataclasses.asdict(p) for p in traced] == \
        [dataclasses.asdict(p) for p in plain]
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    grid = len(designs) * len(UNROLLS)
    lanes = delta["batch.lanes"]
    launches = -(-lanes // BATCH_LANES)
    if prune is None:
        assert lanes == grid > BATCH_LANES
        want = {}
    else:
        assert 0 < lanes < grid            # the band
        assert delta["dse.front_cap.dropped"] == lanes - len(traced) > 0
        want = {"dse.rank": 1, "dse.front_cap": 2}
    want.update({"dse.sweep": 1, "dse.configs": 1, "dse.fold": launches + 1,
                 "dse.pareto": 1, "batch.descriptors": launches,
                 "batch.layout": launches, "batch.h2d": launches})
    assert delta["dse.sweeps"] == 1
    assert {n: sum(s[0] == n for s in spans) for n in tracing.SPANS
            if any(s[0] == n for s in spans)} == want
    for s in spans:
        outer = None if s[0] in ("dse.sweep", "dse.pareto") else \
            "dse.sweep"
        assert _parent(s, spans) == outer, s


# an NTX and a remap design: lanes with per-word state (NTX leaf paths,
# the remap live map)
DEEP = [dp for dp in DEFAULT_DESIGNS if dp.kind in ("hb_ntx", "remap")][:2]


@pytest.mark.usefixtures("one_thread")
def test_a_traced_sweep_opens_no_tables_span(tmp_path, monkeypatch):
    """The batch layer builds no per-word table, so a traced sweep over
    NTX and remap lanes opens no span for one, and ``SPANS`` names
    none."""
    pt = prepare_trace(get_trace("nw"))
    prof = _profile_outside_the_kernel(monkeypatch)
    with prof:
        run_sweep(pt, DEEP, (1,), device="cpu")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    opened = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert "batch.descriptors" in opened and "batch.layout" in opened
    assert not any("tables" in name for name in opened)
    assert not any("tables" in name for name in tracing.SPANS)


def test_h2d_bytes_counts_the_arrays_lane_outputs_is_given(monkeypatch):
    pt, _, cfgs = golden_configs("nw")
    sc, ins = batched_cycle._lane_inputs(pt, cfgs[:3])
    monkeypatch.setattr(ops, "cycle_lanes", lambda *a, **k: ())
    before = tracing.counts().get("batch.h2d_bytes", 0)
    batched_cycle.lane_outputs(pt, sc, ins, torch.device("cpu"))
    assert tracing.counts()["batch.h2d_bytes"] - before == \
        sum(v.nbytes for v in ins.values()) > 0


def _deeper(cfg, factor: int):
    """``cfg`` with every array's memory ``factor`` times as deep."""
    return dataclasses.replace(cfg, mem={
        a: AMMSpec(s.kind, s.n_read, s.n_write, s.depth * factor, s.width,
                   n_banks=s.n_banks) for a, s in cfg.mem.items()})


def test_h2d_bytes_do_not_grow_with_the_table_depth(monkeypatch):
    """The same TINY nw lanes at their own memory depths and at four
    times them: the per-word depth D grows fourfold, the bytes copied to
    the device do not (no array handed to the op is per word), and the op
    takes D as a number."""
    pt, _, cfgs = golden_configs("nw")
    cfgs = [c for c in cfgs if c.mem[0].kind in ("hb_ntx", "h_ntx_rd")]
    calls = []
    monkeypatch.setattr(ops, "cycle_lanes",
                        lambda *a, **k: calls.append(a) or ())
    moved, depths = [], []
    for factor in (1, 4):
        sc, ins = batched_cycle._lane_inputs(
            pt, [_deeper(c, factor) for c in cfgs])
        before = tracing.counts().get("batch.h2d_bytes", 0)
        batched_cycle.lane_outputs(pt, sc, ins, torch.device("cpu"))
        moved.append(tracing.counts()["batch.h2d_bytes"] - before)
        depths.append(sc.table_depth)
        assert calls[-1][5] == sc.table_depth
    assert depths[1] == 4 * depths[0] and moved[0] == moved[1] > 0
    assert not {"direct", "offset", "parity"} & set(ins)


def test_a_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    _forbid_record_function(monkeypatch)
    monkeypatch.setattr(tracing, "_COUNTS", Counter())
    assert tracing.span("dse.sweep") is tracing.span("dse.fold")
    with tracing.span("dse.sweep"):
        tracing.count("batch.lanes", 2)
    tracing.count("batch.lanes")
    assert tracing.counts() == {"batch.lanes": 3}


def test_every_span_the_port_opens_is_named_in_SPANS():
    opened = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "tracing"):
                assert isinstance(node.args[0], ast.Constant), path
                opened.add(node.args[0].value)
    assert opened == set(tracing.SPANS)


def test_profile_lanes_needs_the_card():
    pt, _, cfgs = golden_configs("gemm_ncubed")
    with pytest.raises(ValueError, match="CUDA"):
        profile_lanes(pt, cfgs[:2], "cpu")
