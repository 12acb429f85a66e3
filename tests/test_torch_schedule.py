"""The port's batched timing backend against the reference scheduler, on
the CPU (the ``cycle_lanes`` wrapper given CPU tensors runs
``cycle_lanes_plain``).

* event logs equal to the reference C loop's
  (``schedule_events(pt, cfg, backend="c")``) for every golden design on
  three benchmarks, and to the JAX backend's on one, with the final
  remap live maps equal to JAX ``schedule_batched(return_maps=True)``;
* the three error codes raise the reference loops' exceptions;
* ``evaluate_points`` over the whole grid, in launches of 48 lanes,
  gives the reference ``run_sweep(backend="c")``'s ``DSEPoint``s field
  for field and the same Pareto fronts;
* a hypothesis fuzz of random DDGs and designs: the plain lanes equal
  the reference C loop.

Every comparison is exact (the schedule is integer; the one float,
``avg_mem_parallelism``, is the same division of the same integers).
The golden rows themselves are in ``test_torch_schedule_golden_*.py``.
"""
import importlib

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_sched_util import (golden_configs, one_thread,  # noqa: F401
                              ref_config)
from repro.core.bench import get_trace as ref_get_trace
from repro.core.sim import prepare_trace as ref_prepare
from repro.core.sim.scheduler import schedule as ref_schedule
from repro.core.sim.scheduler import schedule_events as ref_schedule_events
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.bench import get_trace
from repro_torch.core.dse import pareto
from repro_torch.core.sim import (ScheduleConfig, Trace, TraceBuilder,
                                  prepare_trace, schedule)
from repro_torch.core.sim import batched_cycle
from repro_torch.core.sim.batched_cycle import schedule_batched
from repro_torch.core.sim.trace import IADD

ref_sweep = importlib.import_module("repro.core.dse.sweep")
# the module: ``repro_torch.core.dse`` exports a function of its name
sweep = importlib.import_module("repro_torch.core.dse.sweep")
pytestmark = pytest.mark.usefixtures("one_thread")


def assert_same_result(got, want):
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("bench", ["paged_kv", "kv_decode", "spmv_crs"])
def test_event_logs_match_reference_c_loop(bench):
    pt, rows, cfgs = golden_configs(bench)
    results, logs = schedule_batched(pt, cfgs, device="cpu",
                                     collect_events=True)
    rpt = ref_prepare(ref_get_trace(bench))
    for g, cfg, res, log in zip(rows, cfgs, results, logs):
        rres, rlog = ref_schedule_events(rpt, ref_config(rpt, cfg),
                                         backend="c")
        assert_same_result(res, rres)
        for f in ("cycle", "path", "resource", "slot"):
            np.testing.assert_array_equal(getattr(log, f), getattr(rlog, f),
                                          err_msg=f"{g['design']} {f}")
            assert getattr(log, f).dtype == np.int64
    # the recording variant schedules exactly as the plain one
    assert results == schedule_batched(pt, cfgs, device="cpu")


def test_event_logs_and_remap_maps_match_jax():
    from repro.core.sim import jax_cycle

    bench = "kv_decode"
    pt, rows, cfgs = golden_configs(bench)
    results, maps, logs = schedule_batched(pt, cfgs, device="cpu",
                                           return_maps=True,
                                           collect_events=True)
    rpt = ref_prepare(ref_get_trace(bench))
    jres, jmaps, jlogs = jax_cycle.schedule_batched(
        rpt, [ref_config(rpt, c) for c in cfgs], return_maps=True,
        collect_events=True)
    for res, jr in zip(results, jres):
        assert_same_result(res, jr)
    for log, jlog in zip(logs, jlogs):
        for f in ("cycle", "path", "resource", "slot"):
            np.testing.assert_array_equal(getattr(log, f), getattr(jlog, f))
    np.testing.assert_array_equal(maps, np.asarray(jmaps))
    assert maps.dtype == np.int32
    assert np.any(maps != 0)              # remap designs moved some words


def test_launches_of_a_few_lanes_give_what_one_launch_gives(monkeypatch):
    """More configs than ``BATCH_LANES``: the results, the event logs and
    the remap live maps, each launch's padded with zeros to the widest
    table depth, are those of one launch."""
    pt, _, cfgs = golden_configs("kv_decode")
    one = schedule_batched(pt, cfgs, device="cpu", return_maps=True,
                           collect_events=True)
    monkeypatch.setattr(batched_cycle, "BATCH_LANES", 4)
    calls = []
    real = batched_cycle._lane_inputs

    def counted(pt, sub):
        sc, ins = real(pt, sub)
        calls.append(sc.table_depth)
        return sc, ins

    monkeypatch.setattr(batched_cycle, "_lane_inputs", counted)
    few = schedule_batched(pt, cfgs, device="cpu", return_maps=True,
                           collect_events=True)
    assert len(calls) == -(-len(cfgs) // 4) and len(set(calls)) > 1
    assert few[0] == one[0]
    np.testing.assert_array_equal(few[1], one[1])
    for log, want in zip(few[2], one[2], strict=True):
        for f in ("cycle", "path", "resource", "slot"):
            np.testing.assert_array_equal(getattr(log, f), getattr(want, f))


def test_schedule_one_design_and_empty_batch():
    pt, rows, cfgs = golden_configs("moe_route")
    rpt = ref_prepare(ref_get_trace("moe_route"))
    for cfg in cfgs[::5]:
        assert_same_result(schedule(pt, cfg, device="cpu"),
                           ref_schedule(rpt, ref_config(rpt, cfg),
                                        backend="c"))
    assert schedule_batched(pt, [], device="cpu") == []
    empty, maps, logs = schedule_batched(pt, [], device="cpu",
                                         return_maps=True,
                                         collect_events=True)
    assert empty == [] and maps.shape == (0, 0, 0) and logs == []


def _chain(n: int, arrays: int = 1):
    tb = TraceBuilder("chain")
    aids = [tb.declare_array(f"a{k}", 4) for k in range(arrays)]
    prev = ()
    for i in range(n):
        prev = (tb.load(aids[i % arrays], i % 16, prev),)
    return tb.build()


def test_errors_raise_the_reference_exceptions():
    # a memory op on an array without a spec
    tb = TraceBuilder("nospec")
    a = tb.declare_array("a", 4)
    b = tb.declare_array("b", 4)
    tb.load(a, 0)
    tb.load(b, 0)
    tr = tb.build()
    cfg = ScheduleConfig(mem={a: AMMSpec("ideal", 2, 2, 64)}, fu_counts={})
    with pytest.raises(KeyError):
        schedule(tr, cfg, device="cpu")
    # max_cycles
    cfg = ScheduleConfig(mem={0: AMMSpec("ideal", 1, 1, 64)}, fu_counts={},
                         max_cycles=5)
    with pytest.raises(RuntimeError, match="exceeded 5 cycles"):
        schedule(_chain(64), cfg, device="cpu")
    # deadlock: two nodes waiting on each other (not a trace a benchmark
    # builds; the reference loops raise the same)
    tr = Trace(kinds=np.array([IADD, IADD, 0], np.int8),
               array_ids=np.array([-1, -1, 0], np.int16),
               addrs=np.array([-1, -1, 0], np.int64),
               pred_ptr=np.array([0, 1, 2, 2], np.int64),
               pred_idx=np.array([1, 0], np.int64),
               array_names={0: "a"}, word_bytes={0: 4}, name="cycle")
    cfg = ScheduleConfig(mem={0: AMMSpec("ideal", 2, 2, 64)}, fu_counts={})
    with pytest.raises(RuntimeError, match="deadlock"):
        schedule(tr, cfg, device="cpu")
    # a lane in error fails the whole batch, as the reference does
    ok = ScheduleConfig(mem={0: AMMSpec("ideal", 1, 1, 64)}, fu_counts={})
    bad = ScheduleConfig(mem={0: AMMSpec("ideal", 1, 1, 64)}, fu_counts={},
                         max_cycles=5)
    with pytest.raises(RuntimeError, match="exceeded"):
        schedule_batched(_chain(64), [ok, bad], device="cpu")
    assert schedule_batched(_chain(64), [ok], device="cpu")[0].cycles > 64


def test_lanes_finishing_at_different_cycles_keep_their_results():
    """A batch whose lanes end hundreds of cycles apart: each lane equals
    its own batch of one (a lane that has stopped keeps its state)."""
    tr = _chain(200, arrays=2)
    cfgs = [ScheduleConfig(mem={0: AMMSpec("ideal", 4, 4, 64),
                                1: AMMSpec(k, 2, 2, 64)}, fu_counts={},
                           mem_latency=lat)
            for k, lat in (("ideal", 1), ("banked", 7), ("remap", 3),
                           ("hb_ntx", 2))]
    together = schedule_batched(tr, cfgs, device="cpu")
    assert len({r.cycles for r in together}) == len(cfgs)
    for cfg, res in zip(cfgs, together):
        assert res == schedule(tr, cfg, device="cpu")


@pytest.mark.parametrize("bench", ["paged_kv", "kv_decode", "gemm_ncubed"])
def test_sweep_batched_matches_reference_run_sweep(bench, monkeypatch):
    from repro.core.dse.runner import run_sweep

    pt = prepare_trace(get_trace(bench))
    monkeypatch.setattr(batched_cycle, "BATCH_LANES", 48)
    grid = [(dp, u) for dp in sweep.DEFAULT_DESIGNS
            for u in sweep.DEFAULT_UNROLLS]
    points = sweep.evaluate_points(pt, grid, device="cpu")
    want = run_sweep(ref_prepare(ref_get_trace(bench)), backend="c", jobs=1)
    assert [p.row() for p in points] == [p.row() for p in want]
    rfront = importlib.import_module("repro.core.dse.pareto")
    for cost in (lambda p: p.area_mm2, lambda p: p.power_mw):
        for keep in (lambda p: True, lambda p: p.is_amm,
                     lambda p: not p.is_amm):
            got = pareto.pareto_front([p for p in points if keep(p)], cost)
            ref = rfront.pareto_front([p for p in want if keep(p)], cost)
            assert [p.row() for p in got] == [p.row() for p in ref]


# ---- fuzz: random DDGs and designs, plain lanes against the C loop ----
_FU_KINDS = (2, 3, 4, 5, 6, 7, 8)
_DEPTH = 64
_DESIGNS = (("ideal", 2, 2, 1), ("banked", 4, 4, 2), ("banked", 8, 8, 4),
            ("multipump", 2, 2, 1), ("h_ntx_rd", 4, 1, 2),
            ("b_ntx_wr", 2, 2, 2), ("hb_ntx", 4, 2, 1), ("lvt", 4, 2, 1),
            ("remap", 2, 2, 1), ("remap", 4, 3, 1))


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_fuzz_plain_lanes_match_reference_c_loop(data):
    from repro.core.sim.trace import Trace as RefTrace

    draw = data.draw
    n_arrays = draw(st.integers(1, 2))
    tb = TraceBuilder("fuzz")
    for k in range(n_arrays):
        tb.declare_array(f"a{k}", 4)
    n_ops = draw(st.integers(6, 48))
    for i in range(n_ops):
        deps = tuple(sorted({draw(st.integers(0, i - 1))
                             for _ in range(draw(st.integers(0, min(2, i))))}))
        if draw(st.booleans()):
            arr = draw(st.integers(0, n_arrays - 1))
            idx = draw(st.integers(0, _DEPTH - 1))
            if draw(st.booleans()):
                tb.load(arr, idx, deps)
            else:
                tb.store(arr, idx, deps)
        else:
            tb.op(_FU_KINDS[draw(st.integers(0, 6))], *deps)
    tr = tb.build()
    cfgs = []
    for _ in range(3):        # three designs, one lane-batched call
        mem = {}
        for aid in range(n_arrays):
            kind, rd, wr, nb = _DESIGNS[draw(st.integers(0, len(_DESIGNS)
                                                         - 1))]
            mem[aid] = AMMSpec(kind, rd, wr, _DEPTH, n_banks=nb)
        cfgs.append(ScheduleConfig(
            mem=mem, fu_counts={n: draw(st.integers(1, 6))
                                for n in sweep._BASE_FU},
            mem_latency=draw(st.integers(1, 3)),
            ports_per_bank=draw(st.integers(1, 2))))
    results = schedule_batched(tr, cfgs, device="cpu")
    rpt = ref_prepare(RefTrace(**{f: getattr(tr, f) for f in (
        "kinds", "array_ids", "addrs", "pred_ptr", "pred_idx",
        "array_names", "word_bytes", "name")}))
    for cfg, res in zip(cfgs, results):
        assert_same_result(res, ref_schedule(rpt, ref_config(rpt, cfg),
                                             backend="c"))
