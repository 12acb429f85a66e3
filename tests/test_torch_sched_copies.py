"""The port's copies on the DSE timing path against the JAX package's
modules, on the CPU.

Every copy the batched timing backend needs is held equal to the
reference it copies: the benchmark traces (TINY and full size, array for
array and by fingerprint), the prepared-trace analysis with its padded
device views, the arbitration descriptors with their device limits and
the NTX leaf-path tables, the sweep's configuration and costing, the Pareto
fronts, the locality helpers and the event-log codes.  The remap
steering rule of the backend is held to the port's functional replay.
``tests/golden_schedule_full.json`` is recomputed for three benchmarks
through the reference's C loop, so the file cannot drift.  All checks
are exact (no tolerance).
"""
import dataclasses
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import locality as ref_locality
from repro.core.bench import BENCHMARKS as REF_BENCHMARKS
from repro.core.bench import get_trace as ref_get_trace
from repro.core.dse import pareto as ref_pareto
from repro.core.sim import arbiter as ref_arbiter
from repro.core.sim import events as ref_events
from repro.core.sim import prepare_trace as ref_prepare
from repro.core.sim import trace as ref_trace
from repro.core.sim.scheduler import ScheduleResult as RefScheduleResult
from repro.core.sim.scheduler import schedule as ref_schedule
from repro_torch.core import locality
from repro_torch.core.amm import replay as rp
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.bench import BENCHMARKS, PAPER_FIG4, SERVING, get_trace
from repro_torch.core.dse import pareto
from repro_torch.core.sim import arbiter, events, prepare_trace, trace
from repro_torch.core.sim.batched_cycle import remap_write_step
from repro_torch.core.sim.scheduler import ScheduleResult

# the modules (``repro.core.dse`` and ``repro_torch.core.dse`` export a
# ``sweep`` function too)
ref_sweep = importlib.import_module("repro.core.dse.sweep")
sweep = importlib.import_module("repro_torch.core.dse.sweep")

HERE = pathlib.Path(__file__).parent
BENCHES = tuple(REF_BENCHMARKS)
GOLDEN_FULL = json.loads((HERE / "golden_schedule_full.json").read_text())
# the golden matrix's designs (tests/test_golden_schedule.py::_DESIGNS)
GOLDEN_DESIGNS = (
    ("banked", 1, 1, 4), ("banked", 1, 1, 32), ("multipump", 2, 2, 1),
    ("hb_ntx", 2, 2, 1), ("lvt", 4, 2, 1), ("ideal", 2, 2, 1),
    ("h_ntx_rd", 4, 1, 1), ("b_ntx_wr", 1, 2, 1), ("remap", 2, 2, 1),
    ("h_ntx_rd", 4, 1, 4), ("hb_ntx", 4, 2, 4), ("lvt", 4, 2, 4),
    ("remap", 4, 2, 4))
TRACE_FIELDS = ("kinds", "array_ids", "addrs", "pred_ptr", "pred_idx")


def assert_same_array(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_same_trace(got, want):
    for f in TRACE_FIELDS:
        assert_same_array(getattr(got, f), getattr(want, f), f)
    assert got.array_names == want.array_names
    assert got.word_bytes == want.word_bytes
    assert got.name == want.name


def test_registry_and_trace_constants_match_reference():
    assert tuple(BENCHMARKS) == BENCHES
    from repro.core.bench import PAPER_FIG4 as R4, SERVING as RS
    assert PAPER_FIG4 == R4 and SERVING == RS
    for name in ("LOAD", "STORE", "FADD", "FMUL", "FDIV", "IADD", "IMUL",
                 "ICMP", "LOGIC", "KIND_NAMES", "FU_CLASS", "LATENCY"):
        assert getattr(trace, name) == getattr(ref_trace, name), name
    for name in ("PATH_COMPUTE", "PATH_DIRECT", "PATH_PARITY",
                 "PATH_STEERED", "PATH_PAIR_RMW", "PATH_BROADCAST",
                 "PATH_NAMES"):
        assert getattr(events, name) == getattr(ref_events, name), name
    ev = events.EventLog.empty(3)
    assert ev == events.EventLog.from_packed(np.full(12, -1, np.int64))
    assert ev.n_nodes == 3 and ev.copy() == ev
    for name in ("KIND_IDS", "N_FIELDS", "STALL_KEYS", "_NTX_KINDS",
                 "STALL_BANK", "STALL_PARITY", "STALL_PAIR", "F_KIND",
                 "F_TREE_DEPTH"):
        assert getattr(arbiter, name) == getattr(ref_arbiter, name), name


@pytest.mark.parametrize("bench", BENCHES)
def test_tiny_and_full_traces_match_reference(bench):
    for full in (False, True):
        got, want = get_trace(bench, full=full), ref_get_trace(bench,
                                                               full=full)
        assert_same_trace(got, want)
        assert prepare_trace(got).fingerprint == \
            ref_prepare(want).fingerprint
    assert get_trace(bench) is get_trace(bench)        # memoised


@pytest.mark.parametrize("bench", BENCHES)
def test_prepared_trace_and_device_views_match_reference(bench):
    got, want = prepare_trace(get_trace(bench)), \
        ref_prepare(ref_get_trace(bench))
    for f in ("succ_ptr", "succ_idx", "indegree", "height", "depth",
              "is_load_np", "latency_np", "word_index_np", "klass_np"):
        assert_same_array(getattr(got, f), getattr(want, f), f)
    for f in ("array_depths", "loads_per_array", "stores_per_array",
              "locality", "n_arrays", "name", "n_nodes"):
        assert getattr(got, f) == getattr(want, f), f
    dg, dw = got.device_views(), want.device_views()
    for f in dataclasses.fields(dg):
        a, b = getattr(dg, f.name), getattr(dw, f.name)
        if isinstance(b, np.ndarray):
            assert_same_array(a, b, f.name)
        else:
            assert a == b, f.name
    assert dg.signature == dw.signature
    assert got.trace.depths() is got.depth


def test_locality_helpers_match_reference():
    rng = np.random.default_rng(3)
    addrs = rng.integers(0, 4096, 500) * 4
    ids = rng.integers(0, 4, 500)
    assert locality.per_array_locality(addrs, ids) == \
        ref_locality.per_array_locality(addrs, ids)
    assert locality.trace_locality(addrs, ids) == \
        ref_locality.trace_locality(addrs, ids)
    assert locality.trace_locality(addrs[:0], ids[:0]) == 0.0


def _spec_pairs():
    """(port spec, reference spec) for every DEFAULT_DESIGNS entry and
    every golden design at three depths."""
    from repro.core.amm.spec import AMMSpec as RefSpec
    out = []
    for depth in (16, 256, 4096):
        for dp in sweep.DEFAULT_DESIGNS:
            s = sweep._spec_for(dp, depth, 32)
            out.append((s, RefSpec(s.kind, s.n_read, s.n_write, s.depth,
                                   s.width, n_banks=s.n_banks)))
        for kind, r, w, nb in GOLDEN_DESIGNS:
            s = sweep._spec_for(sweep.DesignPoint(kind, r, w, nb), depth, 64)
            out.append((s, RefSpec(s.kind, s.n_read, s.n_write, s.depth,
                                   s.width, n_banks=s.n_banks)))
    return out


SPEC_PAIRS = _spec_pairs()


@pytest.mark.parametrize("ppb", [1, 2])
def test_descriptors_limits_and_leaf_tables_match_reference(ppb):
    for got_spec, ref_spec in SPEC_PAIRS:
        got = arbiter.compile_spec(got_spec, ppb)
        want = ref_arbiter.compile_spec(ref_spec, ppb)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.row() == want.row()
        mem = {0: got_spec, 2: got_spec}
        rmem = {0: ref_spec, 2: ref_spec}
        dg = arbiter.compile_descriptors(mem, 4, ppb)
        dw = ref_arbiter.compile_descriptors(rmem, 4, ppb)
        assert_same_array(arbiter.descriptor_matrix(dg),
                          ref_arbiter.descriptor_matrix(dw), "matrix")
        assert arbiter.device_limits(dg) == ref_arbiter.device_limits(dw)


@pytest.mark.parametrize("tree_depth,levels", [(8, 0), (16, 1), (64, 2),
                                               (256, 3)])
def test_ntx_tables_match_reference(tree_depth, levels):
    for a, b in zip(arbiter.ntx_tables(tree_depth, levels),
                    ref_arbiter.ntx_tables(tree_depth, levels)):
        assert_same_array(a, b, "ntx table")


def _result(seed: int, names) -> "tuple[ScheduleResult, RefScheduleResult]":
    rng = np.random.default_rng(seed)
    cycles = int(rng.integers(50, 5000))
    kw = dict(cycles=cycles, issued=int(rng.integers(cycles, 4 * cycles)),
              mem_issued=int(rng.integers(10, cycles)),
              bank_conflict_stalls=int(rng.integers(0, 99)),
              parity_fanout_stalls=int(rng.integers(0, 99)),
              write_pair_stalls=int(rng.integers(0, 99)),
              parity_path_reads=int(rng.integers(0, 99)),
              write_pair_rmws=int(rng.integers(0, 99)),
              per_array_accesses={a: int(rng.integers(0, 99)) for a in names},
              avg_mem_parallelism=float(rng.random() * 4))
    return ScheduleResult(**kw), RefScheduleResult(**kw)


@pytest.mark.parametrize("bench", ["gemm_ncubed", "spmv_crs", "moe_route"])
def test_config_and_costing_match_reference(bench):
    pt, rpt = prepare_trace(get_trace(bench)), \
        ref_prepare(ref_get_trace(bench))
    assert sweep.DEFAULT_UNROLLS == ref_sweep.DEFAULT_UNROLLS
    assert sweep._BASE_FU == ref_sweep._BASE_FU
    assert sweep._MIN_CYCLE_NS == ref_sweep._MIN_CYCLE_NS
    assert [f.name for f in dataclasses.fields(sweep.DSEPoint)] == \
        [f.name for f in dataclasses.fields(ref_sweep.DSEPoint)]
    seed = 0
    for dp, rdp in zip(sweep.DEFAULT_DESIGNS, ref_sweep.DEFAULT_DESIGNS):
        for u in sweep.DEFAULT_UNROLLS:
            cfg = sweep.schedule_config_for(pt, dp, u, 3)
            rcfg = ref_sweep.schedule_config_for(rpt, rdp, u, 3)
            assert cfg.fu_counts == rcfg.fu_counts
            assert (cfg.mem_latency, cfg.ports_per_bank, cfg.max_cycles) \
                == (rcfg.mem_latency, rcfg.ports_per_bank, rcfg.max_cycles)
            assert {a: dataclasses.asdict(s) for a, s in cfg.mem.items()} \
                == {a: dataclasses.asdict(s) for a, s in rcfg.mem.items()}
            res, rres = _result(seed, pt.trace.array_names)
            seed += 1
            assert res.stall_breakdown() == rres.stall_breakdown()
            assert res.summary() == rres.summary()
            got = sweep.point_from_schedule(pt, dp, u, cfg, res)
            want = ref_sweep.point_from_schedule(rpt, rdp, u, rcfg, rres)
            assert got.row() == want.row()
            assert got.total_stalls == want.total_stalls


def test_pareto_matches_reference():
    rng = np.random.default_rng(11)
    fields = [f.name for f in dataclasses.fields(sweep.DSEPoint)][:13]
    rows = []
    for i in range(60):
        rows.append(dict(zip(fields, [
            "b", f"d{i % 7}", bool(i % 2), 1 + i % 4,
            int(rng.integers(100, 900)), 1.0,
            float(rng.integers(1, 40)), float(rng.integers(1, 30)),
            float(rng.random() * 9), 0, 0, 0, 1.0])))
    pts = [sweep.DSEPoint(**r) for r in rows]
    rpts = [ref_sweep.DSEPoint(**r) for r in rows]
    for cost in (lambda p: p.area_mm2, lambda p: p.power_mw):
        got = pareto.pareto_front(pts, cost)
        want = ref_pareto.pareto_front(rpts, cost)
        assert [p.row() for p in got] == [p.row() for p in want]
        for t in (5.0, 17.0, 100.0):
            assert pareto.cost_at_time(got, t, cost) == \
                ref_pareto.cost_at_time(want, t, cost)
    bank = [p for p in pts if not p.is_amm]
    amm = [p for p in pts if p.is_amm]
    assert pareto.design_space_expansion(bank, amm) == \
        ref_pareto.design_space_expansion(
            [p for p in rpts if not p.is_amm], [p for p in rpts if p.is_amm])
    assert np.isnan(pareto.design_space_expansion([], amm))


@pytest.mark.parametrize("n_write,seed", [(2, 23), (3, 5), (1, 8)])
def test_remap_write_step_matches_replay_steering(n_write, seed):
    """The backend's steering rule, step by step, against the port's
    functional replay (``core/amm/replay._remap_step``): the same banks,
    no two writes of a cycle in one bank, the same final live map."""
    spec = AMMSpec("remap", 2, n_write, 64)
    nb = n_write + 1
    n_cycles = 120
    rng = np.random.default_rng(seed)
    wa = rng.integers(0, spec.depth, (n_cycles, n_write)).astype(np.int32)
    wv = rng.integers(0, 2**32, (n_cycles, n_write), dtype=np.uint32)
    wm = rng.random((n_cycles, n_write)) < 0.8
    ra = np.zeros((n_cycles, spec.n_read), np.int32)
    state = rp.init_flat(spec, device="cpu")
    state, res = rp.replay(spec, state, torch.from_numpy(ra),
                           torch.from_numpy(wa), rp.words(wv, "cpu"),
                           torch.from_numpy(wm), device="cpu")
    live = torch.zeros(spec.depth, dtype=torch.int32)
    for t in range(n_cycles):
        ruse = torch.zeros(nb, dtype=torch.int32)
        wuse = torch.zeros(nb, dtype=torch.int32)
        banks = []
        for p in range(n_write):
            if not wm[t, p]:
                continue
            ok, bank, live, ruse, wuse = remap_write_step(
                live, ruse, wuse, int(wa[t, p]), nb, ppb=2)
            assert ok, (t, p)
            assert bank == int(res.write_banks[t, p]), (t, p)
            banks.append(bank)
        assert len(set(banks)) == len(banks), t
    assert torch.equal(live, state["map"].to(torch.int32))
    # a full cycle stalls and leaves the state alone
    ruse = torch.full((nb,), 2, dtype=torch.int32)
    ok, bank, live2, ruse2, _ = remap_write_step(
        live, ruse, torch.zeros(nb, dtype=torch.int32), 0, nb, ppb=2)
    assert (ok, bank) == (False, -1)
    assert torch.equal(live2, live) and torch.equal(ruse2, ruse)


@pytest.mark.parametrize("bench", ["bfs_queue", "paged_kv", "moe_route"])
def test_golden_full_rows_recomputed_by_reference_c_loop(bench):
    """The full-size golden rows of three benchmarks, scheduled again by
    the reference's C loop: the file is the reference's output."""
    import sys
    sys.path.insert(0, str(HERE.parent / "tools"))
    from gen_golden_schedule_full import bench_rows

    rows = [r for r in GOLDEN_FULL if r["bench"] == bench]
    assert len(rows) == len(sweep.DEFAULT_DESIGNS) * len(
        sweep.DEFAULT_UNROLLS)
    got, _ = bench_rows(bench)
    assert got == rows
    assert {r["bench"] for r in GOLDEN_FULL} == set(BENCHES)
    assert len(GOLDEN_FULL) == len(BENCHES) * len(rows)
    # the reference's own schedule on one row, as a spot check
    rpt = ref_prepare(ref_get_trace(bench, full=True))
    rdp = ref_sweep.DEFAULT_DESIGNS[0]
    res = ref_schedule(rpt, ref_sweep.schedule_config_for(rpt, rdp, 1),
                       backend="c")
    assert res.cycles == rows[0]["cycles"]
