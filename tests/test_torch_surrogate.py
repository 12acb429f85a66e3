"""The port's surrogate-pruned sweep (``repro_torch.core.dse.surrogate``,
``PreparedTrace.mem_profile``, ``run_sweep(prune="surrogate")``) and its
on-disk trace cache, against the JAX package, on the CPU.

* the fitted coefficients and the surrogate's constants are the
  reference's;
* the memory profile is equal field for field, and every prediction,
  ``cycle_ns``, ``area_mm2`` and ``select_band`` mask is bit-equal to the
  reference's (all 15 TINY benchmarks and the 12 calibrated ones at full
  size; both are float64 numpy in the same order of operations);
* the band holds the exhaustive time/area front on all 12 TINY
  calibrated benchmarks (exhaustive points from the reference's C loop);
* the pruned sweep on the plain lanes returns the reference's
  front-capped pruned points row for row, pass after pass over one cache
  dir (the result depends on the cache, as the reference's does), each
  point equal to the reference's exhaustive point, with the exhaustive
  time/area front; the CLI's pruned rows are the reference CLI's; the
  fallbacks run the exhaustive grid;
* the trace cache round-trips, can be turned off, raises on a damaged
  file, and is keyed by the port's own module source.

The plain lanes stay cheap here: pruned sweeps of the three cheapest
TINY benchmarks, and the fallbacks on a two-point grid.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.bench as rb
import repro_torch.core.bench as tb
from repro.core.dse import _surrogate_coef as ref_coef
from repro.core.dse import runner as ref_runner
from repro.core.dse import surrogate as ref_sur
from repro.core.dse.pareto import pareto_front as ref_pareto_front
from repro.core.dse.sweep import DEFAULT_DESIGNS as REF_DESIGNS
from repro.core.sim import prepare_trace as ref_prepare
from repro_torch.core.dse import _surrogate_coef as coef
from repro_torch.core.dse import runner, surrogate
from repro_torch.core.dse.pareto import pareto_front
from repro_torch.core.dse.sweep import DEFAULT_DESIGNS, DEFAULT_UNROLLS
from repro_torch.core.sim import prepare_trace
from repro_torch.core.sim.prepared import trace_fingerprint

from _torch_sched_util import one_thread  # noqa: F401  (fixture)

CALIBRATED = sorted(ref_sur.CALIBRATED_BENCHES)
CASES = ([(b, False) for b in tb.BENCHMARKS]
         + [(b, True) for b in CALIBRATED])
MARGINS = (0.0, 0.10, 0.5)
PRUNED_BENCHES = ("spmv_crs", "gemm_ncubed", "bfs_queue")


def _case_id(case):
    bench, full = case
    return f"{bench}-{'full' if full else 'tiny'}"


def _pts(bench, full=False):
    return (prepare_trace(tb.get_trace(bench, full=full)),
            ref_prepare(rb.get_trace(bench, full=full)))


def _ref_design(dp):
    return {d.label: d for d in REF_DESIGNS}[dp.label]


def _ref_exhaustive(bench):
    """The reference's exhaustive TINY sweep on its C loop, by point."""
    pts = ref_runner.run_sweep(_pts(bench)[1], REF_DESIGNS, DEFAULT_UNROLLS,
                               backend="c", jobs=1)
    return pts, {(p.design, p.unroll): p for p in pts}


def _band(pt, margin=surrogate.DEFAULT_MARGIN):
    preds = surrogate.grid_predictions(pt, DEFAULT_DESIGNS, DEFAULT_UNROLLS)
    return [(p.design.label, p.unroll)
            for p, k in zip(preds, surrogate.select_band(preds, margin))
            if k]


def _front(points):
    return [(p.design, p.unroll) for p in pareto_front(points)]


def test_coefficients_and_constants_are_the_reference_s():
    for name in ("BASE", "PORT", "INTF", "STALL", "FIT_STATS"):
        assert getattr(coef, name) == getattr(ref_coef, name), name
    for name in ("BAND_W", "DEFAULT_MARGIN", "CALIBRATED_MEM_LATENCY",
                 "CALIBRATED_BENCHES", "CALIBRATION_UNROLLS",
                 "_STALL_FEATURES"):
        assert getattr(surrogate, name) == getattr(ref_sur, name), name
    assert {k: dataclasses.asdict(v)
            for k, v in surrogate.CALIBRATION_DESIGNS.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in ref_sur.CALIBRATION_DESIGNS.items()}
    assert [f.name for f in dataclasses.fields(
        surrogate.SurrogatePrediction)] == \
        [f.name for f in dataclasses.fields(ref_sur.SurrogatePrediction)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_mem_profile_matches_reference(case):
    pt, rpt = _pts(*case)
    got, want = pt.mem_profile(), rpt.mem_profile()
    assert pt.mem_profile() is got          # memoized per band_w
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(b, dict) and b and isinstance(
                next(iter(b.values())), np.ndarray):
            assert list(a) == list(b), f.name
            for aid in b:
                assert a[aid].dtype == b[aid].dtype, (f.name, aid)
                assert np.array_equal(a[aid], b[aid]), (f.name, aid)
        else:
            assert a == b and type(a) is type(b), f.name
    assert pt.mem_profile(4).n_bands == rpt.mem_profile(4).n_bands


def _bits(pred):
    return (pred.design.label, pred.unroll,
            [v.hex() for v in dataclasses.astuple(pred.prediction)],
            pred.cycle_ns.hex(), pred.area_mm2.hex())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_grid_predictions_and_bands_are_bit_equal(case):
    pt, rpt = _pts(*case)
    got = surrogate.grid_predictions(pt, DEFAULT_DESIGNS, DEFAULT_UNROLLS)
    want = ref_sur.grid_predictions(rpt, REF_DESIGNS, DEFAULT_UNROLLS)
    assert [_bits(p) for p in got] == [_bits(p) for p in want]
    for margin in MARGINS:
        assert surrogate.select_band(got, margin) == \
            ref_sur.select_band(want, margin), margin
    dp, u = DEFAULT_DESIGNS[5], 4
    assert [v.hex() for v in dataclasses.astuple(
        surrogate.predict(pt, dp, u))] == \
        [v.hex() for v in dataclasses.astuple(
            ref_sur.predict(rpt, _ref_design(dp), u))]


@pytest.mark.parametrize("bench", CALIBRATED)
def test_band_holds_the_exhaustive_front(bench):
    """The reference's exhaustive points restricted to the port's band
    have the exhaustive time/area front."""
    pts, by_point = _ref_exhaustive(bench)
    band = [by_point[k] for k in _band(_pts(bench)[0])]
    assert [(p.design, p.unroll) for p in ref_pareto_front(band)] == \
        [(p.design, p.unroll) for p in ref_pareto_front(pts)]


# the reference's pruned sweep over one cache dir, three passes: the
# points each returns (its misses run under the front cap, so a warm pass
# re-runs the points capped before, now without the cheaper points that
# capped them)
PRUNED_PASSES = {"spmv_crs": [24, 24, 24], "gemm_ncubed": [33, 35, 35],
                 "bfs_queue": [22, 29, 31]}


@pytest.mark.parametrize("bench", PRUNED_BENCHES)
def test_pruned_sweep_is_the_band_on_the_plain_lanes(bench, tmp_path,
                                                     capsys, one_thread):
    """Three pruned passes over one cache dir, the port's beside the
    reference's over another: each pass returns the reference's points
    row for row with its cache hits and misses, a subset of the band
    holding the exhaustive time/area front, each point the exhaustive
    one."""
    pt, rpt = _pts(bench)
    band = _band(pt)
    exhaustive, by_point = _ref_exhaustive(bench)
    front = [(p.design, p.unroll) for p in ref_pareto_front(exhaustive)]
    sizes = []
    for _ in range(3):
        cache = runner.SweepCache(tmp_path / "port")
        got = runner.run_sweep(pt, prune="surrogate", cache=cache,
                               device="cpu", verbose=True)
        err = capsys.readouterr().err
        ref_cache = ref_runner.SweepCache(tmp_path / "ref")
        want = ref_runner.run_sweep(rpt, REF_DESIGNS, DEFAULT_UNROLLS,
                                    prune="surrogate", cache=ref_cache)
        assert [p.row() for p in got] == [p.row() for p in want]
        assert (cache.hits, cache.misses) == \
            (ref_cache.hits, ref_cache.misses)
        assert cache.hits + cache.misses == len(band)
        assert f"band kept {len(band)} (margin 0.1)" in err
        capped = cache.misses - (len(got) - cache.hits)
        if cache.misses:
            assert (f"simulated {cache.misses - capped} points ({capped} "
                    f"front-capped, {cache.hits} cache hits)") in err
        assert {(p.design, p.unroll) for p in got} <= set(band)
        assert [p.row() for p in got] == \
            [by_point[(p.design, p.unroll)].row() for p in got]
        assert _front(got) == front
        sizes.append(len(got))
    assert sizes == PRUNED_PASSES[bench]


def test_pruned_cli_rows_equal_the_reference_cli(tmp_path, capsys,
                                                 one_thread):
    """Cold, with ``--prune surrogate``: the port's CSV rows, header
    included, are the reference CLI's (bfs_queue: 22 of its 31 band
    points, 9 front-capped)."""
    args = ["--bench", "bfs_queue", "--prune", "surrogate"]
    ref_runner.main(args + ["--jobs", "1", "--cache-dir",
                            str(tmp_path / "ref")])
    want = capsys.readouterr().out
    runner.main(args + ["--device", "cpu", "--cache-dir",
                        str(tmp_path / "port")])
    got = capsys.readouterr().out
    assert "points=22 " in got and "hits=0 misses=31" in got
    assert len(_csv_rows(got)) == 23
    assert _csv_rows(got) == _csv_rows(want)


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_margin_sets_the_band(margin, tmp_path, capsys):
    """``margin=`` and the CLI's ``--margin`` keep ``select_band``'s band
    at that margin, served here from a cache the reference's C loop
    filled (every point a hit, no plain lanes)."""
    pt, rpt = _pts("nw")
    ref_runner.run_sweep(rpt, cache_dir=tmp_path, backend="c", jobs=1)
    cache = runner.SweepCache(tmp_path)
    got = runner.run_sweep(pt, prune="surrogate", margin=margin,
                           cache=cache, device="cpu")
    band = _band(pt, margin)
    assert [(p.design, p.unroll) for p in got] == band
    assert (cache.hits, cache.misses) == (len(band), 0)
    assert band != _band(pt)
    runner.main(["--bench", "nw", "--device", "cpu", "--cache-dir",
                 str(tmp_path), "--prune", "surrogate", "--margin",
                 str(margin)])
    out = capsys.readouterr().out
    assert f"points={len(band)} " in out
    assert f"hits={len(band)} misses=0" in out


def test_pruned_sweep_passes_the_audit(capsys, one_thread):
    pt, _ = _pts("spmv_crs")
    got = runner.run_sweep(pt, prune="surrogate", device="cpu", check=True,
                           verbose=True)
    assert len(got) == len(_band(pt))
    assert f"legality-checked {len(got)} points" in capsys.readouterr().err


@pytest.mark.parametrize("bench,mem_latency,why", [
    ("kv_decode", 2, "trace family not in the surrogate calibration set: "
                     "running exhaustive"),
    ("spmv_crs", 3, "surrogate calibrated at mem_latency=2, got 3: running "
                    "exhaustive"),
])
def test_pruned_sweep_falls_back_to_the_whole_grid(bench, mem_latency, why,
                                                   capsys, one_thread):
    pt, rpt = _pts(bench)
    designs = DEFAULT_DESIGNS[:2]
    got = runner.run_sweep(pt, designs, (1,), mem_latency=mem_latency,
                           prune="surrogate", device="cpu", verbose=True)
    assert why in capsys.readouterr().err
    want = ref_runner.run_sweep(rpt, REF_DESIGNS[:2], (1,),
                                mem_latency=mem_latency, backend="c", jobs=1)
    assert [p.row() for p in got] == [p.row() for p in want]


def test_an_unknown_prune_raises(tmp_path):
    pt, _ = _pts("spmv_crs")
    with pytest.raises(ValueError, match="prune must be"):
        runner.run_sweep(pt, prune="random", device="cpu")
    with pytest.raises(ValueError, match="prune must be"):
        runner.run_sweep_bench("spmv_crs", prune="random", device="cpu",
                               cache_dir=tmp_path)


def _csv_rows(text):
    return [line for line in text.splitlines()
            if line and not line.startswith("#")]


def test_cli_pruned_front_rows_equal_the_exhaustive_ones(tmp_path, capsys,
                                                         one_thread):
    """The exhaustive run is served from a cache the reference's C loop
    filled (no plain lanes over the whole grid); the pruned run schedules
    its band on the plain lanes."""
    ref_runner.run_sweep(_pts("spmv_crs")[1], cache_dir=tmp_path / "full",
                         backend="c", jobs=1)
    args = ["--bench", "spmv_crs", "--device", "cpu", "--front-only"]
    runner.main(args + ["--cache-dir", str(tmp_path / "full")])
    exhaustive = capsys.readouterr().out
    assert "hits=80 misses=0" in exhaustive
    runner.main(args + ["--cache-dir", str(tmp_path / "pruned"),
                        "--prune", "surrogate"])
    pruned = capsys.readouterr().out
    n_band = len(_band(_pts("spmv_crs")[0]))
    assert f"points={n_band} " in pruned and "prune=surrogate" in pruned
    assert f"hits=0 misses={n_band}" in pruned
    assert len(_csv_rows(pruned)) > 2
    assert _csv_rows(pruned) == _csv_rows(exhaustive)


# ----------------------------------------------------------------------
# the on-disk trace cache
# ----------------------------------------------------------------------
@pytest.fixture
def trace_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_NO_TRACE_CACHE", raising=False)
    monkeypatch.setattr(tb, "_TRACE_MEMO", {})
    return tmp_path


def _no_gen(params):
    raise AssertionError("the trace was generated, not read from disk")


def test_trace_cache_round_trips(trace_dir, monkeypatch):
    made = tb.get_trace("spmv_crs")
    path = tb._disk_cache_path("spmv_crs", tb.BENCHMARKS["spmv_crs"].TINY)
    assert path.parent == trace_dir / "traces" and path.is_file()
    monkeypatch.setattr(tb, "_TRACE_MEMO", {})
    monkeypatch.setattr(tb.spmv_crs, "gen_trace", _no_gen)
    read = tb.get_trace("spmv_crs")
    assert read is not made
    for k in tb._TRACE_ARRAYS:
        a, b = getattr(read, k), getattr(made, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (read.array_names, read.word_bytes, read.name) == \
        (made.array_names, made.word_bytes, made.name)
    assert trace_fingerprint(read) == trace_fingerprint(made) == \
        ref_prepare(rb.get_trace("spmv_crs")).fingerprint
    assert tb.get_trace("spmv_crs") is read      # memoized in memory


def test_no_trace_cache_writes_nothing(trace_dir, monkeypatch):
    monkeypatch.setenv("REPRO_NO_TRACE_CACHE", "1")
    assert tb._disk_cache_path("kmp", tb.BENCHMARKS["kmp"].TINY) is None
    tb.get_trace("kmp")
    assert not any(trace_dir.iterdir())


@pytest.mark.parametrize("damage", ["flip", "truncate", "empty"])
def test_a_damaged_trace_file_raises_naming_its_path(trace_dir, monkeypatch,
                                                     damage):
    tb.get_trace("spmv_crs")
    path = tb._disk_cache_path("spmv_crs", tb.BENCHMARKS["spmv_crs"].TINY)
    raw = bytearray(path.read_bytes())
    if damage == "flip":
        raw[len(raw) // 2] ^= 0x40
    elif damage == "truncate":
        del raw[len(raw) - 100:]
    else:
        raw.clear()
    path.write_bytes(bytes(raw))
    monkeypatch.setattr(tb, "_TRACE_MEMO", {})
    monkeypatch.setattr(tb.spmv_crs, "gen_trace", _no_gen)
    with pytest.raises(ValueError, match="damaged trace cache file") as e:
        tb.get_trace("spmv_crs")
    assert str(path) in str(e.value)


def test_trace_file_key_follows_the_module_source(trace_dir, monkeypatch):
    params = tb.BENCHMARKS["gemm_ncubed"].TINY
    path = tb._disk_cache_path("gemm_ncubed", params)
    assert path.name == \
        f"gemm_ncubed-{tb.trace_cache_key('gemm_ncubed')}.trace"
    ref_mod = rb.BENCHMARKS["gemm_ncubed"]
    ref_path = rb._disk_cache_path("gemm_ncubed", ref_mod.TINY, ref_mod)
    assert path.name != ref_path.rsplit("/", 1)[-1]
    mod = tb.BENCHMARKS["gemm_ncubed"]
    assert tb._disk_cache_path("gemm_ncubed", mod.Params()) != path
    monkeypatch.setitem(tb._SRC_HASH_MEMO, mod.__file__, "0" * 16)
    assert tb._disk_cache_path("gemm_ncubed", params) != path
