"""The port's sweep runner (``repro_torch.core.dse.runner``) against the
JAX package's, on the CPU (the plain lanes of ``cycle_lanes``).

* ``run_sweep(device="cpu")`` gives the reference ``run_sweep(...,
  backend="c")``'s points, equal field for field;
* a cache directory is shared both ways: what one package's runner
  wrote, the other's reads with every point a hit and the points equal
  (equal trace fingerprints and ``point_key``s);
* the fully cached fast path generates no trace; the ``faults=`` path
  fills the reference's ``res_*`` fields; an edited cache entry fails
  the legality audit;
* the CLI's CSV rows equal the reference CLI's.
"""
import dataclasses
import hashlib
import json

import pytest
import torch

import repro.core.bench as rb
import repro_torch.core.bench as tb
from repro.core.dse import runner as ref_runner
from repro.core.dse.sweep import DEFAULT_DESIGNS as REF_DESIGNS
from repro.core.fault import FaultConfig as RefFaultConfig
from repro.core.sim import prepare_trace as ref_prepare
from repro_torch.core.dse import runner
from repro_torch.core.dse.sweep import DEFAULT_DESIGNS, DSEPoint
from repro_torch.core.fault import FaultConfig
from repro_torch.core.sim import prepare_trace
from repro_torch.core.verify import LegalityError

from _torch_sched_util import one_thread  # noqa: F401  (fixture)

DESIGNS = DEFAULT_DESIGNS[::4]
UNROLLS = (1, 4)


def _ref_designs(designs):
    by_label = {d.label: d for d in REF_DESIGNS}
    return [by_label[d.label] for d in designs]


def _pt(bench):
    return prepare_trace(tb.get_trace(bench))


def _ref_pt(bench):
    return ref_prepare(rb.get_trace(bench))


def _rows(points):
    return [p.row() for p in points]


@pytest.mark.parametrize("bench", ["gemm_ncubed", "kmp"])
def test_run_sweep_matches_reference(bench, one_thread):
    got = runner.run_sweep(_pt(bench), DESIGNS, UNROLLS, device="cpu")
    want = ref_runner.run_sweep(_ref_pt(bench), _ref_designs(DESIGNS),
                                UNROLLS, backend="c", jobs=1)
    assert [(p.design, p.unroll) for p in got] == \
        [(d.label, u) for d in DESIGNS for u in UNROLLS]
    assert _rows(got) == _rows(want)


def test_point_keys_and_fingerprints_are_the_reference_s():
    pt, rpt = _pt("gemm_ncubed"), _ref_pt("gemm_ncubed")
    assert pt.fingerprint == rpt.fingerprint
    for dp, rdp in zip(DEFAULT_DESIGNS, REF_DESIGNS):
        for u, ml in ((1, 2), (8, 0)):
            assert runner.point_key(pt.fingerprint, dp, u, ml) == \
                ref_runner.point_key(rpt.fingerprint, rdp, u, ml)
    assert runner.CACHE_VERSION == ref_runner.CACHE_VERSION
    # the manifest's bench identity hashes each package's own source
    assert tb.trace_cache_key("kmp") != rb.trace_cache_key("kmp")
    assert tb.trace_cache_key("kmp") == tb.trace_cache_key("kmp", tb.kmp.TINY)
    assert tb.trace_cache_key("kmp", full=True) != tb.trace_cache_key("kmp")


def test_cache_written_by_the_reference_is_read_by_the_port(tmp_path):
    want = ref_runner.run_sweep(_ref_pt("gemm_ncubed"),
                                _ref_designs(DESIGNS), UNROLLS,
                                cache_dir=tmp_path, backend="c", jobs=1)
    cache = runner.SweepCache(tmp_path)
    got = runner.run_sweep(_pt("gemm_ncubed"), DESIGNS, UNROLLS,
                           cache=cache, device="cpu")
    assert (cache.hits, cache.misses) == (len(want), 0)
    assert _rows(got) == _rows(want)


def test_cache_written_by_the_port_is_read_by_the_reference(tmp_path,
                                                           one_thread):
    got = runner.run_sweep(_pt("kmp"), DESIGNS, UNROLLS, cache_dir=tmp_path,
                           device="cpu")
    cache = ref_runner.SweepCache(tmp_path)
    want = ref_runner.run_sweep(_ref_pt("kmp"), _ref_designs(DESIGNS),
                                UNROLLS, cache=cache, backend="c", jobs=1)
    assert (cache.hits, cache.misses) == (len(got), 0)
    assert _rows(got) == _rows(want)


def test_run_sweep_bench_over_a_reference_cache_then_fast_path(
        tmp_path, monkeypatch):
    """The port's manifest key is its own, so its first bench sweep over
    a cache the reference filled prepares the trace and hits every
    point; the second takes the fast path and generates nothing."""
    ref_runner.run_sweep_bench("gemm_ncubed", _ref_designs(DESIGNS),
                               UNROLLS, cache_dir=tmp_path, backend="c",
                               jobs=1)
    stats = {}
    cache = runner.SweepCache(tmp_path)
    got = runner.run_sweep_bench("gemm_ncubed", DESIGNS, UNROLLS,
                                 cache=cache, stats=stats, device="cpu")
    assert stats["fast_path"] is False
    assert (cache.hits, cache.misses) == (len(got), 0)

    def no_trace(*args, **kwargs):
        raise AssertionError("the fast path generated a trace")

    monkeypatch.setattr(tb, "get_trace", no_trace)
    stats = {}
    cache = runner.SweepCache(tmp_path)
    again = runner.run_sweep_bench("gemm_ncubed", DESIGNS, UNROLLS,
                                   cache=cache, stats=stats, device="cpu")
    assert stats == {"fast_path": True}
    assert (cache.hits, cache.misses) == (len(got), 0)
    assert again == got


def test_cache_extension_and_corrupt_entry(tmp_path, one_thread):
    pt = _pt("paged_kv")
    designs = DESIGNS[:2]
    first = runner.run_sweep(pt, designs, (1,), cache_dir=tmp_path,
                             device="cpu")
    key = runner.point_key(pt.fingerprint, designs[0], 1, 2)
    path = runner.SweepCache(tmp_path)._path(key)
    path.write_text("{not json")
    cache = runner.SweepCache(tmp_path)
    pts = runner.run_sweep(pt, designs, (1, 4), cache=cache, device="cpu")
    assert (cache.hits, cache.misses) == (1, 3)
    assert [p.unroll for p in pts] == [1, 4] * len(designs)
    assert pts[0] == first[0] and pts[2] == first[1]
    assert json.loads(path.read_text())["point"]["cycles"] == first[0].cycles


def test_cache_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DSE_CACHE", str(tmp_path))
    assert runner._resolve_cache(None).root == tmp_path
    monkeypatch.delenv("REPRO_DSE_CACHE")
    assert runner._resolve_cache(None) is None


def test_launches_take_batch_lanes_points(monkeypatch, one_thread):
    """Misses go to the card in launches of at most
    ``batched_cycle.BATCH_LANES`` points, and so does the audit (counted
    at ``ops.cycle_lanes``: lanes, recording); the points do not depend
    on the batching."""
    import repro_torch.core.sim.batched_cycle as bc
    from repro_torch.kernels import ops

    calls = []
    real = ops.cycle_lanes

    def counted(desc, *args, **kwargs):
        calls.append((desc.shape[0], kwargs["record"]))
        return real(desc, *args, **kwargs)

    monkeypatch.setattr(ops, "cycle_lanes", counted)
    pt = _pt("paged_kv")
    one = runner.run_sweep(pt, DESIGNS, UNROLLS, device="cpu")
    assert calls == [(len(DESIGNS) * len(UNROLLS), False)]
    calls.clear()
    monkeypatch.setattr(bc, "BATCH_LANES", 4)
    three = runner.run_sweep(pt, DESIGNS, UNROLLS, device="cpu", check=True)
    assert calls == [(4, False), (4, False), (2, False),
                     (4, True), (4, True), (2, True)]
    assert three == one


def test_faults_path_matches_reference():
    designs = [d for d in DEFAULT_DESIGNS
               if d.label in ("hb_ntx-2R2W", "lvt-2R2W")]
    cfg = dict(n_faults=4, n_cycles=16, seed=1)
    pt = _pt("gemm_ncubed")
    got = runner.run_sweep(pt, designs, (1,), faults=FaultConfig(**cfg),
                           device="cpu")
    want = ref_runner.run_sweep(_ref_pt("gemm_ncubed"),
                                _ref_designs(designs), (1,),
                                faults=RefFaultConfig(**cfg), backend="c",
                                jobs=1)
    assert _rows(got) == _rows(want)
    assert all(p.res_cover != "-" and p.res_sdc_rate >= 0 for p in got)
    # the campaigns are attached after the cache: a fault-free sweep of
    # the same points is the same but for the res_* fields
    clean = runner.run_sweep(pt, designs, (1,), device="cpu")
    strip = [f.name for f in dataclasses.fields(DSEPoint)
             if not f.name.startswith("res_")]
    assert [[getattr(p, f) for f in strip] for p in got] == \
        [[getattr(p, f) for f in strip] for p in clean]


def test_audit_passes_then_catches_an_edited_entry(tmp_path, one_thread):
    pt = _pt("paged_kv")
    designs = DESIGNS[:3]
    pts = runner.run_sweep(pt, designs, (1,), cache_dir=tmp_path,
                           device="cpu", check=True)
    key = runner.point_key(pt.fingerprint, designs[1], 1, 2)
    path = runner.SweepCache(tmp_path)._path(key)
    entry = json.loads(path.read_text())
    entry["point"]["cycles"] += 1
    entry["sha256"] = hashlib.sha256(json.dumps(
        entry["point"], sort_keys=True).encode()).hexdigest()
    path.write_text(json.dumps(entry))
    cache = runner.SweepCache(tmp_path)
    stale = runner.run_sweep(pt, designs, (1,), cache=cache, device="cpu")
    assert cache.hits == len(designs)
    assert stale[1].cycles == pts[1].cycles + 1
    with pytest.raises(LegalityError, match="counter"):
        runner.run_sweep(pt, designs, (1,), cache_dir=tmp_path,
                         device="cpu", check=True)
    # run_sweep_bench's fast path cannot serve an audit either
    with pytest.raises(LegalityError, match="counter"):
        runner.run_sweep_bench("paged_kv", designs, (1,),
                               cache_dir=tmp_path, device="cpu", check=True)


def test_entry_points_need_a_device_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt = _pt("gemm_ncubed")
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.run_sweep(pt, DESIGNS[:1], (1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.run_sweep_bench("gemm_ncubed", DESIGNS[:1], (1,),
                               cache_dir=tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.main(["--bench", "gemm_ncubed", "--unrolls", "1"])


def _csv_rows(text):
    return [line for line in text.splitlines()
            if line and not line.startswith("#")]


def test_cli_rows_match_reference_cli(tmp_path, capsys, one_thread):
    runner.main(["--bench", "gemm_ncubed", "--device", "cpu",
                 "--front-only", "--cache-dir", str(tmp_path / "port")])
    ours = capsys.readouterr().out
    ref_runner.main(["--bench", "gemm_ncubed", "--backend", "c", "--jobs",
                     "1", "--front-only"])
    theirs = capsys.readouterr().out
    rows = _csv_rows(ours)
    assert rows[0] == ",".join(f.name for f in dataclasses.fields(DSEPoint))
    assert len(rows) > 2
    assert rows == _csv_rows(theirs)
    notes = [line for line in ours.splitlines() if line.startswith("#")]
    assert notes[0].startswith("# nodes=") and "device=cpu" in notes[0]
    assert notes[-1].startswith("# cache:") and "misses=80" in notes[-1]


def test_cli_check_and_warm_cache(tmp_path, capsys, one_thread):
    args = ["--bench", "paged_kv", "--device", "cpu", "--unrolls", "1",
            "--cache-dir", str(tmp_path)]
    runner.main(args + ["--check"])
    out = capsys.readouterr().out
    assert "# legality: 20 points audited" in out and "0 violations" in out
    runner.main(args)
    out = capsys.readouterr().out
    assert "# trace=cached-manifest points=20" in out
    assert "hits=20 misses=0" in out
    assert len(_csv_rows(out)) == 1 + len(DEFAULT_DESIGNS)


@pytest.mark.parametrize("text", [
    b"{not json", b"", b"\xff\xfe\x00garbage", b'{"sha256": "ab"}',
    b'{"sha256": "' + b"0" * 64 + b'", "point": {"bench": "x"}}',
    b'{"sha256": "' + b"0" * 64 + b'", "point": {"a": {"b": 1}}}',
    b'[1, 2, 3]', b'{"sha256": "' + b"0" * 64 + b'", "point": {"a": 1,}}',
])
def test_entries_and_manifests_of_another_shape_read_as_misses(tmp_path,
                                                               text):
    """What the runner did not write reads as a miss (entries) or an
    empty manifest, and the parse never fails."""
    cache = runner.SweepCache(tmp_path)
    point = runner.run_sweep(_pt("paged_kv"), DESIGNS[:1], (1,),
                             device="cpu")[0]
    cache.put("ab" * 32, point)
    assert cache.get("ab" * 32) == point
    cache._path("ab" * 32).write_bytes(text)
    assert cache.get("ab" * 32) is None
    assert (cache.hits, cache.misses) == (1, 1)
    cache.manifest_put("k", "fp")
    assert cache.manifest_get("k") == "fp"
    cache._manifest_path().write_bytes(text)
    assert cache.manifest_get("k") is None
    cache.manifest_put("k", "fp2")
    assert cache.manifest_get("k") == "fp2"
