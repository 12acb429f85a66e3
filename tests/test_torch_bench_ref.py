"""The port's benchmark implementations (``run_torch``) and its locality
metric against the JAX package's, on the CPU.

Each benchmark's ``run_torch`` gets the same numpy inputs (the modules'
seeded ``make_inputs``, or a seeded generator where a module has none)
as the reference's ``run_jax``, at ``TINY`` and at one other small
``Params``.  Tolerances: exact for the integer and byte benchmarks (aes,
kmp, bfs_queue, nw, viterbi, radix_sort, sort_merge); rtol 1e-5 for
stencil2d, gemm_ncubed and md_knn; rtol 1e-5 / atol 1e-6 for spmv_crs;
rtol 1e-4 / atol 1e-5 for kv_decode, paged_kv and moe_route (the
reference's own for its numpy references); the FFT against
``np.fft.fft`` at 1e-4, as the reference's test holds it.  JAX computes
in float32 (x64 off), the port in the inputs' own dtype.

``spatial_locality_torch`` is held to ``spatial_locality_jax`` at the
reference's 1e-5 and to ``spatial_locality_np`` at 1e-9; ``ratio.py``
to the reference's on points folded from the TINY golden rows, exactly.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core.bench as rb
import repro_torch.core.bench as tb
from repro.core.dse import ratio as ref_ratio
from repro.core.locality import spatial_locality_jax
from repro_torch.core.dse import ratio
from repro_torch.core.locality import (spatial_locality_np,
                                       spatial_locality_torch)

from _torch_sched_util import DESIGNS, GOLDEN, golden_configs


def _mods(name):
    return rb.BENCHMARKS[name], tb.BENCHMARKS[name]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


def _np(x):
    return np.asarray(x)


# ----------------------------------------------------------------------
# run_torch against run_jax (and run_np where the module has one)
# ----------------------------------------------------------------------
OTHER = {
    "aes": dict(n_blocks=5, seed=3),
    "kmp": dict(n=1500, seed=3),
    "nw": dict(alen=17, blen=9, seed=4),
    "bfs_queue": dict(n_nodes=40, avg_deg=3, seed=5),
    "viterbi": dict(n_states=7, n_steps=12, n_tokens=6, seed=2),
    "radix_sort": dict(n=100, value_bits=9, seed=1),
    "moe_route": dict(n_tokens=48, n_experts=6, top_k=2,
                      capacity_factor=0.8, seed=4),
    "spmv_crs": dict(n=20, nnz_per_row=3, seed=2),
    "md_knn": dict(n_atoms=32, max_neighbors=6, seed=3),
    "stencil2d": dict(rows=7, cols=12, seed=1),
    "kv_decode": dict(batch=3, n_kv_heads=1, max_len=9, head_dim=4, seed=2),
    "paged_kv": dict(n_seqs=5, page_size=2, max_pages=6, seed=1),
    "sort_merge": dict(n=100, seed=1),
    "gemm_ncubed": dict(n=8),
    "fft_strided": dict(n=128),
}


def _params(name, which):
    _, mod = _mods(name)
    return mod.TINY if which == "tiny" else mod.Params(**OTHER[name])


@pytest.fixture(params=["tiny", "other"])
def which(request):
    return request.param


def test_aes(which):
    ref, mod = _mods("aes")
    i = mod.make_inputs(_params("aes", which))
    got = _np(mod.run_torch(_t(i["blocks"]), i["key"]))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _np(ref.run_jax(_j(i["blocks"]),
                                                       i["key"])))
    np.testing.assert_array_equal(got, mod.encrypt_np(i["blocks"], i["key"]))


def test_aes_fips197_vector():
    _, mod = _mods("aes")
    key = np.arange(16, dtype=np.uint8)
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)
    want = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    assert _np(mod.run_torch(_t(pt[None].copy()), key))[0].tobytes() == want


@pytest.mark.parametrize("pattern", [b"bull", b"abab", b"aaa", b"cdc"])
def test_kmp(which, pattern):
    """The windowed count equals the DFA's, with overlapping occurrences
    (the bordered patterns) too."""
    ref, mod = _mods("kmp")
    text = mod.make_text(_params("kmp", which))
    got = int(mod.run_torch(_t(text), pattern))
    assert got == int(ref.run_jax(_j(text), pattern))
    assert got == mod.run_np(text, pattern) == ref.run_np(text, pattern)
    if pattern == b"bull":
        assert got > 0


def test_kmp_overlaps_and_short_text():
    _, mod = _mods("kmp")
    text = np.frombuffer(b"aaaaababab", np.uint8)
    assert int(mod.run_torch(_t(text.copy()), b"aaa")) == 3 \
        == mod.run_np(text, b"aaa")
    assert int(mod.run_torch(_t(text.copy()), b"abab")) == 2 \
        == mod.run_np(text, b"abab")
    assert int(mod.run_torch(_t(text[:2].copy()), b"aaa")) == 0


def test_nw(which):
    ref, mod = _mods("nw")
    i = mod.make_inputs(_params("nw", which))
    m, ptr = mod.run_torch(_t(i["seq_a"]), _t(i["seq_b"]))
    mj, pj = ref.run_jax(_j(i["seq_a"]), _j(i["seq_b"]))
    mn, pn = mod.run_np(i["seq_a"], i["seq_b"])
    assert m.dtype == torch.int32 and ptr.dtype == torch.int8
    np.testing.assert_array_equal(_np(m), _np(mj))
    np.testing.assert_array_equal(_np(ptr), _np(pj))
    np.testing.assert_array_equal(_np(m), mn)
    np.testing.assert_array_equal(_np(ptr), pn)


def test_nw_ties_follow_diag_up_left():
    """Identical sequences and all-mismatch ones make every tie order
    show: diag > up > left, as the reference's loop takes them."""
    _, mod = _mods("nw")
    for a, b in (([0, 0, 0, 0], [0, 0, 0]), ([1, 1, 1], [2, 2, 2, 2, 2])):
        sa, sb = np.array(a, np.uint8), np.array(b, np.uint8)
        m, ptr = mod.run_torch(_t(sa), _t(sb))
        mn, pn = mod.run_np(sa, sb)
        np.testing.assert_array_equal(_np(m), mn)
        np.testing.assert_array_equal(_np(ptr), pn)


def test_bfs_queue(which):
    ref, mod = _mods("bfs_queue")
    p = _params("bfs_queue", which)
    i = mod.make_inputs(p)
    got = _np(mod.run_torch(i["edge_ptr"], _t(i["edges"]), p.n_nodes))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, _np(ref.run_jax(i["edge_ptr"], _j(i["edges"]), p.n_nodes)))
    np.testing.assert_array_equal(
        got, mod.run_np(i["edge_ptr"], i["edges"], p.n_nodes))


def test_viterbi(which):
    ref, mod = _mods("viterbi")
    i = mod.make_inputs(_params("viterbi", which))
    args = [i[k] for k in ("obs", "init", "transition", "emission")]
    got = _np(mod.run_torch(*map(_t, args)))
    np.testing.assert_array_equal(got, _np(ref.run_jax(*map(_j, args))))
    np.testing.assert_array_equal(got, mod.run_np(*args))


def test_radix_sort(which):
    ref, mod = _mods("radix_sort")
    p = _params("radix_sort", which)
    a = mod.make_input(p)
    got = _np(mod.run_torch(_t(a), p.value_bits))
    np.testing.assert_array_equal(got, _np(ref.run_jax(_j(a), p.value_bits)))
    np.testing.assert_array_equal(got, mod.run_np(a, p.value_bits))
    np.testing.assert_array_equal(got, np.sort(a))
    assert mod.n_passes(p) == ref.n_passes(p)


def test_moe_route(which):
    ref, mod = _mods("moe_route")
    p = _params("moe_route", which)
    i = mod.make_inputs(p)
    args = [i[k] for k in ("logits", "x", "w_exp")]
    got = _np(mod.run_torch(*map(_t, args), p.top_k, p.capacity_factor))
    np.testing.assert_allclose(
        got, _np(ref.run_jax(*map(_j, args), p.top_k, p.capacity_factor)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, mod.run_np(*args, p.top_k, p.capacity_factor),
        rtol=1e-4, atol=1e-5)
    # the capacity-drop path must fire
    _, top_e = mod._route_np(i["logits"], p.top_k)
    counts = np.bincount(top_e.reshape(-1), minlength=p.n_experts)
    assert (counts > mod.capacity(p)).any(), counts


def test_spmv_crs(which):
    ref, mod = _mods("spmv_crs")
    i = mod.make_inputs(_params("spmv_crs", which))
    got = _np(mod.run_torch(_t(i["vals"]), _t(i["cols"]), i["row_ptr"],
                            _t(i["vec"])))
    np.testing.assert_allclose(
        got, _np(ref.run_jax(_j(i["vals"]), _j(i["cols"]), i["row_ptr"],
                             _j(i["vec"]))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, mod.run_np(i["vals"], i["cols"], i["row_ptr"], i["vec"]),
        rtol=1e-5, atol=1e-6)


def test_md_knn(which):
    ref, mod = _mods("md_knn")
    p = _params("md_knn", which)
    i = mod.make_inputs(p)
    got = _np(mod.run_torch(_t(i["position"]), _t(i["neighbor_list"])))
    assert got.shape == (p.n_atoms, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(
        got, _np(ref.run_jax(_j(i["position"]), _j(i["neighbor_list"]))),
        rtol=1e-5)


def test_stencil2d(which):
    ref, mod = _mods("stencil2d")
    i = mod.make_inputs(_params("stencil2d", which))
    got = _np(mod.run_torch(_t(i["orig"]), _t(i["filter"])))
    np.testing.assert_allclose(
        got, _np(ref.run_jax(_j(i["orig"]), _j(i["filter"]))), rtol=1e-5)


def test_kv_decode(which):
    ref, mod = _mods("kv_decode")
    i = mod.make_inputs(_params("kv_decode", which))
    args = [i[k] for k in ("q", "k", "v", "lengths")]
    got = _np(mod.run_torch(*map(_t, args)))
    np.testing.assert_allclose(got, _np(ref.run_jax(*map(_j, args))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, mod.run_np(*args), rtol=1e-4, atol=1e-5)


def test_paged_kv(which):
    ref, mod = _mods("paged_kv")
    p = _params("paged_kv", which)
    i = mod.make_inputs(p)
    args = [i[k] for k in ("block_table", "lengths", "kv_pool", "weights")]
    got = _np(mod.run_torch(*map(_t, args), p.page_size))
    np.testing.assert_allclose(
        got, _np(ref.run_jax(*map(_j, args), p.page_size)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, mod.run_np(*args, p.page_size),
                               rtol=1e-4, atol=1e-5)


def test_sort_merge(which):
    ref, mod = _mods("sort_merge")
    x = mod.make_input(_params("sort_merge", which))
    got = _np(mod.run_torch(_t(x)))
    np.testing.assert_array_equal(got, _np(ref.run_jax(_j(x))))
    np.testing.assert_array_equal(got, np.sort(x))


def test_gemm_ncubed(which):
    ref, mod = _mods("gemm_ncubed")
    n = _params("gemm_ncubed", which).n
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    got = _np(mod.run_torch(_t(a), _t(b)))
    np.testing.assert_allclose(got, _np(ref.run_jax(_j(a), _j(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(got, a @ b, rtol=1e-5)


def test_fft_strided(which):
    ref, mod = _mods("fft_strided")
    n = _params("fft_strided", which).n
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = _np(mod.spectrum(_t(x)))
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(mod.run_torch(_t(x))),
                               _np(ref.run_jax(_j(x))), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mod._bit_reverse_perm(n),
                                  ref._bit_reverse_perm(n))


def test_every_benchmark_has_run_torch():
    for name in tb.BENCHMARKS:
        assert callable(tb.BENCHMARKS[name].run_torch), name
    assert set(OTHER) == set(tb.BENCHMARKS)


# ----------------------------------------------------------------------
# spatial_locality_torch
# ----------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 10_000), min_size=2, max_size=200))
def test_locality_torch_equals_jax_and_np(addrs):
    a = np.asarray(addrs, np.int64)
    got = spatial_locality_torch(a, device="cpu")
    assert isinstance(got, float)
    assert abs(got - float(spatial_locality_jax(jnp.asarray(a)))) < 1e-5
    assert abs(got - spatial_locality_np(a)) < 1e-9
    assert abs(spatial_locality_torch(torch.from_numpy(a)) - got) == 0


def test_locality_torch_survives_addresses_beyond_int32():
    base = np.int64(2) ** 40
    addrs = base + np.arange(0, 8000, 8, dtype=np.int64)
    np_val = spatial_locality_np(addrs)
    assert abs(np_val - 1 / 8) < 1e-6
    assert abs(spatial_locality_torch(addrs, device="cpu") - np_val) < 1e-9
    assert abs(float(spatial_locality_jax(addrs))
               - spatial_locality_torch(addrs, device="cpu")) < 1e-5


def test_locality_torch_edges():
    assert spatial_locality_torch(np.array([7]), device="cpu") == 0.0
    assert spatial_locality_torch(np.array([3, 3, 3]), device="cpu") == 0.0
    # stride-0 transitions count in the denominator
    assert spatial_locality_torch(np.array([0, 0, 1]), device="cpu") == 0.5


def test_locality_torch_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spatial_locality_torch(np.arange(4))


# ----------------------------------------------------------------------
# ratio.py on points folded from the TINY golden rows
# ----------------------------------------------------------------------
def _golden_points(bench):
    """The TINY golden rows of ``bench`` folded into the port's and the
    reference's DSEPoints (the same host arithmetic on both sides)."""
    from repro.core.dse.sweep import DesignPoint as RefDP
    from repro.core.dse.sweep import point_from_schedule as ref_fold
    from repro.core.sim import prepare_trace as ref_prepare
    from repro.core.sim.scheduler import ScheduleResult as RefResult
    from repro_torch.core.dse.sweep import point_from_schedule
    from repro_torch.core.sim import ScheduleResult
    from _torch_sched_util import ref_config

    pt, rows, cfgs = golden_configs(bench)
    rpt = ref_prepare(rb.get_trace(bench))
    ours, theirs = [], []
    for g, cfg in zip(rows, cfgs):
        fields = {k: v for k, v in g.items()
                  if k not in ("bench", "design", "unroll")}
        dp = DESIGNS[g["design"]]
        ours.append(point_from_schedule(
            pt, dp, g["unroll"], cfg,
            ScheduleResult(per_array_accesses={}, **fields)))
        theirs.append(ref_fold(
            rpt, RefDP(dp.kind, dp.n_read, dp.n_write, dp.n_banks),
            g["unroll"], ref_config(rpt, cfg),
            RefResult(per_array_accesses={}, **fields)))
    return pt, ours, theirs


def test_ratio_matches_reference_on_golden_points():
    benches = sorted({g["bench"] for g in GOLDEN})
    L, got, want = [], [], []
    for bench in benches:
        pt, ours, theirs = _golden_points(bench)
        assert [p.row() for p in ours] == [p.row() for p in theirs]
        r = ratio.performance_ratio(ours)
        assert r == ref_ratio.performance_ratio(theirs) or (
            math.isnan(r) and math.isnan(ref_ratio.performance_ratio(theirs)))
        L.append(pt.locality)
        got.append(r)
        want.append(ref_ratio.performance_ratio(theirs))
        assert ratio.performance_ratio(ours, n_samples=5) \
            == ref_ratio.performance_ratio(theirs, n_samples=5)
    assert ratio.spearman_rho(L, got) == ref_ratio.spearman_rho(L, want)
    assert math.isfinite(ratio.spearman_rho(L, got))


def test_ranks_and_rho_edges():
    x = np.array([3.0, 1.0, 3.0, 2.0, 3.0])
    np.testing.assert_array_equal(ratio._ranks(x), ref_ratio._ranks(x))
    assert math.isnan(ratio.spearman_rho([1, 2], [2, 1]))
    assert math.isnan(ratio.spearman_rho([1, 1, 1], [1, 2, 3]))
    assert ratio.spearman_rho([1, 2, 3, float("nan")], [3, 2, 1, 0]) == -1.0
    assert ratio.performance_ratio([]) != ratio.performance_ratio([])


# ----------------------------------------------------------------------
# the calls the card tests and chip_smoke.py make, on the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bench", sorted(OTHER))
def test_bench_case_holds_to_numpy_on_the_cpu(bench):
    """``tests/_torch_bench_calls.py``'s call and reference for each
    benchmark (what the card tests and ``chip_smoke.py`` phase 9f hold
    the card to), run here on the CPU at TINY."""
    from _torch_bench_calls import bench_case, holds, max_abs_err

    call, want = bench_case(bench, tb.BENCHMARKS[bench].TINY, "cpu")
    got = call()
    assert holds(bench, got, want), max_abs_err(got, want)
