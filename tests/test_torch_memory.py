"""The port's serving-memory path against the JAX reference, on the CPU.

Covers the copied pure-data modules (configs, AMM specs, cost models,
locality, planner), the ``BankedKVCache`` regressions of the reference
(tests/test_serving.py, tests/test_substrate.py), the embedding lookup
on both of its routes, state carried across with ``repro_torch.convert``
and the slice as a whole: plan -> lookup -> append -> decode.  The
port's entry points get ``device="cpu"``; its kernel wrappers then take
the plain versions.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.amm.spec import AMMSpec as JaxAMMSpec
from repro.core.cost import memory_cost as jax_memory_cost
from repro.core.locality import spatial_locality_np as jax_locality
from repro.memory import BankedKVCache as JaxCache
from repro.memory import StreamPlan as JaxStreamPlan
from repro.memory import banked_embedding_lookup as jax_lookup
from repro.memory import plan_memory as jax_plan_memory
from repro.memory.planner import embedding_stream as jax_embedding_stream
from repro_torch import configs
from repro_torch.convert import banked_kv_cache_from_numpy, tensor_from_numpy
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.cost import memory_cost
from repro_torch.core.locality import spatial_locality_np
from repro_torch.memory import (BankedKVCache, StreamPlan,
                                banked_embedding_lookup, plan_memory)
from repro_torch.memory import embedding as torch_embedding
from repro_torch.memory.planner import embedding_stream

_NP_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16}
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _cpu(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _same_bits(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    word = torch.int16 if t.element_size() == 2 else torch.int32
    return np.array_equal(t.view(word).numpy(),
                          a.view(np.int16 if a.dtype.itemsize == 2
                                 else np.int32))


# ------------------------------------------------------ copied modules
@pytest.mark.parametrize("name", jax_configs.ARCH_NAMES)
def test_arch_configs_match_jax(name):
    a, b = configs.get_arch(name), jax_configs.get_arch(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.padded_vocab == b.padded_vocab
    assert a.param_count_estimate() == b.param_count_estimate()
    tiny_a, tiny_b = configs.tiny_variant(a), jax_configs.tiny_variant(b)
    assert dataclasses.asdict(tiny_a) == dataclasses.asdict(tiny_b)


def test_registry_and_shapes_match_jax():
    assert configs.ARCH_NAMES == jax_configs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    for arch in configs.ARCH_NAMES:
        for shape in configs.SHAPES.values():
            assert configs.shape_applicable(configs.get_arch(arch), shape) \
                == jax_configs.shape_applicable(jax_configs.get_arch(arch),
                                                jax_configs.SHAPES[shape.name])


@pytest.mark.parametrize("name", jax_configs.ARCH_NAMES)
@pytest.mark.parametrize("shape", list(jax_configs.SHAPES))
def test_plan_memory_matches_jax(name, shape):
    """Field by field, floats included: it is the same numpy code."""
    got = plan_memory(configs.get_arch(name), configs.SHAPES[shape])
    want = jax_plan_memory(jax_configs.get_arch(name),
                           jax_configs.SHAPES[shape])
    assert (got.arch, got.shape) == (want.arch, want.shape)
    assert [dataclasses.astuple(s) for s in got.streams] == \
        [dataclasses.astuple(s) for s in want.streams]


_SPECS = [
    ("ideal", 2, 2, 1024, 32, 1), ("banked", 4, 4, 4096, 64, 4),
    ("multipump", 2, 2, 512, 32, 1), ("h_ntx_rd", 4, 1, 2048, 32, 1),
    ("b_ntx_wr", 1, 2, 1024, 16, 1), ("hb_ntx", 2, 2, 262144, 64, 1),
    ("hb_ntx", 4, 2, 4096, 64, 4), ("lvt", 4, 2, 2048, 64, 1),
    ("lvt", 2, 2, 1024, 32, 2), ("remap", 2, 2, 1024, 32, 1),
]


@pytest.mark.parametrize("kind,r,w,depth,width,nb", _SPECS)
def test_spec_and_cost_match_jax(kind, r, w, depth, width, nb):
    a = AMMSpec(kind, r, w, depth, width, n_banks=nb)
    b = JaxAMMSpec(kind, r, w, depth, width, n_banks=nb)
    assert a.leaf_banks() == b.leaf_banks()
    assert a.storage_bits() == b.storage_bits()
    assert a.table_bits() == b.table_bits()
    assert a.describe() == b.describe()
    assert dataclasses.asdict(memory_cost(a)) == \
        dataclasses.asdict(jax_memory_cost(b))


def test_spatial_locality_and_streams_match_jax():
    rng = np.random.default_rng(0)
    for addrs in (rng.integers(0, 1 << 40, 500), np.arange(100) * 8,
                  np.array([5]), np.zeros(10, np.int64),
                  rng.integers(0, 64, 1000)):
        assert spatial_locality_np(addrs) == jax_locality(addrs)
    arch = configs.get_arch("qwen3-1.7b")
    np.testing.assert_array_equal(
        embedding_stream(arch, n=4096),
        jax_embedding_stream(jax_configs.get_arch("qwen3-1.7b"), n=4096))


# ------------------------------------------------------ BankedKVCache
def _plans(nb: int):
    kw = dict(stream="kv", locality=0.1, use_amm=True, n_banks=nb,
              n_read_ports=2, est_area_mm2=0.0)
    return StreamPlan(**kw), JaxStreamPlan(**kw)


def _both_caches(b, h, s, d, plan_nb=None):
    tp, jp = _plans(plan_nb) if plan_nb is not None else (None, None)
    return (BankedKVCache.create(b, h, s, d, dtype=torch.float32, plan=tp,
                                 device="cpu"),
            JaxCache.create(b, h, s, d, dtype=jnp.float32, plan=jp))


def _rand_kv(rng, b, h, d):
    return (rng.standard_normal((b, h, 1, d)).astype(np.float32),
            rng.standard_normal((b, h, 1, d)).astype(np.float32))


def _assert_caches_equal(tc, jc):
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert tc.n_banks == jc.n_banks


def _append_both(tc, jc, kn, vn):
    tc = tc.append(_cpu(kn), _cpu(vn))
    jc = jc.append(jnp.asarray(kn), jnp.asarray(vn))
    return tc, jc


def test_append_at_capacity_drops_write_and_clamps_length():
    """A full row's append is dropped: k/v bitwise untouched, length
    pinned at max_len, and the decode after it matches JAX."""
    rng = np.random.default_rng(5)
    tc, jc = _both_caches(2, 2, 4, 8)
    for _ in range(4):
        tc, jc = _append_both(tc, jc, *_rand_kv(rng, 2, 2, 8))
    np.testing.assert_array_equal(tc.length.numpy(), [4, 4])
    k_full, v_full = tc.k.clone(), tc.v.clone()
    tc, jc = _append_both(tc, jc, *_rand_kv(rng, 2, 2, 8))
    np.testing.assert_array_equal(tc.length.numpy(), [4, 4])
    assert torch.equal(tc.k, k_full) and torch.equal(tc.v, v_full)
    _assert_caches_equal(tc, jc)
    q = rng.standard_normal((2, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(tc.decode_read(_cpu(q)).numpy(),
                               np.asarray(jc.decode_read(jnp.asarray(q))),
                               atol=1e-5)


def test_append_ragged_full_row_drops_open_row_writes():
    """Mixed-length batch with one row at capacity: the full row drops,
    the open row still lands its token at its own length."""
    rng = np.random.default_rng(6)
    tc, jc = _both_caches(2, 1, 4, 4)
    for _ in range(2):
        tc, jc = _append_both(tc, jc, *_rand_kv(rng, 2, 1, 4))
    tc.length.copy_(torch.tensor([4, 2], dtype=torch.int32))   # row 0 full
    jc = dataclasses.replace(jc, length=jnp.asarray([4, 2], jnp.int32))
    row0 = tc.k[0].clone()
    kn, vn = _rand_kv(rng, 2, 1, 4)
    out = tc.append(_cpu(kn), _cpu(vn))
    assert out is tc, "append works in place and returns the cache"
    jc = jc.append(jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_array_equal(tc.length.numpy(), [4, 3])
    assert torch.equal(tc.k[0], row0)
    np.testing.assert_array_equal(tc.k[1, :, 2].numpy(), kn[1, :, 0])
    np.testing.assert_array_equal(tc.v[1, :, 2].numpy(), vn[1, :, 0])
    _assert_caches_equal(tc, jc)


@pytest.mark.parametrize("s,nb,want", [(64, 6, 4), (48, 3, 3), (40, 12, 10),
                                       (32, 8, 8), (4, 64, 4),
                                       (32768, 9, 8)])
def test_create_rounds_to_largest_divisor_like_jax(s, nb, want):
    tc, jc = _both_caches(1, 1, s, 8, plan_nb=nb)
    assert tc.n_banks == jc.n_banks == want


@pytest.mark.parametrize("nb", (0, -2))
def test_create_rejects_nonpositive_bank_plan(nb):
    with pytest.raises(ValueError, match="n_banks"):
        BankedKVCache.create(1, 1, 32, 8, plan=_plans(nb)[0], device="cpu")


def test_create_odd_bank_plan_round_trips_decode():
    """3 banks over S=48 survive create, and decode equals JAX's."""
    rng = np.random.default_rng(7)
    tc, jc = _both_caches(2, 2, 48, 8, plan_nb=3)
    assert tc.n_banks == 3
    for _ in range(5):
        tc, jc = _append_both(tc, jc, *_rand_kv(rng, 2, 2, 8))
    _assert_caches_equal(tc, jc)
    q = rng.standard_normal((2, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(tc.decode_read(_cpu(q)).numpy(),
                               np.asarray(jc.decode_read(jnp.asarray(q))),
                               atol=1e-5)


def test_banked_kv_cache_decode_matches_jax():
    """tests/test_substrate.py::test_banked_kv_cache_decode on the port,
    against the JAX cache carried across with ``convert``."""
    jc = JaxCache.create(2, 2, 32, 8, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    for _ in range(4):
        jc = jc.append(*[jnp.asarray(a) for a in _rand_kv(rng, 2, 2, 8)])
    tc = banked_kv_cache_from_numpy(np.asarray(jc.k), np.asarray(jc.v),
                                    np.asarray(jc.length), jc.n_banks,
                                    device="cpu")
    q = rng.standard_normal((2, 4, 8)).astype(np.float32)
    got = tc.decode_read(_cpu(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.decode_read(jnp.asarray(q))),
                               atol=1e-5)
    from repro.kernels import ref
    np.testing.assert_allclose(got, np.asarray(ref.kv_decode_ref(
        jnp.asarray(q), jc.k, jc.v, jc.length)), atol=1e-5)


def test_create_without_device_needs_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    with no CUDA device, ``create`` without ``device`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BankedKVCache.create(1, 1, 8, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensor_from_numpy(np.zeros(3))


# ------------------------------------------------------------ convert
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_from_numpy_keeps_bits(dtype):
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((3, 5)) * 100).astype(
        _NP_DTYPE.get(dtype, np.int32))
    t = tensor_from_numpy(a, "cpu")
    assert tuple(t.shape) == a.shape
    assert t.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                       "int32": torch.int32}[dtype]
    assert _same_bits(t, a)


# ---------------------------------------------------------- embedding
def _emb_inputs(dtype, v=256, d=16):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((v, d)).astype(_NP_DTYPE[dtype])
    ids = rng.integers(0, v, (4, 8)).astype(np.int32)
    return table, ids


def _qwen_embedding_plans():
    want = jax_plan_memory(jax_configs.get_arch("qwen3-1.7b"),
                           jax_configs.SHAPES["decode_32k"])
    got = plan_memory(configs.get_arch("qwen3-1.7b"),
                      configs.SHAPES["decode_32k"])
    return got.for_stream("embedding"), want.for_stream("embedding")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_banks,route", [(None, "plain"), (8, "kernel")])
def test_banked_embedding_lookup_matches_jax(monkeypatch, dtype, n_banks,
                                             route):
    """The planner's own 9-bank plan does not divide the table, so the
    lookup takes the plain gather; with 8 banks it takes the kernel.
    Both routes are bit-equal to JAX."""
    tplan, jplan = _qwen_embedding_plans()
    assert tplan.n_banks == jplan.n_banks == 9
    if n_banks is not None:
        tplan = dataclasses.replace(tplan, n_banks=n_banks)
        jplan = dataclasses.replace(jplan, n_banks=n_banks)
    table, ids = _emb_inputs(dtype)
    calls = []
    real = torch_embedding.amm_gather

    def spy(*args, **kwargs):
        calls.append(kwargs.get("n_banks"))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_embedding, "amm_gather", spy)
    got = banked_embedding_lookup(_cpu(table), _cpu(ids), tplan)
    want = jax_lookup(jnp.asarray(table), jnp.asarray(ids), jplan)
    assert got.shape == (4, 8, 16)
    assert _same_bits(got, want)
    assert calls == ([] if route == "plain" else [8])


def test_banked_embedding_lookup_without_plan_is_plain_gather():
    table, ids = _emb_inputs("float32")
    got = banked_embedding_lookup(_cpu(table), _cpu(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids])


# ----------------------------------------------------- the whole slice
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 4e-2)])
def test_slice_matches_jax(dtype, tol):
    """plan -> lookup -> 4 x (append + decode) at a small width (2 kv
    heads, D 16, S 64, vocab 256), on the port and on JAX from the same
    numpy state: the lookups bit-equal, the decodes within tolerance,
    the final caches equal."""
    arch_t = configs.tiny_variant(configs.get_arch("qwen3-1.7b"))
    arch_j = jax_configs.tiny_variant(jax_configs.get_arch("qwen3-1.7b"))
    shape = "decode_32k"
    plan_t = plan_memory(arch_t, configs.SHAPES[shape])
    plan_j = jax_plan_memory(arch_j, jax_configs.SHAPES[shape])
    b, s = 3, 64
    hq, hkv, hd = arch_t.n_heads, arch_t.n_kv_heads, arch_t.resolved_head_dim
    assert (hkv, hd, arch_t.padded_vocab) == (2, 16, 256)
    assert hq * hd == arch_t.d_model
    # the tiny vocab does not divide into the planned 9 banks either: take
    # the kernel route with 8, as chip_smoke does
    emb_t = dataclasses.replace(plan_t.for_stream("embedding"), n_banks=8)
    emb_j = dataclasses.replace(plan_j.for_stream("embedding"), n_banks=8)
    kv_t, kv_j = plan_t.for_stream("kv_pages"), plan_j.for_stream("kv_pages")

    rng = np.random.default_rng(11)
    cast = _NP_DTYPE[dtype]
    table = rng.standard_normal((arch_t.padded_vocab, arch_t.d_model)
                                ).astype(cast)
    k0 = rng.standard_normal((b, hkv, s, hd)).astype(cast)
    v0 = rng.standard_normal((b, hkv, s, hd)).astype(cast)
    lens0 = np.array([0, s, 30], np.int32)       # empty, full, open
    jc = JaxCache.create(b, hkv, s, hd, dtype=_JAX_DTYPE[dtype], plan=kv_j)
    jc = dataclasses.replace(jc, k=jnp.asarray(k0), v=jnp.asarray(v0),
                             length=jnp.asarray(lens0))
    tc = BankedKVCache.create(b, hkv, s, hd, dtype=_TORCH_DTYPE[dtype],
                              plan=kv_t, device="cpu")
    assert tc.n_banks == jc.n_banks == 8
    tc.k.copy_(_cpu(k0))
    tc.v.copy_(_cpu(v0))
    tc.length.copy_(_cpu(lens0))
    t_table, j_table = _cpu(table), jnp.asarray(table)
    for step in range(4):
        ids = rng.integers(0, arch_t.padded_vocab, b).astype(np.int32)
        kn = rng.standard_normal((b, hkv, 1, hd)).astype(cast)
        vn = rng.standard_normal((b, hkv, 1, hd)).astype(cast)
        xt = banked_embedding_lookup(t_table, _cpu(ids), emb_t)
        xj = jax_lookup(j_table, jnp.asarray(ids), emb_j)
        assert _same_bits(xt, xj), f"step {step}: lookup"
        tc.append(_cpu(kn), _cpu(vn))
        jc = jc.append(jnp.asarray(kn), jnp.asarray(vn))
        ot = tc.decode_read(xt.reshape(b, hq, hd))
        oj = jc.decode_read(xj.reshape(b, hq, hd))
        assert ot.dtype == xt.dtype and ot.shape == (b, hq, hd)
        np.testing.assert_allclose(_f32(ot), _f32(oj), atol=tol, rtol=tol,
                                   err_msg=f"step {step}: decode")
    np.testing.assert_array_equal(tc.length.numpy(), [4, s, 34])
    assert _same_bits(tc.k, jc.k) and _same_bits(tc.v, jc.v)
