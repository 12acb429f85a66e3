"""The port's attention modules against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
function and its counterpart in ``repro_torch.models``; JAX params are
carried across with ``convert.params_from_numpy``.  Nothing here is a
kernel: ``flash_attention`` is the JAX package's block scan (a
``lax.scan``, no Pallas), which the port keeps as plain PyTorch.

Tolerances: f32 1e-5 for the primitives and single layers (sums taken
in another order), the reference's own 2e-5 for flash attention against
the naive softmax (tests/test_models.py), 1e-4 for the absorbed against
the expanded MLA decode (tests/test_models.py), and under bf16 inputs
2e-2 (atol and rtol), the reference's bf16 limit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

KEY = jax.random.PRNGKey(0)


def _cpu(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


def _params(jp) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------- primitives
def test_dtype_policies_match_jax():
    for name in ("standard", "lean", "ultra_lean"):
        want = getattr(jcommon.DTypePolicy, name)()
        got = getattr(tcommon.DTypePolicy, name)()
        for field in ("params", "compute", "moments"):
            assert str(getattr(got, field)).split(".")[-1] == \
                jnp.dtype(getattr(want, field)).name, (name, field)
    assert tcommon.DTypePolicy() == tcommon.DTypePolicy.standard()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = _normal(rng, (3, 5, 24), dtype) * 3 + 1
    scale = _normal(rng, (24,)) * 0.1
    bias = _normal(rng, (24,)) * 0.1
    tol = 1e-5 if dtype == np.float32 else 2e-2
    for want, got in (
            (jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
             tcommon.rms_norm(_cpu(x), _cpu(scale))),
            (jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias)),
             tcommon.layer_norm(_cpu(x), _cpu(scale), _cpu(bias)))):
        assert got.dtype == _cpu(x).dtype
        np.testing.assert_allclose(_np(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 1e6),
                                            (8, 500000.0)])
def test_rope_frequencies_match_jax(head_dim, theta):
    np.testing.assert_allclose(
        tcommon.rope_frequencies(head_dim, theta).numpy(),
        np.asarray(jcommon.rope_frequencies(head_dim, theta)), rtol=1e-6)


@pytest.mark.parametrize("pos_shape,dtype", [
    ("s", np.float32), ("bs", np.float32), ("one", np.float32),
    ("s", jnp.bfloat16)])
def test_apply_rope_matches_jax(pos_shape, dtype):
    """Rotation by halves, in f32, cast back; positions [S], [B, S] or
    the decode's int32 [1] at a large offset."""
    rng = np.random.default_rng(2)
    b, s, h, d = 2, 7, 3, 16
    x = _normal(rng, (b, s if pos_shape != "one" else 1, h, d), dtype)
    pos = {"s": np.arange(s, dtype=np.int32),
           "bs": rng.integers(0, 4096, (b, s)).astype(np.int32),
           "one": np.full((1,), 4111, np.int32)}[pos_shape]
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tcommon.apply_rope(_cpu(x), _cpu(pos), 1e6)
    assert got.dtype == _cpu(x).dtype
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(_np(got), _f32(want), atol=tol, rtol=tol)
    # halves, not interleaved pairs: position 1 of the first row moves
    # element i with element i + d/2
    one = np.zeros((1, 1, 1, d), np.float32)
    one[..., 0] = 1.0
    r = tcommon.apply_rope(_cpu(one), torch.tensor([1]), 10000.0)
    assert r[..., d // 2].item() == pytest.approx(math.sin(1.0), abs=1e-6)
    assert r[..., 1].item() == 0.0


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2", "relu"])
def test_activations_match_jax(act):
    """gelu is JAX's default, the tanh approximation; relu2 is
    nemotron's squared ReLU."""
    x = np.linspace(-6, 6, 241, dtype=np.float32)
    want = np.asarray(jcommon.ACTIVATIONS[act](jnp.asarray(x)))
    got = tcommon.ACTIVATIONS[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if act == "gelu":
        exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
        assert np.abs(exact - want).max() > 1e-4   # not the erf form
    if act == "relu2":
        np.testing.assert_array_equal(got, np.maximum(x, 0) ** 2)


def test_stack_layer_init_stacks_each_leaf():
    gen = torch.Generator().manual_seed(3)
    calls = []

    def layer(g):
        calls.append(1)
        return {"w": tcommon.dense_init(g, 4, 6),
                "n": {"scale": torch.zeros(6)}}

    p = tcommon.stack_layer_init(layer, gen, 5)
    assert len(calls) == 5
    assert p["w"].shape == (5, 4, 6) and p["n"]["scale"].shape == (5, 6)
    assert not torch.equal(p["w"][0], p["w"][1])   # one draw a layer


# ----------------------------------------------------- flash attention
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,block,causal,q_offset", [
    (2, 4, 4, 16, 16, 8, 8, True, 0),
    (2, 4, 2, 13, 13, 8, 8, True, 0),        # Skv not a multiple, G 2
    (1, 6, 2, 5, 21, 16, 8, True, 16),       # q_offset: the last 5 rows
    (2, 4, 1, 9, 23, 8, 16, False, 0),       # not causal, G 4, padded
    (1, 2, 2, 6, 6, 4, 4, True, -3),         # 3 rows masked throughout
    (1, 2, 2, 8, 40, 8, 1024, True, 32),     # one block, mostly padding
])
def test_flash_attention_matches_jax(b, hq, hkv, sq, skv, d, block, causal,
                                     q_offset):
    rng = np.random.default_rng(sq * 100 + skv)
    q = _normal(rng, (b, hq, sq, d))
    k = _normal(rng, (b, hkv, skv, d))
    v = _normal(rng, (b, hkv, skv, d))
    want = jax.jit(lambda *a: jattn.flash_attention(
        *a, causal=causal, q_offset=q_offset, block_kv=block))(
        *map(jnp.asarray, (q, k, v)))
    got = tattn.flash_attention(_cpu(q), _cpu(k), _cpu(v), causal=causal,
                                q_offset=q_offset, block_kv=block)
    assert got.shape == (b, hq, sq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    if q_offset < 0:       # rows that see nothing give exact zeros
        assert torch.all(got[:, :, :-q_offset] == 0)


def test_flash_attention_bf16_matches_jax():
    """bf16 in, f32 scores and accumulators, bf16 out."""
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, s, jnp.bfloat16) for s in
               ((2, 4, 11, 16), (2, 2, 11, 16), (2, 2, 11, 16)))
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), block_kv=4)
    got = tattn.flash_attention(_cpu(q), _cpu(k), _cpu(v), block_kv=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_flash_attention_matches_naive():
    """The counterpart of tests/test_models.py's naive check."""
    rng = np.random.default_rng(0)
    b, h, s, d = 2, 4, 96, 16
    q, k, v = (torch.from_numpy(_normal(rng, (b, h, s, d)))
               for _ in range(3))
    got = tattn.flash_attention(q, k, v, causal=True, block_kv=32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
    scores = torch.where(mask, scores, -torch.inf)
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


# ---------------------------------------------------------------- GQA
GQA = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=True,
           rope_theta=1e6, block_kv=8)


def _gqa_setup(**over):
    jcfg = jattn.AttnConfig(**{**GQA, **over})
    tcfg = tattn.AttnConfig(**{**GQA, **over})
    jp = jattn.gqa_init(KEY, jcfg)
    if jcfg.qk_norm:   # non-zero norm gains, so the norms are exercised
        jp = {**jp, "q_norm": {"scale": jnp.linspace(-0.3, 0.3, 8)},
              "k_norm": {"scale": jnp.linspace(0.2, -0.2, 8)}}
    return jcfg, tcfg, jp, _params(jp)


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_gqa_apply_and_prefill_match_jax(qk_norm, dtype, tol):
    jcfg, tcfg, jp, tp = _gqa_setup(qk_norm=qk_norm)
    x = _normal(np.random.default_rng(3), (2, 13, 32), dtype)
    want = jattn.gqa_apply(jp, jcfg, jnp.asarray(x))
    got = tattn.gqa_apply(tp, tcfg, _cpu(x))
    np.testing.assert_allclose(_np(got), _f32(want), atol=tol, rtol=tol)
    wo, (wk, wv) = jattn.gqa_prefill(jp, jcfg, jnp.asarray(x))
    o, (k, v) = tattn.gqa_prefill(tp, tcfg, _cpu(x))
    assert k.shape == (2, 2, 13, 8) and k.dtype == _cpu(x).dtype
    for g, w in ((o, wo), (k, wk), (v, wv)):
        np.testing.assert_allclose(_np(g), _f32(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("cache_len", [0, 5, 9, 10, 14])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_gqa_decode_matches_jax(cache_len, dtype, tol):
    """S_max 10: at cache_len 9 the row lands in the last slot, at 10 and
    14 JAX clamps the write into it too and the mask admits every
    position, while RoPE takes the unclamped position."""
    jcfg, tcfg, jp, tp = _gqa_setup()
    rng = np.random.default_rng(cache_len)
    kc = _normal(rng, (2, 2, 10, 8), dtype)
    vc = _normal(rng, (2, 2, 10, 8), dtype)
    x = _normal(rng, (2, 1, 32), dtype)
    wo, (wk, wv) = jax.jit(lambda p, xx, c, n: jattn.gqa_decode(
        p, jcfg, xx, c, n))(jp, jnp.asarray(x),
                            (jnp.asarray(kc), jnp.asarray(vc)),
                            jnp.int32(cache_len))
    tk, tv = _cpu(kc), _cpu(vc)
    o, (k, v) = tattn.gqa_decode(tp, tcfg, _cpu(x), (tk, tv),
                                 torch.tensor(cache_len, dtype=torch.int32))
    assert k is tk and v is tv              # written in place
    for g, w in ((o, wo), (k, wk), (v, wv)):
        np.testing.assert_allclose(_np(g), _f32(w), atol=tol, rtol=tol)
    slot = min(cache_len, 9)
    changed = (k != _cpu(kc)).any(dim=(0, 1, 3))
    assert changed.nonzero().flatten().tolist() == [slot]


def test_gqa_kv_replication_equivalence():
    """kv_repeat must not change the math (Megatron kv replication): the
    port with kv_repeat 2 against itself with 1 and against JAX's 2."""
    jcfg, tcfg, jp, tp = _gqa_setup(qk_norm=False, n_kv_heads=2)
    x = _normal(np.random.default_rng(1), (2, 16, 32))
    one = tattn.gqa_apply(tp, tcfg, _cpu(x))
    two = tattn.gqa_apply(tp, dataclasses.replace(tcfg, kv_repeat=2),
                          _cpu(x))
    np.testing.assert_allclose(_np(one), _np(two), atol=1e-5)
    want = jattn.gqa_apply(jp, dataclasses.replace(jcfg, kv_repeat=2),
                           jnp.asarray(x))
    np.testing.assert_allclose(_np(two), np.asarray(want), atol=1e-5)
    o, (k, _) = tattn.gqa_prefill(tp, dataclasses.replace(tcfg, kv_repeat=2),
                                  _cpu(x))
    assert k.shape[1] == 2                  # the cache keeps the real heads


# ---------------------------------------------------------------- MLA
MLA = dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8, attn_type="mla",
           q_lora_rank=16, kv_lora_rank=8, rope_head_dim=4, block_kv=8)


@pytest.fixture(scope="module")
def mla_setup():
    jcfg, tcfg = jattn.AttnConfig(**MLA), tattn.AttnConfig(**MLA)
    jp = jattn.mla_init(KEY, jcfg)
    jp = {**jp, "q_a_norm": {"scale": jnp.linspace(-0.2, 0.2, 16)},
          "kv_a_norm": {"scale": jnp.linspace(0.3, -0.1, 8)}}
    return jcfg, tcfg, jp, _params(jp)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_mla_apply_and_prefill_match_jax(mla_setup, dtype, tol):
    jcfg, tcfg, jp, tp = mla_setup
    x = _normal(np.random.default_rng(4), (2, 11, 32), dtype)
    want = jattn.mla_apply(jp, jcfg, jnp.asarray(x))
    got = tattn.mla_apply(tp, tcfg, _cpu(x))
    np.testing.assert_allclose(_np(got), _f32(want), atol=tol, rtol=tol)
    wo, (wc, wr) = jattn.mla_prefill(jp, jcfg, jnp.asarray(x))
    o, (c, r) = tattn.mla_prefill(tp, tcfg, _cpu(x))
    assert c.shape == (2, 11, 8) and r.shape == (2, 11, 4)
    for g, w in ((o, wo), (c, wc), (r, wr)):
        np.testing.assert_allclose(_np(g), _f32(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("cache_len", [6, 9, 10, 12])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_mla_decode_matches_jax(mla_setup, absorb, cache_len, dtype, tol):
    """Both modes against JAX, from a prefilled latent cache of capacity
    10 (at 10 and 12 the write is clamped into the last slot)."""
    jcfg, tcfg, jp, tp = mla_setup
    rng = np.random.default_rng(20 + cache_len)
    _, (c_kv, k_rope) = jattn.mla_prefill(
        jp, jcfg, jnp.asarray(_normal(rng, (2, 6, 32), dtype)))
    cc = np.pad(_f32(c_kv), ((0, 0), (0, 4), (0, 0))).astype(dtype)
    rc = np.pad(_f32(k_rope), ((0, 0), (0, 4), (0, 0))).astype(dtype)
    x = _normal(rng, (2, 1, 32), dtype)
    wo, (wc, wr) = jax.jit(lambda p, xx, c, n: jattn.mla_decode(
        p, jcfg, xx, c, n, absorb=absorb))(
        jp, jnp.asarray(x), (jnp.asarray(cc), jnp.asarray(rc)),
        jnp.int32(cache_len))
    tc, tr = _cpu(cc), _cpu(rc)
    o, (c, r) = tattn.mla_decode(tp, tcfg, _cpu(x), (tc, tr),
                                 torch.tensor(cache_len, dtype=torch.int32),
                                 absorb=absorb)
    assert c is tc and r is tr              # written in place
    for g, w in ((o, wo), (c, wc), (r, wr)):
        np.testing.assert_allclose(_np(g), _f32(w), atol=tol, rtol=tol)


def test_mla_absorb_equivalence(mla_setup):
    """The absorbed (latent-space) decode equals the expanded one within
    the reference's 1e-4 (tests/test_models.py)."""
    _, tcfg, _, tp = mla_setup
    rng = np.random.default_rng(2)
    _, (c_kv, k_rope) = tattn.mla_prefill(tp, tcfg,
                                          _cpu(_normal(rng, (2, 6, 32))))
    x = _cpu(_normal(rng, (2, 1, 32)))
    outs = []
    for absorb in (False, True):
        cache = (torch.nn.functional.pad(c_kv, (0, 0, 0, 4)),
                 torch.nn.functional.pad(k_rope, (0, 0, 0, 4)))
        outs.append(tattn.mla_decode(tp, tcfg, x, cache,
                                     torch.tensor(6, dtype=torch.int32),
                                     absorb=absorb))
    np.testing.assert_allclose(_np(outs[0][0]), _np(outs[1][0]), atol=1e-4)
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
