"""The port's Mamba2 serving path against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
function and through the port on ``device="cpu"``, where the SSD chunk
wrapper takes its plain PyTorch version.  JAX params are carried across
with ``convert.params_from_numpy``.  The CUDA kernel is held against
the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: the SSD chunk and the chunked scan keep the reference's
1e-4 (tests/test_kernel_parity.py, tests/test_models.py); the model
under an f32 policy keeps 1e-4, and under the bf16 policy the
prefill-vs-forward limit of tests/test_models.py, 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import ref as jax_ref
from repro.kernels import ssd_chunk as jax_ssd_chunk
from repro.models import common as jax_common
from repro.models import lm as jax_lm
from repro.models import ssm as jax_ssm
from repro_torch import configs
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ssd_chunk
from repro_torch.kernels.ssd_scan import (_vec_copies, ssd_chunk_step,
                                          ssd_chunk_step_plain, tile_counts,
                                          workspace_shape)
from repro_torch.launch import serve
from repro_torch.models import (DTypePolicy, decode_step, embed_tokens,
                                forward, init_model, make_cache, prefill)
from repro_torch.models import ssm

F32_POLICY = DTypePolicy(torch.float32, torch.float32)
JAX_F32_POLICY = jax_common.DTypePolicy(jnp.float32, jnp.float32,
                                        jnp.float32)


def _cpu(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _chunk_inputs(seed, bt, h, q, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, h, q, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (bt, h, q)).astype(np.float32)
    la = -dt * rng.uniform(0.5, 2.0, (1, h, 1)).astype(np.float32)
    cum = np.cumsum(la, axis=-1).astype(np.float32)
    B = rng.standard_normal((bt, q, n)).astype(np.float32)
    C = rng.standard_normal((bt, q, n)).astype(np.float32)
    h_in = rng.standard_normal((bt, h, p, n)).astype(np.float32)
    return x, dt, cum, B, C, h_in


# ------------------------------------------------------------ ssd chunk
@pytest.mark.parametrize("bt,h,q,p,n", [
    (1, 2, 8, 4, 4), (2, 4, 16, 8, 8), (2, 3, 12, 8, 6),
    (1, 2, 64, 16, 32),            # mamba-like: Q 64, P 16, N 32
])
def test_ssd_chunk_matches_jax(bt, h, q, p, n):
    ins = _chunk_inputs(q * 10 + n, bt, h, q, p, n)
    y, h_out = ssd_chunk(*map(_cpu, ins))
    assert y.dtype == h_out.dtype == torch.float32
    modes = ("xla", "interpret") if (q, n) == (12, 6) else ("xla",)
    for mode in modes:
        yj, hj = jax_ssd_chunk(*map(jnp.asarray, ins), mode=mode)
        np.testing.assert_allclose(_np(y), np.asarray(yj), atol=1e-4,
                                   err_msg=mode)
        np.testing.assert_allclose(_np(h_out), np.asarray(hj), atol=1e-4,
                                   err_msg=mode)
    yr, hr = jax.jit(jax_ref.ssd_chunk_ref)(*map(jnp.asarray, ins))
    np.testing.assert_allclose(_np(y), np.asarray(yr), atol=1e-4)
    np.testing.assert_allclose(_np(h_out), np.asarray(hr), atol=1e-4)


def test_ssd_chunk_rounds_y_through_bf16_x():
    """With bf16 x, JAX's block body casts y to bf16 before it is stored
    as f32; the port returns f32 y rounded through bf16 the same way,
    and h_out (f32 h_in) unrounded."""
    x, dt, cum, B, C, h_in = _chunk_inputs(7, 2, 3, 12, 8, 6)
    xb = x.astype(jnp.bfloat16)
    yj, hj = jax_ssd_chunk(jnp.asarray(xb), *map(jnp.asarray,
                                                 (dt, cum, B, C, h_in)),
                           mode="xla")
    y, h_out = ssd_chunk(_cpu(xb), *map(_cpu, (dt, cum, B, C, h_in)))
    yj = np.asarray(yj)
    assert yj.dtype == np.float32 and y.dtype == torch.float32
    assert np.array_equal(yj, yj.astype(jnp.bfloat16).astype(np.float32))
    assert torch.equal(y, y.to(torch.bfloat16).float())
    # both round one f32 sum, taken in another order: at most one bf16
    # step of |y| apart
    np.testing.assert_allclose(_np(y), yj, rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(_np(h_out), np.asarray(hj), atol=1e-4)
    assert not torch.equal(h_out, h_out.to(torch.bfloat16).float())


def test_ssd_chunk_step_counts_no_cpu_launch():
    before = ssd_chunk_step.launches
    ssd_chunk(*map(_cpu, _chunk_inputs(1, 1, 2, 8, 4, 4)))
    assert ssd_chunk_step.launches == before


# the CUDA kernel's tile edge (checked against the library on the card by
# tests/test_torch_cuda.py::test_ssd_tile_matches_kernel)
SSD_TILE = 64


@pytest.mark.parametrize("bt,h,q,p,n,ws,counts", [
    # mamba2-130m's chunk: 10 causal C B^T tiles a row, 4 row tiles
    (8, 24, 256, 64, 128, (8, 256, 256), {"cb": 80, "y": 768, "state": 384}),
    (1, 24, 256, 64, 128, (1, 256, 256), {"cb": 10, "y": 96, "state": 48}),
    (2, 3, 12, 8, 6, (2, 64, 64), {"cb": 2, "y": 6, "state": 6}),
    (2, 5, 100, 70, 130, (2, 128, 128), {"cb": 6, "y": 40, "state": 60}),
    (1, 3, 65, 64, 33, (1, 128, 128), {"cb": 3, "y": 6, "state": 3}),
    (2, 3, 40, 24, 20, (2, 64, 64), {"cb": 2, "y": 6, "state": 6}),
    (1, 2, 8, 4, 0, (1, 64, 64), {"cb": 1, "y": 2, "state": 0}),
])
def test_ssd_workspace_and_tile_counts(bt, h, q, p, n, ws, counts):
    assert workspace_shape(bt, q, SSD_TILE) == ws
    assert tile_counts(bt, h, q, p, n, SSD_TILE) == counts


@pytest.mark.parametrize("p,n,offset,want", [
    (64, 128, 0, True), (24, 20, 0, True), (70, 130, 0, False),
    (8, 6, 0, False), (64, 128, 1, False), (64, 128, 4, True),
])
def test_ssd_vec_copies(p, n, offset, want):
    """16-byte staging needs P and N in multiples of 4 floats and every
    base on a 16-byte boundary."""
    flat = torch.zeros(64)
    lead = (16 - flat.data_ptr() % 16) % 16 // 4
    t = flat[lead + offset:]
    assert _vec_copies(p, n, t, flat[lead:]) == want


# ---------------------------------------------------------- ssd chunked
@pytest.mark.parametrize("s,chunk,with_h0", [(40, 8, False), (40, 8, True),
                                             (5, 8, False), (16, 16, True),
                                             # lengths the chunk pads
                                             (13, 8, True), (17, 16, False),
                                             (9, 4, True)])
def test_ssd_chunked_matches_jax_and_reference(s, chunk, with_h0):
    rng = np.random.default_rng(3 + s)
    b, h, p, n = 2, 2, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.4, (b, s, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if with_h0 else None)
    j_h0 = None if h0 is None else jnp.asarray(h0)
    t_h0 = None if h0 is None else _cpu(h0)
    yj, hj = jax.jit(lambda *a: jax_ssm.ssd_chunked(*a, chunk=chunk))(
        *map(jnp.asarray, (x, dt, A, B, C)), j_h0)
    yr, hr = jax.jit(jax_ssm.ssd_reference)(
        *map(jnp.asarray, (x, dt, A, B, C)), j_h0)
    y, hf = ssm.ssd_chunked(*map(_cpu, (x, dt, A, B, C)), h0=t_h0,
                            chunk=chunk)
    yt, ht = ssm.ssd_reference(*map(_cpu, (x, dt, A, B, C)), h0=t_h0)
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    for got in ((y, hf), (yt, ht)):
        for want in ((yj, hj), (yr, hr)):
            np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                                       atol=1e-4)
            np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]),
                                       atol=1e-4)


# --------------------------------------------------------- mamba2 block
_CFG = dict(d_model=32, d_state=16, head_dim=8, chunk=8)


@pytest.fixture(scope="module")
def block_params():
    jcfg = jax_ssm.SSMConfig(**_CFG)
    jp = jax.jit(lambda k: jax_ssm.mamba2_init(k, jcfg))(
        jax.random.PRNGKey(1))
    jp = {**jp, "conv_b": jnp.linspace(-0.1, 0.1, jcfg.conv_channels),
          "dt_bias": jnp.linspace(-1.0, 0.5, jcfg.n_heads),
          "D": jnp.linspace(0.5, 1.5, jcfg.n_heads),
          "norm": {"scale": jnp.linspace(-0.2, 0.2, jcfg.d_inner)}}
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, jp, ssm.SSMConfig(**_CFG), params_from_numpy(np_params,
                                                                "cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_mamba2_apply_and_decode_match_jax(block_params, dtype, tol):
    jcfg, jp, tcfg, tp = block_params
    rng = np.random.default_rng(5)
    npdt = np.float32 if dtype == "float32" else jnp.bfloat16
    x = rng.standard_normal((2, 13, 32)).astype(npdt)
    xn = rng.standard_normal((2, 1, 32)).astype(npdt)
    oj, (hj, cj) = jax.jit(lambda pp, xx: jax_ssm.mamba2_apply(
        pp, jcfg, xx, return_state=True))(jp, jnp.asarray(x))
    o, (hf, conv) = ssm.mamba2_apply(tp, tcfg, _cpu(x), return_state=True)
    assert o.dtype == _cpu(x).dtype and hf.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _f32(oj), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(hf), _f32(hj), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(conv), _f32(cj), atol=tol, rtol=tol)
    dj, (hj2, cj2) = jax.jit(lambda pp, xx, st: jax_ssm.mamba2_decode(
        pp, jcfg, xx, st))(jp, jnp.asarray(xn), (hj, cj))
    d, (h2, c2) = ssm.mamba2_decode(tp, tcfg, _cpu(xn), (hf, conv))
    np.testing.assert_allclose(_np(d), _f32(dj), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(h2), _f32(hj2), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(c2), _f32(cj2), atol=tol, rtol=tol)


# ------------------------------------------------------ the whole model
NAME = "mamba2-130m"
PROMPT, STEPS = 20, 4


def _jax_run(policy):
    arch = jax_configs.tiny_variant(jax_configs.get_arch(NAME))
    jp = jax.jit(lambda k: jax_lm.init_model(k, arch, policy))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    toks = rng.integers(1, arch.vocab - 1, (2, PROMPT)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    full, _ = jax.jit(lambda pp, bb: jax_lm.forward(
        pp, arch, bb, policy=policy))(jp, batch)
    logits, cache = jax.jit(lambda pp, bb: jax_lm.prefill(
        pp, arch, bb, PROMPT + STEPS, policy=policy))(jp, batch)
    decode = jax.jit(lambda pp, cc, tt: jax_lm.decode_step(
        pp, arch, cc, tt, policy=policy))
    steps = [(logits, cache)]
    fed = []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
            jnp.int32)
        fed.append(np.array(nxt))
        logits, cache = decode(jp, cache, nxt)
        steps.append((logits, cache))
    return (jax.tree.map(np.asarray, jp), toks, np.asarray(full), fed,
            jax.tree.map(np.asarray, steps))


@pytest.fixture(scope="module")
def jax_runs():
    return {"f32": _jax_run(JAX_F32_POLICY),
            "standard": _jax_run(jax_common.DTypePolicy.standard())}


@pytest.mark.parametrize("policy_name,tol", [("f32", 1e-4),
                                             ("standard", 2e-2)])
def test_tiny_model_matches_jax(jax_runs, policy_name, tol):
    """forward, prefill and 4 teacher-forced decode steps (the port is
    fed JAX's greedy tokens): logits and both cache fields."""
    np_params, toks, full_j, fed, steps_j = jax_runs[policy_name]
    policy = F32_POLICY if policy_name == "f32" else DTypePolicy.standard()
    arch = configs.tiny_variant(configs.get_arch(NAME))
    params = params_from_numpy(np_params, "cpu")
    tt = torch.from_numpy(toks)
    full, aux = forward(params, arch, {"tokens": tt}, policy)
    assert full.dtype == policy.compute and float(aux) == 0.0
    np.testing.assert_allclose(_np(full), _f32(full_j), atol=tol, rtol=tol)
    logits, cache = prefill(params, arch, {"tokens": tt}, PROMPT + STEPS,
                            policy)
    for i, (lj, cj) in enumerate(steps_j):
        np.testing.assert_allclose(_np(logits), _f32(lj), atol=tol, rtol=tol,
                                   err_msg=f"step {i} logits")
        assert cache["ssm_h"].dtype == torch.float32
        assert cache["ssm_conv"].dtype == policy.compute
        np.testing.assert_allclose(_np(cache["ssm_h"]), _f32(cj["ssm_h"]),
                                   atol=tol, rtol=tol,
                                   err_msg=f"step {i} ssm_h")
        np.testing.assert_allclose(_np(cache["ssm_conv"]),
                                   _f32(cj["ssm_conv"]), atol=tol, rtol=tol,
                                   err_msg=f"step {i} ssm_conv")
        assert int(cache["len"]) == int(cj["len"]) == PROMPT + i
        if i < STEPS:
            logits, cache = decode_step(params, arch, cache,
                                        torch.from_numpy(fed[i]), policy)


def test_embed_scale_is_bit_equal_in_bf16():
    arch_j = jax_configs.tiny_variant(jax_configs.get_arch(NAME),
                                      d_model=768)
    arch = configs.tiny_variant(configs.get_arch(NAME), d_model=768)
    rng = np.random.default_rng(9)
    embed = rng.standard_normal((arch.padded_vocab, 768)).astype(np.float32)
    toks = rng.integers(0, arch.vocab, (2, 7)).astype(np.int32)
    want = jax_lm.embed_tokens({"embed": jnp.asarray(embed)}, arch_j,
                               jnp.asarray(toks), None, jnp.bfloat16)
    got = embed_tokens({"embed": _cpu(embed)}, arch, torch.from_numpy(toks),
                       torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        np.asarray(want).view(np.uint16))
    # the unrounded scale (27.7128...) gives other bits
    plain = (_cpu(embed)[torch.from_numpy(toks).long()].to(torch.bfloat16)
             * 768 ** 0.5)
    assert not torch.equal(plain, got)


def test_serve_tiny_on_cpu():
    out = serve.main(["--arch", NAME, "--preset", "tiny", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "18", "--gen", "4"])
    assert out["generated"].shape == (2, 4)
    assert out["tok_per_s"] > 0


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = configs.tiny_variant(configs.get_arch(NAME))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(0, arch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_cache(arch, 8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", NAME, "--gen", "1"])


def test_init_model_shapes_match_jax():
    arch = configs.tiny_variant(configs.get_arch(NAME))
    arch_j = jax_configs.tiny_variant(jax_configs.get_arch(NAME))
    want = jax.eval_shape(lambda: jax_lm.init_model(jax.random.PRNGKey(0),
                                                    arch_j))
    got = init_model(0, arch, device="cpu")
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v

    flat_t = dict(walk(got))
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_t.items():
        assert tuple(v.shape) == tuple(flat_j[k].shape), k
        assert v.dtype == torch.float32
