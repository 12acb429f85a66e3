"""The port's hybrid, vlm and audio families of ``models/lm.py`` against
the JAX reference, on the CPU, for tiny variants of zamba2-2.7b
(Mamba2 layers with the shared attention block; 3 layers, so the block
runs at layers 0 and 2 with two shared-cache slots), internvl2-1b
(patch prefix) and seamless-m4t-medium (encoder-decoder).

JAX initialises the params; ``convert.params_from_numpy`` carries them
across.  ``forward``, ``loss_fn`` (every metric), ``prefill`` and three
``decode_step``s from the prefill and three from an empty cache are
compared, logits and every cache tensor.  Tolerances, as
tests/test_torch_lm_attn.py: 1e-4 (atol and rtol) under an f32 policy,
and 2e-2 under the standard bf16 policy, taken as rtol and as atol
relative to the compared tensor's scale (its largest magnitude, at
least 1).

The identities that hold in the reference are held on the port alone:
the hybrid's decode from an empty cache equals ``forward``, the
encdec's prefill-then-decode equals ``forward`` when the frames fit the
cross cache, and the vlm's with no patches.  Two behaviours the port
keeps from the reference are pinned: the hybrid's prefill skips the
shared block (its cache stays zero), and an encdec prefill cuts the
cross cache to ``max(cache_len // 8, 16)`` encoder positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import (DTypePolicy, decode_step, forward,
                                init_model, loss_fn, make_cache, prefill)
from repro_torch.models.common import tree_map

ARCHS = ["zamba2-2.7b", "internvl2-1b", "seamless-m4t-medium"]
OVERRIDES = {"zamba2-2.7b": dict(n_layers=3)}
PROMPT, STEPS = 12, 3
CAP = PROMPT + STEPS - 1          # the third step decodes at S_max
FRAMES = 20                       # > the cross cache's 16 positions
POLICIES = {
    "f32": (jcommon.DTypePolicy(jnp.float32, jnp.float32, jnp.float32),
            DTypePolicy(torch.float32, torch.float32), 1e-4),
    "standard": (jcommon.DTypePolicy.standard(), DTypePolicy.standard(),
                 2e-2),
}
F32 = POLICIES["f32"][1]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    want = np.asarray(want).astype(np.float32)
    scale = max(1.0, float(np.abs(want).max())) if tol > 1e-3 else 1.0
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=tol,
                               err_msg=what)


def _archs(name: str):
    over = OVERRIDES.get(name, {})
    return (jconfigs.tiny_variant(jconfigs.get_arch(name), **over),
            configs.tiny_variant(configs.get_arch(name), **over))


def _inputs(arch, frames: int = FRAMES):
    """Tokens, labels and the family's extra inputs, as numpy."""
    rng = np.random.default_rng(7)
    toks = rng.integers(1, arch.vocab - 1, (2, PROMPT)).astype(np.int32)
    labels = rng.integers(0, arch.vocab, (2, PROMPT)).astype(np.int32)
    labels[0, :3] = -1                      # masked
    labels[1, -1] = -100
    extra = {}
    if arch.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (2, arch.n_patches, arch.vit_dim)).astype(np.float32)
    if arch.is_encdec:
        extra["frames"] = rng.standard_normal(
            (2, frames, arch.d_model)).astype(np.float32)
    return toks, labels, extra


def _torch_batch(toks, extra) -> dict:
    return {"tokens": torch.from_numpy(np.asarray(toks)),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}


@pytest.fixture(scope="module")
def jax_params():
    memo = {}

    def get(name):
        if name not in memo:
            arch = _archs(name)[0]
            memo[name] = jax.jit(lambda k: jlm.init_model(k, arch))(
                jax.random.PRNGKey(0))
        return memo[name]

    return get


def _jax_run(jp, name, jpol):
    arch = _archs(name)[0]
    toks, labels, extra = _inputs(arch)

    def run(p, t, lab, ex):
        batch = {"tokens": t, **ex}
        full, aux = jlm.forward(p, arch, batch, policy=jpol)
        loss, metrics = jlm.loss_fn(p, arch, {**batch, "labels": lab},
                                    policy=jpol)
        lg, cache = jlm.prefill(p, arch, batch, CAP, policy=jpol)
        steps, fed = [(lg, cache)], []
        for _ in range(STEPS):
            nxt = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
            fed.append(nxt)
            lg, cache = jlm.decode_step(p, arch, cache, nxt, policy=jpol)
            steps.append((lg, cache))
        cache = jlm.make_cache(arch, CAP, 2, jpol)
        empty = []
        for i in range(STEPS):
            lg, cache = jlm.decode_step(p, arch, cache, t[:, i:i + 1],
                                        policy=jpol)
            empty.append((lg, cache))
        return full, aux, loss, metrics, steps, fed, empty

    ex = {k: jnp.asarray(v) for k, v in extra.items()}
    out = jax.jit(run)(jp, jnp.asarray(toks), jnp.asarray(labels), ex)
    return toks, labels, extra, jax.tree.map(np.asarray, out)


def _hold_cache(cache, cj, tpol, tol, what):
    assert sorted(cache) == sorted(cj)
    assert int(cache["len"]) == int(cj["len"])
    for k in cache:
        if k == "len":
            continue
        want_dtype = torch.float32 if k == "ssm_h" else tpol.compute
        assert cache[k].dtype == want_dtype, k
        assert tuple(cache[k].shape) == cj[k].shape, k
        _close(cache[k], cj[k], tol, f"{what} {k}")


@pytest.mark.parametrize("policy_name", ["f32", "standard"])
@pytest.mark.parametrize("name", ARCHS)
def test_tiny_model_matches_jax(jax_params, name, policy_name):
    jpol, tpol, tol = POLICIES[policy_name]
    toks, labels, extra, (full_j, aux_j, loss_j, met_j, steps_j, fed,
                          empty_j) = _jax_run(jax_params(name), name, jpol)
    arch = _archs(name)[1]
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params(name)),
                               "cpu")
    batch = _torch_batch(toks, extra)

    full, aux = forward(params, arch, batch, tpol)
    n_pre = arch.n_patches if arch.family == "vlm" else 0
    assert full.shape == (2, n_pre + PROMPT, arch.padded_vocab)
    assert full.dtype == tpol.compute and aux.dtype == torch.float32
    _close(full, full_j, tol, "forward")
    assert aux.item() == float(aux_j) == 0.0

    loss, metrics = loss_fn(params, arch,
                            {**batch, "labels": torch.from_numpy(labels)},
                            tpol)
    assert sorted(metrics) == sorted(met_j) == ["aux", "ce", "tokens",
                                                "z_loss"]
    assert metrics["tokens"].item() == float(met_j["tokens"]) == 2 * PROMPT - 4
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=tol, rtol=tol)
    for k in ("ce", "z_loss", "aux"):
        np.testing.assert_allclose(metrics[k].item(), float(met_j[k]),
                                   atol=tol * 1e-2 if k != "ce" else tol,
                                   rtol=tol, err_msg=k)

    logits, cache = prefill(params, arch, batch, CAP, tpol)
    for i, (lj, cj) in enumerate(steps_j):
        assert int(cache["len"]) == PROMPT + i
        _close(logits, lj, tol, f"step {i} logits")
        _hold_cache(cache, cj, tpol, tol, f"step {i}")
        if i < STEPS:
            logits, cache = decode_step(params, arch, cache,
                                        torch.from_numpy(fed[i].copy()), tpol)

    cache = make_cache(arch, CAP, 2, tpol, "cpu")
    for i, (lj, cj) in enumerate(empty_j):
        logits, cache = decode_step(params, arch, cache,
                                    batch["tokens"][:, i:i + 1], tpol)
        _close(logits, lj, tol, f"empty-cache step {i} logits")
        _hold_cache(cache, cj, tpol, tol, f"empty-cache step {i}")


@pytest.mark.parametrize("name", ARCHS)
def test_init_model_layout_matches_jax(name):
    jarch, arch = _archs(name)
    want = jax.eval_shape(lambda: jlm.init_model(jax.random.PRNGKey(0),
                                                 jarch))
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v

    got = dict(walk(init_model(0, arch, device="cpu")))
    assert sorted(got) == sorted(flat_j)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(flat_j[k].shape), k
        assert v.dtype == torch.float32
    lean = init_model(0, arch, DTypePolicy.ultra_lean(), device="cpu")
    assert lean["embed"].dtype == torch.bfloat16


def _tokens(arch, b: int, s: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(4).integers(
        1, arch.vocab - 1, (b, s)).astype(np.int32))


@pytest.mark.parametrize("policy_name", ["f32", "standard"])
def test_hybrid_decode_from_an_empty_cache_equals_forward(policy_name):
    """t decode steps from an empty cache give forward's logits at every
    position, over more than one SSD chunk (t 20, chunk 16), with the
    shared block at layers 0 and 2.  The stacked layer weights are
    rounded through bf16 first: forward casts them to the compute dtype
    where decode casts at each product (ROADMAP §C behaviour 2)."""
    _, tpol, tol = POLICIES[policy_name]
    arch = _archs("zamba2-2.7b")[1]
    params = init_model(0, arch, device="cpu")
    params["blocks"] = tree_map(lambda t: t.to(torch.bfloat16).float(),
                                params["blocks"])
    toks = _tokens(arch, 2, 20)
    full, _ = forward(params, arch, {"tokens": toks}, tpol)
    cache = make_cache(arch, 20, 2, tpol, "cpu")
    for i in range(20):
        lg, cache = decode_step(params, arch, cache, toks[:, i:i + 1], tpol)
        _close(lg[:, 0], _np(full[:, i]), tol, f"position {i}")
    assert bool(cache["shared_k"].abs().sum(dim=(1, 2, 4)).gt(0).all())


def test_hybrid_prefill_skips_the_shared_block():
    """The reference's prefill runs the Mamba2 layers only: its logits
    are those of the model without the shared block, and the shared
    K/V stay zero; a decode after it writes row ``s`` only."""
    arch = _archs("zamba2-2.7b")[1]
    params = init_model(0, arch, device="cpu")
    toks = _tokens(arch, 2, 10)
    lg, cache = prefill(params, arch, {"tokens": toks}, 12, F32)
    plain = dataclasses.replace(arch, shared_attn_every=0)
    full, _ = forward(params, plain, {"tokens": toks}, F32)
    np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, -1]), atol=1e-4,
                               rtol=1e-4)
    with_block, _ = forward(params, arch, {"tokens": toks}, F32)
    assert np.abs(_np(with_block[:, -1]) - _np(lg[:, 0])).max() > 1e-2
    for k in ("shared_k", "shared_v"):
        assert cache[k].shape == (2, 2, arch.n_kv_heads, 12, 16)
        assert not bool(cache[k].any())
    _, cache = decode_step(params, arch, cache, toks[:, :1], F32)
    rows = cache["shared_k"].abs().sum(dim=(0, 1, 2, 4))
    assert rows[10] > 0 and not bool(rows[:10].any()) and rows[11] == 0


@pytest.mark.parametrize("policy_name", ["f32", "standard"])
@pytest.mark.parametrize("frames", [16, 10])
def test_encdec_prefill_then_decode_equals_forward(frames, policy_name):
    """With frames that fit the cross cache (capacity 13 holds
    max(13 // 8, 16) = 16 positions; 10 frames leave it shorter, as the
    reference replaces it), decoding token t+1 from the prefill of t
    gives forward's last logits."""
    _, tpol, tol = POLICIES[policy_name]
    arch = _archs("seamless-m4t-medium")[1]
    params = init_model(0, arch, device="cpu")
    toks = _tokens(arch, 2, PROMPT + 1)
    fr = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, frames, arch.d_model)).astype(np.float32))
    _, cache = prefill(params, arch, {"tokens": toks[:, :-1], "frames": fr},
                       PROMPT + 1, tpol)
    assert cache["cross_k"].shape[3] == frames
    dec, _ = decode_step(params, arch, cache, toks[:, -1:], tpol)
    full, _ = forward(params, arch, {"tokens": toks, "frames": fr}, tpol)
    _close(dec[:, 0], _np(full[:, -1]), tol)


def test_encdec_cross_cache_is_cut_to_s_enc():
    """More frames than the cache holds: the prefill keeps the first
    ``max(cache_len // 8, 16)`` encoder positions' K/V (those of a cache
    large enough for every frame, cut), and the decode reads only those,
    so it differs from ``forward``, which reads every frame (the
    reference does the same)."""
    arch = _archs("seamless-m4t-medium")[1]
    params = init_model(0, arch, device="cpu")
    toks = _tokens(arch, 2, PROMPT + 1)
    batch = {"tokens": toks[:, :-1], "frames": torch.from_numpy(
        np.random.default_rng(5).standard_normal(
            (2, 24, arch.d_model)).astype(np.float32))}
    _, cache = prefill(params, arch, batch, PROMPT + 1, F32)
    _, whole = prefill(params, arch, batch, 8 * 24, F32)
    assert cache["cross_k"].shape == (2, 2, arch.n_kv_heads, 16, 16)
    assert whole["cross_k"].shape[3] == 24
    for k in ("cross_k", "cross_v"):
        assert torch.equal(cache[k], whole[k][:, :, :, :16])
    dec, _ = decode_step(params, arch, cache, toks[:, -1:], F32)
    full, _ = forward(params, arch, {**batch, "tokens": toks}, F32)
    assert np.abs(_np(dec[:, 0]) - _np(full[:, -1])).max() > 1e-3


@pytest.mark.parametrize("policy_name", ["f32", "standard"])
def test_vlm_with_no_patches_prefill_then_decode_equals_forward(policy_name):
    _, tpol, tol = POLICIES[policy_name]
    arch = _archs("internvl2-1b")[1]
    params = init_model(0, arch, device="cpu")
    toks = _tokens(arch, 2, PROMPT + 1)
    none = torch.zeros((2, 0, arch.vit_dim))
    _, cache = prefill(params, arch, {"tokens": toks[:, :-1],
                                      "patches": none}, PROMPT + 4, tpol)
    dec, _ = decode_step(params, arch, cache, toks[:, -1:], tpol)
    full, _ = forward(params, arch, {"tokens": toks, "patches": none}, tpol)
    assert full.shape[1] == PROMPT + 1
    _close(dec[:, 0], _np(full[:, -1]), tol)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_families_on_cpu(name, capsys):
    out = serve.main(["--arch", name, "--preset", "tiny", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    assert out["generated"].shape == (2, 3)
    assert out["tok_per_s"] > 0
    said = capsys.readouterr().out
    assert ("prefill 2x10" in said) == (name == "internvl2-1b")
    assert ("zero cross-cache" in said) == (name == "seamless-m4t-medium")
