"""The port's attention families (dense GQA, MLA and MoE) of
``models/lm.py`` against the JAX reference, on the CPU, for tiny
variants of qwen3-1.7b, mistral-large-123b, nemotron-4-340b (squared
ReLU, ungated), minicpm3-4b (MLA), moonshot-v1-16b-a3b and dbrx-132b
(MoE).

JAX initialises the params; ``convert.params_from_numpy`` carries them
across.  ``forward``, ``loss_fn`` (every metric), ``prefill`` and three
greedy ``decode_step``s (the port fed JAX's tokens) are compared,
logits and caches; the prefill's capacity is the prompt plus two, so
the third step decodes at ``cache_len == S_max``.  Tolerances: 1e-4
(atol and rtol) under an f32 policy, and 2e-2 under the standard bf16
policy, the reference's bf16 limit (tests/test_models.py), taken as
rtol and as atol relative to the compared tensor's scale (its largest
magnitude, at least 1): XLA fuses elementwise chains and rounds a
fusion's bf16 result once, where PyTorch rounds after every operation,
so the two differ by a few bf16 steps of the tensor's scale (up to
0.047 at logits of magnitude 3.3 in these runs), not of each element.

Under bf16 a MoE router whose top-k gates nearly tie can pick another
expert on either side of such a difference, so the bf16 comparison of
the MoE archs zeroes the router (every gate ties exactly, experts 0..k-1
win and the capacity drops the later tokens): it holds dispatch,
capacity and combine to JAX; the f32 comparison keeps the random
router, and tests/test_torch_moe.py holds routing itself in bf16.
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

ARCHS = ["qwen3-1.7b", "mistral-large-123b", "nemotron-4-340b",
         "minicpm3-4b", "moonshot-v1-16b-a3b", "dbrx-132b"]
PROMPT, STEPS = 12, 3
POLICIES = {
    "f32": (jcommon.DTypePolicy(jnp.float32, jnp.float32, jnp.float32),
            DTypePolicy(torch.float32, torch.float32), 1e-4),
    "standard": (jcommon.DTypePolicy.standard(), DTypePolicy.standard(),
                 2e-2),
}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    want = _f32(want)
    scale = max(1.0, float(np.abs(want).max())) if tol > 1e-3 else 1.0
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=tol,
                               err_msg=what)


def _archs(name: str):
    return (jconfigs.tiny_variant(jconfigs.get_arch(name)),
            configs.tiny_variant(configs.get_arch(name)))


def _inputs(arch):
    rng = np.random.default_rng(7)
    toks = rng.integers(1, arch.vocab - 1, (2, PROMPT)).astype(np.int32)
    labels = rng.integers(0, arch.vocab, (2, PROMPT)).astype(np.int32)
    labels[0, :3] = -1                      # masked
    labels[1, -1] = -100
    return toks, labels


@pytest.fixture(scope="module")
def jax_params():
    memo = {}

    def get(name):
        if name not in memo:
            arch = _archs(name)[0]
            jp = jax.jit(lambda k: jlm.init_model(k, arch))(
                jax.random.PRNGKey(0))
            memo[name] = jp
        return memo[name]

    return get


def _jax_run(jp, name, jpol):
    arch = _archs(name)[0]
    toks, labels = _inputs(arch)

    def run(p, t, lab):
        full, aux = jlm.forward(p, arch, {"tokens": t}, policy=jpol)
        loss, metrics = jlm.loss_fn(p, arch, {"tokens": t, "labels": lab},
                                    policy=jpol)
        lg, cache = jlm.prefill(p, arch, {"tokens": t}, PROMPT + STEPS - 1,
                                policy=jpol)
        steps, fed = [(lg, cache)], []
        for _ in range(STEPS):
            nxt = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
            fed.append(nxt)
            lg, cache = jlm.decode_step(p, arch, cache, nxt, policy=jpol)
            steps.append((lg, cache))
        return full, aux, loss, metrics, steps, fed

    out = jax.jit(run)(jp, jnp.asarray(toks), jnp.asarray(labels))
    return toks, labels, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("policy_name", ["f32", "standard"])
@pytest.mark.parametrize("name", ARCHS)
def test_tiny_model_matches_jax(jax_params, name, policy_name):
    jpol, tpol, tol = POLICIES[policy_name]
    jp = jax_params(name)
    if policy_name == "standard" and "moe" in jp["blocks"]:
        jp = {**jp, "blocks": {**jp["blocks"], "moe": {
            **jp["blocks"]["moe"],
            "router": jnp.zeros_like(jp["blocks"]["moe"]["router"])}}}
    toks, labels, (full_j, aux_j, loss_j, met_j, steps_j, fed) = _jax_run(
        jp, name, jpol)
    arch = _archs(name)[1]
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)

    full, aux = forward(params, arch, {"tokens": tt}, tpol)
    assert full.dtype == tpol.compute and aux.dtype == torch.float32
    _close(full, full_j, tol, "forward")
    np.testing.assert_allclose(aux.item(), float(aux_j), atol=tol, rtol=tol)
    assert (aux.item() > 0) == (arch.family == "moe")

    loss, metrics = loss_fn(params, arch, {"tokens": tt, "labels": tl}, tpol)
    assert sorted(metrics) == sorted(met_j) == ["aux", "ce", "tokens",
                                                "z_loss"]
    assert metrics["tokens"].item() == float(met_j["tokens"]) == 2 * PROMPT - 4
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=tol, rtol=tol)
    for k in ("ce", "z_loss", "aux"):
        np.testing.assert_allclose(metrics[k].item(), float(met_j[k]),
                                   atol=tol * 1e-2 if k != "ce" else tol,
                                   rtol=tol, err_msg=k)

    logits, cache = prefill(params, arch, {"tokens": tt},
                            PROMPT + STEPS - 1, tpol)
    keys = ("c_kv", "k_rope") if arch.attn_type == "mla" else ("k", "v")
    for i, (lj, cj) in enumerate(steps_j):
        assert sorted(cache) == sorted(cj) == sorted(keys + ("len",))
        assert int(cache["len"]) == int(cj["len"]) == PROMPT + i
        _close(logits, lj, tol, f"step {i} logits")
        for k in keys:
            assert cache[k].dtype == tpol.compute
            _close(cache[k], cj[k], tol, f"step {i} {k}")
        if i < STEPS:
            logits, cache = decode_step(params, arch, cache,
                                        torch.from_numpy(fed[i].copy()), tpol)


def _prefill_then_decode(params, arch, toks, policy):
    full, _ = forward(params, arch, {"tokens": toks}, policy)
    _, cache = prefill(params, arch, {"tokens": toks[:, :-1]},
                       toks.shape[1] + 4, policy)
    dec, _ = decode_step(params, arch, cache, toks[:, -1:], policy)
    return dec[:, 0], full[:, -1]


@pytest.mark.parametrize("policy_name", ["f32", "standard"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_matches_forward(name, policy_name):
    """prefill(ctx) then decode(tok) reproduces forward(ctx + tok).  A
    MoE layer keeps it only where the forward drops none of the last
    token's choices, so the MoE archs run with a capacity that drops
    nothing (see the next test for the published capacity)."""
    _, tpol, tol = POLICIES[policy_name]
    arch = _archs(name)[1]
    if arch.family == "moe":
        arch = dataclasses.replace(
            arch, moe_capacity_factor=arch.n_experts / arch.top_k)
    params = init_model(0, arch, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, arch.vocab - 1, (2, PROMPT)).astype(np.int32))
    dec, full = _prefill_then_decode(params, arch, toks, tpol)
    np.testing.assert_allclose(_np(dec), _np(full), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_moe_prefill_then_decode_keeps_the_references_gap(jax_params, name):
    """At the published capacity factor (1.25) the forward over S tokens
    drops some of the last token's expert choices, the one-token decode
    (capacity 1, k distinct experts) drops none, so the two differ in
    the reference itself.  The port reproduces that gap."""
    jarch, arch = _archs(name)
    jp = jax_params(name)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(
        1, arch.vocab - 1, (2, PROMPT)).astype(np.int32)
    jpol, tpol, tol = POLICIES["f32"]

    def jax_side(p, t):
        full, _ = jlm.forward(p, jarch, {"tokens": t}, policy=jpol)
        _, c = jlm.prefill(p, jarch, {"tokens": t[:, :-1]}, PROMPT + 4,
                           policy=jpol)
        dec, _ = jlm.decode_step(p, jarch, c, t[:, -1:], policy=jpol)
        return dec[:, 0], full[:, -1]

    dec_j, full_j = map(np.asarray, jax.jit(jax_side)(jp, jnp.asarray(toks)))
    dec, full = _prefill_then_decode(params, arch, torch.from_numpy(toks),
                                     tpol)
    np.testing.assert_allclose(_np(dec), dec_j, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(full), full_j, atol=tol, rtol=tol)
    assert np.abs(dec_j - full_j).max() > 0.1      # the reference's gap


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


@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_gradients_are_finite(name):
    """Autograd through forward (the block scan, MoE dispatch, MLA) and
    the loss, under the bf16 policy, as the reference's train smoke."""
    arch = _archs(name)[1]
    params = init_model(0, arch, device="cpu")
    leaves = []

    def track(tree):
        for v in tree.values():
            if isinstance(v, dict):
                track(v)
            else:
                v.requires_grad_(True)
                leaves.append(v)

    track(params)
    toks, labels = map(torch.from_numpy, _inputs(arch))
    loss, _ = loss_fn(params, arch, {"tokens": toks, "labels": labels})
    loss.backward()
    assert torch.isfinite(loss)
    for v in leaves:
        assert v.grad is not None and bool(torch.isfinite(v.grad).all())


def test_decode_step_absorbed_equals_expanded():
    """minicpm3's decode with ``mla_absorb`` from a clone of the same
    prefilled cache: the logits and the new cache rows within 1e-4
    (f32), the reference's limit for the two modes."""
    arch = _archs("minicpm3-4b")[1]
    pol = POLICIES["f32"][1]
    params = init_model(1, arch, device="cpu")
    toks = torch.randint(1, arch.vocab, (2, 9), generator=torch.Generator()
                         .manual_seed(2), dtype=torch.int32)
    _, cache = prefill(params, arch, {"tokens": toks[:, :-1]}, 12, pol)
    outs = [decode_step(params, arch, {k: v.clone() for k, v in cache.items()},
                        toks[:, -1:], pol, mla_absorb=absorb)
            for absorb in (False, True)]
    np.testing.assert_allclose(_np(outs[0][0]), _np(outs[1][0]), atol=1e-4)
    for k in ("c_kv", "k_rope"):       # layer 1's rows follow layer 0's out
        np.testing.assert_allclose(_np(outs[0][1][k]), _np(outs[1][1][k]),
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "minicpm3-4b"])
def test_decode_step_writes_the_cache_in_place(name):
    arch = _archs(name)[1]
    params = init_model(0, arch, device="cpu")
    cache = make_cache(arch, 8, 2, device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    _, new = decode_step(params, arch, cache,
                         torch.ones((2, 1), dtype=torch.int32))
    for k in cache:
        if k == "len":
            assert int(new[k]) == 1 and int(cache[k]) == 0
        else:
            assert new[k] is cache[k]
            assert not torch.equal(cache[k], before[k])
            # only slot 0 (the position axis is the second last)
            assert torch.equal(cache[k][..., 1:, :], before[k][..., 1:, :])


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-1.7b"], ["--arch", "moonshot-v1-16b-a3b"],
    ["--arch", "minicpm3-4b", "--mla-absorb"], []])
def test_serve_attention_families_on_cpu(argv):
    out = serve.main(argv + ["--preset", "tiny", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "10",
                             "--gen", "3"])
    assert out["generated"].shape == (2, 3)
    assert out["tok_per_s"] > 0


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_arch_smoke_forward_and_decode_from_an_empty_cache(name):
    """The counterparts of tests/test_models.py's per-arch smokes for
    every arch: forward's logits over [2, 32] tokens (after the vlm's
    patches; the audio family's encoder over 32 frames), and one decode
    step from a zero cache of capacity 16."""
    arch = _archs(name)[1]
    params = init_model(0, arch, device="cpu")
    tokens = torch.full((2, 32), 3, dtype=torch.int32)
    batch, n_pre = {"tokens": tokens}, 0
    if arch.family == "vlm":
        n_pre = arch.n_patches
        batch["patches"] = torch.ones((2, n_pre, arch.vit_dim))
    if arch.is_encdec:
        batch["frames"] = torch.ones((2, 32, arch.d_model))
    logits, aux = forward(params, arch, batch)
    assert logits.shape == (2, n_pre + 32, arch.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    logits, cache = decode_step(params, arch, make_cache(arch, 16, 2,
                                                         device="cpu"),
                                torch.ones((2, 1), dtype=torch.int32))
    assert logits.shape == (2, 1, arch.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and int(cache["len"]) == 1
