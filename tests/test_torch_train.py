"""The port's train step and ``launch/train.py`` against the reference, on the
CPU.

``make_train_step`` (loss -> backward -> AdamW) is held against the
reference's on JAX-initialised ``tiny_variant`` params of all ten
archs under an f32 policy, at accum 1, and for qwen3 and mamba2 at
accum 2 (microbatch i is rows [i B/2, (i+1) B/2)).  The loss, the
step's ``grad_norm`` and every gradient leaf (``loss_and_grads``, which
the step uses, against ``jax.value_and_grad``) within 1e-5 relative:
f32 sums taken in another order through a few layers (the re-anchor
read at most 3.6e-6).  The updated params two ways: the port's
``adamw.update`` fed JAX's gradients equals the reference's step within
1e-6, and the port's own step moves each param the same way as the
reference's except on a share of at most 1e-3 of its entries: at step 1
the update is lr * sign(g) (plus decay), so an entry whose gradient is
near 0 may flip on a 1e-6 difference (the share read is printed).

remat "full" (each layer under ``torch.utils.checkpoint``) gives the
gradients of remat "none" within 1e-6, and re-runs each layer's SSD
chunks in the backward.  The ``train.main`` tests are the counterparts
of the reference's train tests, on ``--preset tiny --device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import RuntimeConfig as JaxRuntimeConfig
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.configs.base import RuntimeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ssd_scan
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import DTypePolicy, init_model, loss_fn
from repro_torch.optim import adamw

F32 = DTypePolicy(torch.float32, torch.float32, torch.float32)
JAX_F32 = jcommon.DTypePolicy(jnp.float32, jnp.float32, jnp.float32)
TOL = 1e-5
FLIP_SHARE = 1e-3


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(arch, b: int, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, arch.vocab - 1, (b, 12)).astype(
        np.int32),
        "labels": rng.integers(0, arch.vocab, (b, 12)).astype(np.int32)}
    batch["labels"][0, :3] = -1                  # masked positions
    if arch.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, arch.n_patches, arch.vit_dim)).astype(np.float32)
    if arch.is_encdec:
        batch["frames"] = rng.standard_normal(
            (b, 10, arch.d_model)).astype(np.float32)
    return batch


def _hold(got: torch.Tensor, want, tol: float, what: str) -> None:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


CASES = [(name, 1) for name in configs.ARCH_NAMES] + [
    ("qwen3-1.7b", 2), ("mamba2-130m", 2)]


@pytest.mark.parametrize("name,accum", CASES)
def test_train_step_matches_jax(name, accum):
    jarch = jconfigs.tiny_variant(jconfigs.get_arch(name))
    arch = configs.tiny_variant(configs.get_arch(name))
    jp = jlm.init_model(jax.random.PRNGKey(0), jarch, JAX_F32)
    nb = _batch(arch, 2 * accum)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tcfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jrt = JaxRuntimeConfig(accum_steps=accum, remat="none")
    rt = RuntimeConfig(accum_steps=accum, remat="none")
    jstep = jax_make_train_step(jarch, jrt, JAX_F32, cfg)
    mb = {k: v[:2] for k, v in jb.items()}      # the first microbatch

    def jax_side(p, o):
        vag = jax.value_and_grad(
            lambda pp: jlm.loss_fn(pp, jarch, mb, jrt, JAX_F32),
            has_aux=True)
        return jstep(p, o, jb), vag(p)

    (jp2, jo2, jstats), ((jl1, _), jg1) = jax.jit(jax_side)(
        jp, jadamw.init(jp, JAX_F32))
    params = params_from_numpy(_np(jp), "cpu")
    opt = adamw.init(params, F32)
    p2, o2, stats = make_train_step(arch, rt, F32, tcfg)(params, opt, tb)
    assert set(stats) == {"loss", "lr", "grad_norm"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=TOL, err_msg=k)
    # gradients of the first microbatch (the whole batch at accum 1)
    l1, _, g1 = loss_and_grads(params, arch,
                               {k: v[:2] for k, v in tb.items()}, rt, F32)
    np.testing.assert_allclose(float(l1), float(jl1), rtol=TOL)
    jg = dict(_flat(_np(jg1)))
    got = dict(_flat(g1))
    assert sorted(got) == sorted(jg)
    for k, g in got.items():
        _hold(g, jg[k], TOL, f"grad {k}")
    # the update fed JAX's gradients equals the reference's step
    if accum == 1:
        fed, _, _ = adamw.update(params_from_numpy(_np(jg1), "cpu"), opt,
                                 params, tcfg, F32)
        for k, t in _flat(fed):
            _hold(t, dict(_flat(_np(jp2)))[k], 1e-6, f"fed update {k}")
    # the port's own step: the direction of each entry's move
    flips = total = 0
    want2 = dict(_flat(_np(jp2)))
    for k, t in _flat(p2):
        p0 = dict(_flat(params))[k].numpy()
        d_port, d_jax = t.numpy() - p0, want2[k] - p0
        flips += int(np.sum(np.sign(d_port) != np.sign(d_jax)))
        total += d_port.size
    print(f"{name} accum {accum}: {flips} of {total} entries moved the "
          "other way")
    assert flips <= FLIP_SHARE * total
    assert int(o2["step"]) == int(jo2["step"]) == 1


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-2.7b",
                                  "seamless-m4t-medium", "qwen3-1.7b"])
def test_remat_full_equals_none(name, monkeypatch):
    arch = configs.tiny_variant(configs.get_arch(name))
    params = init_model(1, arch, F32, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch, 2).items()}
    calls = []
    plain = ssd_scan.ssd_chunk_step
    monkeypatch.setattr(ssd_scan, "ssd_chunk_step",
                        lambda *a: calls.append(1) or plain(*a))
    out = {}
    for remat in ("none", "full"):
        calls.clear()
        out[remat] = loss_and_grads(params, arch, batch,
                                    RuntimeConfig(remat=remat), F32)
        out[remat] += (len(calls),)
    np.testing.assert_allclose(float(out["full"][0]), float(out["none"][0]),
                               rtol=1e-6)
    want = dict(_flat(out["none"][2]))
    for k, g in _flat(out["full"][2]):
        _hold(g, want[k].numpy(), 1e-6, k)
    # the SSD forward runs again for every layer in the backward
    assert out["full"][3] == 2 * out["none"][3]
    if arch.family in ("ssm", "hybrid"):
        assert out["none"][3] == arch.n_layers


def test_loss_fn_default_rt_is_no_remat():
    """Serving calls pass no ``rt``: the forward takes its values."""
    arch = configs.tiny_variant(configs.get_arch("qwen3-1.7b"))
    params = init_model(0, arch, F32, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch, 2).items()}
    a, _ = loss_fn(params, arch, batch, F32)
    b, _ = loss_fn(params, arch, batch, F32, rt=RuntimeConfig(remat="full"))
    assert torch.equal(a, b)


def test_train_step_leaves_no_grad_behind():
    """The step makes no ``.grad`` on the params it is given and returns
    params that do not require grad."""
    arch = configs.tiny_variant(configs.get_arch("mamba2-130m"))
    params = init_model(0, arch, device="cpu")
    opt = adamw.init(params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch, 2).items()}
    step = make_train_step(arch, RuntimeConfig(remat="none"),
                           DTypePolicy.standard())
    p2, o2, _ = step(params, opt, batch)
    p3, _, _ = step(p2, o2, batch)
    for _, t in list(_flat(params)) + list(_flat(p3)):
        assert t.grad is None and not t.requires_grad


def test_loss_decreases_on_repeated_batch():
    arch = configs.tiny_variant(configs.get_arch("qwen3-1.7b"))
    params = init_model(0, arch, device="cpu")
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    batch = {"tokens": torch.full((2, 32), 3, dtype=torch.int32),
             "labels": torch.full((2, 32), 5, dtype=torch.int32)}
    step = make_train_step(arch, RuntimeConfig(remat="none"),
                           DTypePolicy.standard(), cfg)
    losses = []
    for _ in range(8):
        params, opt, stats = step(params, opt, batch)
        losses.append(float(stats["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


# ----------------------------------------------------------------------
# train.main (the counterparts of the reference's train tests)
# ----------------------------------------------------------------------
def test_train_main_tiny(tmp_path):
    from repro_torch.launch.train import main
    out = main([
        "--preset", "tiny", "--steps", "25", "--batch", "4", "--seq", "64",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
        "--log-every", "10", "--device", "cpu",
    ])
    assert out["final_loss"] < out["first_loss"]
    assert out["steps"] == 25 and len(out["step_ms"]) == 25


def test_train_main_crash_recovery(tmp_path):
    from repro_torch.launch.train import main
    out = main([
        "--arch", "mamba2-130m", "--preset", "tiny", "--steps", "16",
        "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "50", "--simulate-failure", "8", "--log-every", "8",
        "--device", "cpu",
    ])
    assert out["steps"] >= 16  # re-ran the post-crash steps


def test_train_main_compressed_grads(tmp_path):
    from repro_torch.launch.train import main
    out = main([
        "--preset", "tiny", "--steps", "20", "--batch", "4", "--seq", "32",
        "--ckpt-dir", str(tmp_path), "--compress-grads",
        "--log-every", "10", "--device", "cpu",
    ])
    assert out["final_loss"] < out["first_loss"]


def test_train_main_accum_and_resume(tmp_path):
    """--accum 2 learns; --resume starts from the latest checkpoint."""
    from repro_torch.launch.train import main
    args = ["--preset", "tiny", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "5", "--accum",
            "2", "--lr", "3e-3", "--device", "cpu"]
    out = main(args + ["--steps", "10"])
    assert out["final_loss"] < out["first_loss"]
    out = main(args + ["--steps", "20", "--resume"])
    assert out["steps"] == 10


def test_train_main_needs_a_device_or_cpu(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "tiny", "--steps", "2"])
