"""The port's training substrate on the CPU: AdamW, the synthetic data
pipeline, checkpoints and the fault-tolerance runtime, as
tests/test_substrate.py holds the reference's, and against the
reference itself.

Against JAX: ``cosine_lr`` at steps 0-120 and ``update`` on
JAX-initialised tiny params with the same gradients and state (the
``conv_b`` decay quirk included) within 1e-6 (f32, one rounding of each
operation apart: XLA and PyTorch may round ``b ** step`` and the sqrt
differently in the last place); ``SyntheticCorpus`` batches and
``embedding_trace`` bit-equal (both are numpy); ``compressed_grad_tree``
bit-equal in ``q`` over three steps of error feedback; checkpoints
written by either package restore in the other bit-equal, a bf16 leaf
included, and the port restores a bf16 leaf in a fresh interpreter that
has imported neither jax nor ml_dtypes.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import compressed_grad_tree as jax_compressed_grad_tree
from repro.runtime import compress_int8 as jax_compress_int8
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro_torch.optim import adamw
from repro_torch.runtime import (HeartbeatMonitor, StragglerPolicy,
                                 compress_int8, compressed_grad_tree,
                                 decompress_int8, elastic_mesh_shape,
                                 plan_rescale)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _hold_tree(got, want, atol, rtol, what=""):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=atol, rtol=rtol, err_msg=f"{what}{k}")


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------
def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                            weight_decay=0.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, stats = adamw.update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.1
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 150


def test_adamw_clips_gradients():
    params = {"w": torch.ones((4,))}
    state = adamw.init(params)
    cfg = adamw.AdamWConfig(clip_norm=1.0)
    _, _, stats = adamw.update({"w": torch.full((4,), 1e6)}, state, params,
                               cfg)
    assert float(stats["grad_norm"]) > 1e5  # reported pre-clip


def test_cosine_schedule_shape():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(adamw.cosine_lr(cfg, torch.tensor(0))) == 0.0
    assert abs(float(adamw.cosine_lr(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert float(adamw.cosine_lr(cfg, torch.tensor(100))) <= 0.11


@pytest.mark.parametrize("warmup,total", [(10, 100), (20, 50), (0, 1)])
def test_cosine_lr_matches_jax(warmup, total):
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    jcfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=warmup,
                              total_steps=total)
    steps = np.arange(121, dtype=np.int32)
    got = adamw.cosine_lr(cfg, torch.from_numpy(steps))
    want = jadamw.cosine_lr(jcfg, jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_adamw_decay_rule_is_the_references():
    """Decay needs a decayable path and rank >= 2: a stacked conv_b
    [L, C] is decayed (not in the list, 2-D by stacking), a stacked norm
    scale and A_log are not, a 1-D tensor never is."""
    assert adamw._decayable(("blocks", "mamba", "conv_b"))
    assert not adamw._decayable(("blocks", "mamba", "A_log"))
    assert not adamw._decayable(("blocks", "ln", "scale"))
    params = {"blocks": {"conv_b": torch.ones((2, 3)),
                         "ln": {"scale": torch.ones((2, 3))}},
              "vec": torch.ones((3,))}
    zeros = {"blocks": {"conv_b": torch.zeros((2, 3)),
                        "ln": {"scale": torch.zeros((2, 3))}},
             "vec": torch.zeros((3,))}
    cfg = adamw.AdamWConfig(lr=0.5, warmup_steps=0, weight_decay=0.1)
    new, _, _ = adamw.update(zeros, adamw.init(params), params, cfg)
    assert bool((new["blocks"]["conv_b"] < 1).all())
    assert torch.equal(new["blocks"]["ln"]["scale"], params["blocks"]["ln"]
                       ["scale"])
    assert torch.equal(new["vec"], params["vec"])


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_update_matches_jax(moments):
    """``update`` on JAX-initialised tiny mamba2 params (a stacked
    ``conv_b`` among them) over three steps of the same gradients: new
    params, moments and stats within 1e-6.  With f32 moments the port
    carries its own state; with bf16 moments each step starts from
    JAX's state, since an f32 moment one rounding apart can round to
    another bf16 value (those moments are held at one bf16 step)."""
    from repro_torch.models import DTypePolicy
    jpol = (jcommon.DTypePolicy.standard() if moments == "f32"
            else jcommon.DTypePolicy.lean())
    tpol = (DTypePolicy.standard() if moments == "f32"
            else DTypePolicy.lean())
    arch = jconfigs.tiny_variant(jconfigs.get_arch("mamba2-130m"))
    jp = jlm.init_model(jax.random.PRNGKey(3), arch)
    assert jp["blocks"]["mamba"]["conv_b"].ndim == 2
    rng = np.random.default_rng(11)
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    grads = [jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.01)
        for x in leaves]) for _ in range(3)]
    cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tcfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jupdate = jax.jit(lambda g, s, p: jadamw.update(g, s, p, cfg, jpol))
    jstate = jadamw.init(jp, jpol)
    tparams = params_from_numpy(_np(jp), "cpu")
    tstate = adamw.init(tparams, tpol)
    mtol = 1e-6 if moments == "f32" else 2.0 ** -7
    for g in grads:
        if moments == "bf16":
            tstate = {"m": params_from_numpy(_np(jstate["m"]), "cpu"),
                      "v": params_from_numpy(_np(jstate["v"]), "cpu"),
                      "step": torch.tensor(int(jstate["step"]),
                                           dtype=torch.int32)}
        jp2, jstate, jstats = jupdate(g, jstate, jp)
        tparams2, tstate, tstats = adamw.update(
            params_from_numpy(_np(g), "cpu"), tstate, tparams, tcfg, tpol)
        _hold_tree(tparams2, _np(jp2), 1e-6, 1e-6, "params/")
        _hold_tree(tstate["m"], _np(jstate["m"]), 1e-8, mtol, "m/")
        _hold_tree(tstate["v"], _np(jstate["v"]), 1e-10, mtol, "v/")
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)
        # the next step from the same params on both sides
        jp, tparams = jp2, params_from_numpy(_np(jp2), "cpu")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["m"]["embed"].dtype == tpol.moments


def test_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"b": {"z": rng.standard_normal((5, 7)).astype(np.float32),
                  "a": rng.standard_normal((3,)).astype(np.float32)},
            "a": rng.standard_normal((4, 4)).astype(np.float32)}
    got = adamw.global_norm(params_from_numpy(tree, "cpu"))
    want = jadamw.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
def test_data_deterministic_and_shaped():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=4)
    it1 = SyntheticCorpus(cfg).batch_iter()
    it2 = SyntheticCorpus(cfg).batch_iter()
    b1, b2 = next(it1), next(it2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_data_shards_disjoint():
    a = SyntheticCorpus(DataConfig(vocab=100, seq_len=16, global_batch=8,
                                   n_shards=2, shard_id=0))
    b = SyntheticCorpus(DataConfig(vocab=100, seq_len=16, global_batch=8,
                                   n_shards=2, shard_id=1))
    ba, bb = next(a.batch_iter()), next(b.batch_iter())
    assert ba["tokens"].shape == (4, 16)
    assert not np.array_equal(ba["tokens"], bb["tokens"])


def test_prefetch_loader():
    corpus = SyntheticCorpus(DataConfig(vocab=50, seq_len=8, global_batch=2))
    loader = PrefetchLoader(corpus)
    batches = [next(loader) for _ in range(3)]
    loader.close()
    assert all(b["tokens"].shape == (2, 8) for b in batches)
    want = corpus.batch_iter()
    for b in batches:
        np.testing.assert_array_equal(b["tokens"], next(want)["tokens"])
    loader._t.join(timeout=10)
    assert not loader._t.is_alive()


@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=32, global_batch=4),
    dict(vocab=50280, seq_len=64, global_batch=8, n_shards=2, shard_id=1,
         zipf_alpha=1.05, seed=7)])
def test_corpus_bit_equal_to_jax(kw):
    ours, theirs = SyntheticCorpus(DataConfig(**kw)), JaxCorpus(
        JaxDataConfig(**kw))
    a, b = ours.batch_iter(), theirs.batch_iter()
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    np.testing.assert_array_equal(ours.embedding_trace(1000),
                                  theirs.embedding_trace(1000))


# ----------------------------------------------------------------------
# checkpoint
# ----------------------------------------------------------------------
def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16) * 1.5,
                       "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = _tree()
    mgr.save(10, tree)
    mgr.save(20, tree)
    mgr.save(30, tree)                      # GC should drop step 10
    assert mgr.steps() == [20, 30]
    out = mgr.restore(tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    step = out["nested"]["step"]
    assert step.shape == () and int(step) == 7
    assert torch.equal(mgr.restore(tree, 20)["a"], tree["a"])


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.zeros((128, 128))
    mgr.save(1, {"w": w}, blocking=False)
    w += 1                  # the save holds the values of the call
    mgr.wait()
    assert mgr.latest_step() == 1
    out = mgr.restore({"w": w})
    assert out["w"].shape == (128, 128) and float(out["w"].abs().max()) == 0


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros((5,))})
    with pytest.raises(KeyError):
        mgr.restore({"v": torch.zeros((4,))})


def test_checkpoint_layout_is_the_references(tmp_path):
    """The same tree saved by both packages: the same directory names,
    file names and manifest."""
    import json
    tree = _tree()
    CheckpointManager(str(tmp_path / "t")).save(5, tree)
    jtree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "nested": {"b": jnp.ones((4,), jnp.bfloat16) * 1.5,
                        "step": jnp.asarray(7, jnp.int32)}}
    JaxCheckpointManager(str(tmp_path / "j")).save(5, jtree)
    dt, dj = tmp_path / "t" / "ckpt_00000005", tmp_path / "j" / "ckpt_00000005"
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    mt = json.loads((dt / "manifest.json").read_text())
    mj = json.loads((dj / "manifest.json").read_text())
    assert mt == mj
    for leaf in mt["leaves"]:
        a, b = np.load(dt / leaf["file"]), np.load(dj / leaf["file"])
        assert a.dtype == b.dtype and np.array_equal(a, b), leaf


def test_checkpoint_port_to_jax_and_back(tmp_path):
    """Tiny mamba2 params + AdamW state written by the port restore in
    the JAX package bit-equal, and the JAX package's write of them
    restores in the port bit-equal (a bf16 leaf in both)."""
    arch = configs.tiny_variant(configs.get_arch("mamba2-130m"))
    from repro_torch.models import init_model
    params = init_model(0, arch, device="cpu")
    params["blocks"]["mamba"]["out_proj"] = params["blocks"]["mamba"][
        "out_proj"].to(torch.bfloat16)
    tree = {"params": params, "opt": adamw.init(params)}
    CheckpointManager(str(tmp_path / "port")).save(3, tree)
    jtmpl = jax.tree.map(lambda t: jnp.zeros(t.shape, {
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int32: jnp.int32}[t.dtype]), tree)
    jout = JaxCheckpointManager(str(tmp_path / "port")).restore(jtmpl)
    for (k, t), (_, j) in zip(_flat(tree), _flat(jout)):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert j.dtype.name == "bfloat16", k
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), j.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=k)
    JaxCheckpointManager(str(tmp_path / "jax")).save(4, jout)
    back = CheckpointManager(str(tmp_path / "jax")).restore(tree)
    for (k, t), (_, b) in zip(_flat(tree), _flat(back)):
        assert b.dtype == t.dtype and torch.equal(b, t), k


def test_checkpoint_bf16_restores_without_ml_dtypes(tmp_path):
    """A bf16 leaf written by the JAX package restores in a fresh
    interpreter that imports the port only: no jax, no ml_dtypes."""
    JaxCheckpointManager(str(tmp_path)).save(
        1, {"w": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16),
            "x": jnp.arange(3, dtype=jnp.float32)})
    code = textwrap.dedent(f"""
        import sys, torch
        from repro_torch.checkpoint import CheckpointManager
        out = CheckpointManager({str(tmp_path)!r}).restore(
            {{"w": torch.zeros(3, dtype=torch.bfloat16),
              "x": torch.zeros(3)}})
        assert out["w"].dtype == torch.bfloat16
        assert out["w"].float().tolist() == [1.5, -2.25, 3.0]
        assert out["x"].tolist() == [0.0, 1.0, 2.0]
        bad = [m for m in ("jax", "ml_dtypes") if m in sys.modules]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr


# ----------------------------------------------------------------------
# runtime FT
# ----------------------------------------------------------------------
def test_straggler_detection():
    mon = HeartbeatMonitor(8, StragglerPolicy(min_history=4))
    for t in range(8):
        for w in range(8):
            mon.report(w, 1.0 if w != 3 else 5.0)
    assert mon.stragglers() == [3]


def test_dead_worker_detection():
    mon = HeartbeatMonitor(4, dead_after_s=10.0)
    now = 1000.0
    for w in range(4):
        mon.report(w, 1.0, now=now - (20.0 if w == 2 else 1.0))
    assert mon.dead(now=now) == [2]


def test_elastic_mesh_shapes():
    assert elastic_mesh_shape(512, 16)["shape"] == (2, 16, 16)
    assert elastic_mesh_shape(256, 16)["shape"] == (16, 16)
    m = elastic_mesh_shape(248, 16)
    assert np.prod(m["shape"]) == 248
    plan = plan_rescale(256, 248)
    assert plan.extra_accum_factor >= 1


def test_int8_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(
        (rng.standard_normal((256,)) * 1e-3).astype(np.float32))
    err = None
    acc = torch.zeros_like(g_true)
    for _ in range(64):
        deq, err = compressed_grad_tree(g_true, err)
        acc = acc + deq
    np.testing.assert_allclose((acc / 64).numpy(), g_true.numpy(),
                               atol=2e-5)


def test_int8_roundtrip_bound():
    g = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1000,)).astype(np.float32))
    q, s = compress_int8(g)
    assert q.dtype == torch.int8
    err = (decompress_int8(q, s) - g).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7


def test_compressed_grad_tree_bit_equal_to_jax():
    """Three steps of error feedback over a nested tree (a bf16 leaf
    among them): q of every leaf bit-equal to JAX's, scales and the
    dequantized gradients equal."""
    rng = np.random.default_rng(4)
    steps = [{"w": {"a": rng.standard_normal((8, 5)).astype(np.float32),
                    "b": (rng.standard_normal((7,)) * 1e-4).astype(
                        np.float32)},
              "c": rng.standard_normal((3, 3)).astype(np.float32)}
             for _ in range(3)]
    terr = jerr = None
    for g in steps:
        tg = params_from_numpy(g, "cpu")
        jg = jax.tree.map(jnp.asarray, g)
        tcorr = tg if terr is None else jax.tree.map(
            lambda a, e: a + e, tg, terr)
        jcorr = jg if jerr is None else jax.tree.map(
            lambda a, e: a + e, jg, jerr)
        for (k, t), (_, j) in zip(_flat(tcorr), _flat(jcorr)):
            q, s = compress_int8(t)
            jq, js = jax_compress_int8(j)
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq),
                                          err_msg=k)
            assert float(s) == float(js), k
        tdeq, terr = compressed_grad_tree(tg, terr)
        jdeq, jerr = jax_compressed_grad_tree(jg, jerr)
        for (k, t), (_, j) in zip(_flat(tdeq), _flat(jdeq)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=k)
        for (k, t), (_, j) in zip(_flat(terr), _flat(jerr)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=k)
