"""The mesh-bound group across processes: ranks of one ``gloo`` process
group on the CPU (``tests/_torch_dist_util.py``), each part against the
reference.

* The sharded train step: tiny qwen3-1.7b and mamba2-130m (2 layers,
  vocab 128, B 8 x S 32, remat none), params, AdamW state and batch
  placed by the rules on a (4 data, 2 model) mesh of 8 ranks, the step
  run under the activation sharder.  It is held against the port's
  single-process step and the reference's ``jax.jit(make_train_step)``
  from the same JAX-initialised params: the bf16 step within the
  reference's own distributed test's limits (loss 1e-2, params 5e-2);
  the f32 gradients (``loss_and_grads`` against ``jax.grad``) leaf by
  leaf in relative L2, and the f32 step's update signs, within limits
  set from the distances found, which are printed.  A planted fault, the
  gradient of one data rank before the data-parallel reduction, must
  fail the gradient check.
* The pipeline: 4 ranks on a "pod" axis, the reference test's stack
  (L 8, D 16, M 6, MB 4), against the reference's sequential scan within
  1e-5.
* Compressed sync: a (2 pod, 4 data) mesh of 8 ranks.  gloo carries both
  wire formats, the int8 all-gather and the bf16 all-reduce, so neither
  dtype is changed.  The error is at most half the int8 step (round to
  nearest, plus 1e-4 of a step for the f32 scale), and the counted
  payload is under 0.6x the uncompressed one.
* Elastic restore: a checkpoint saved from 8 ranks restores onto 4 with
  other placements, exactly.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import RuntimeConfig as JaxRuntimeConfig
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from _torch_dist_util import run_ranks

LOSS_TOL, PARAM_TOL = 1e-2, 5e-2       # the reference test's limits
# the f32 gradients, leaf by leaf (relative L2), and the share of the
# f32 step's updates that may move the other way: a tenth of the card's
# gates for the f32 train step (chip_smoke.py phase 12), over ten times
# the distances found here (at most 8.7e-06 relative L2, no flips)
GRAD_TOL, FLIP_SHARE = 1e-4, 1e-4

UNFLAT = """
import numpy as np
def unflat(d, prefix):
    out = {}
    for k in d.files:
        if not k.startswith(prefix):
            continue
        *path, leaf = k[len(prefix):].split("/")
        cur = out
        for p in path:
            cur = cur.setdefault(p, {})
        cur[leaf] = d[k]
    return out
"""


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    want = want.astype(np.float64)
    return float(np.linalg.norm(got.astype(np.float64) - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m"])
def test_sharded_train_step_matches_single_and_reference(tmp_path, name):
    arch = jconfigs.tiny_variant(jconfigs.get_arch(name), n_layers=2,
                                 vocab=128)
    policy = jcommon.DTypePolicy.standard()
    f32 = jcommon.DTypePolicy(jnp.float32, jnp.float32, jnp.float32)
    params = jlm.init_model(jax.random.PRNGKey(0), arch, policy)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 127, (8, 32)).astype(np.int32)
    labels = rng.integers(0, 127, (8, 32)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    rt = JaxRuntimeConfig(remat="none")
    p_ref, _, m_ref = jax.jit(jax_make_train_step(arch, rt, policy))(
        params, jadamw.init(params, policy), jbatch)
    p_ref32, _, _ = jax.jit(jax_make_train_step(arch, rt, f32))(
        params, jadamw.init(params, f32), jbatch)
    g_ref = jax.jit(jax.grad(
        lambda p: jlm.loss_fn(p, arch, jbatch, rt, f32)[0]))(params)
    np.savez(tmp_path / "in.npz", tokens=tokens, labels=labels,
             **{f"p/{k}": v for k, v in _flat(params)})
    run_ranks(tmp_path, UNFLAT + textwrap.dedent(f"""
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_arch, tiny_variant
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.convert import params_from_numpy
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.steps import loss_and_grads, make_train_step
        from repro_torch.models import DTypePolicy
        from repro_torch.models.common import named_leaves, tree_map
        from repro_torch.optim import adamw

        d = np.load({str(tmp_path / "in.npz")!r})
        arch = tiny_variant(get_arch({name!r}), n_layers=2, vocab=128)
        policy = DTypePolicy.standard()
        f32 = DTypePolicy(torch.float32, torch.float32, torch.float32)
        rt = RuntimeConfig(remat="none")
        params = params_from_numpy(unflat(d, "p/"), "cpu")
        batch = {{"tokens": torch.from_numpy(d["tokens"]),
                  "labels": torch.from_numpy(d["labels"])}}
        mesh = make_test_mesh((4, 2), ("data", "model"), device_type="cpu")
        pps = shd.param_pspecs(params, mesh)
        dp = shd.place(params, pps, mesh)
        db = shd.place(batch, shd.input_pspecs(batch, mesh, 8), mesh)
        assert db["tokens"].to_local().shape == (2, 32)
        full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        out = {{}}
        for tag, pol in (("", policy), ("32", f32)):
            step = make_train_step(arch, rt, pol)
            opt = adamw.init(params, pol)
            do = shd.place(opt, {{"m": pps, "v": pps, "step": shd.P()}},
                           mesh)
            with shd.activation_sharding(mesh, shd.batch_axes_for(mesh, 8)):
                p2, _, m2 = step(dp, do, db)
            assert isinstance(p2["embed"], DTensor)
            out["loss_mesh" + tag] = float(full(m2["loss"]))
            out["mesh" + tag] = tree_map(full, p2)
            if RANK == 0:
                p1, _, m1 = step(params, opt, batch)
                out["loss_single" + tag] = float(m1["loss"])
                out["single" + tag] = p1
        with shd.activation_sharding(mesh, shd.batch_axes_for(mesh, 8)):
            _, _, g2 = loss_and_grads(dp, arch, db, rt, f32)
        out["gmesh"] = tree_map(full, g2)
        if RANK == 0:
            _, _, out["gsingle"] = loss_and_grads(params, arch, batch, rt,
                                                  f32)
            # the planted fault: the gradient rank 0 holds before the
            # data-parallel reduction, its own 2 of the 8 rows' part of
            # the loss over all 8 rows
            _, _, g0 = loss_and_grads(
                params, arch, {{k: v[:2] for k, v in batch.items()}}, rt, f32)
            out["gfault"] = tree_map(lambda t: t * 2 / 8, g0)
            flat = {{}}
            for tag, v in out.items():
                if isinstance(v, float):
                    flat[tag] = v
                    continue
                for leaf, t in named_leaves(v):
                    flat[tag + "/" + "/".join(leaf)] = t.float().numpy()
            np.savez({str(tmp_path / "out.npz")!r}, **flat)
    """), n=8, timeout=240)
    got = np.load(tmp_path / "out.npz")
    ref, ref32, p0 = dict(_flat(p_ref)), dict(_flat(p_ref32)), \
        dict(_flat(params))
    gref = dict(_flat(g_ref))
    d_single = max(float(np.abs(got[f"mesh/{k}"] - got[f"single/{k}"]).max())
                   for k in ref)
    d_ref = max(float(np.abs(got[f"mesh/{k}"] - v.astype(np.float32)).max())
                for k, v in ref.items())
    loss_mesh = float(got["loss_mesh"])
    # the f32 gradients, leaf by leaf
    g_single = max(_rel_l2(got[f"gmesh/{k}"], got[f"gsingle/{k}"])
                   for k in gref)
    g_vs_ref = max(_rel_l2(got[f"gmesh/{k}"], v) for k, v in gref.items())
    g_fault = max(_rel_l2(got[f"gfault/{k}"], v) for k, v in gref.items())
    # the f32 step's updates p_new - p_old: at step 1 an update is
    # lr * sign(g) (+ decay), so a wrong gradient flips its sign
    flips = {"single": 0, "reference": 0}
    total = 0
    for k, v in p0.items():
        upd = got[f"mesh32/{k}"] - v
        total += upd.size
        flips["single"] += int((np.sign(upd) != np.sign(
            got[f"single32/{k}"] - v)).sum())
        flips["reference"] += int((np.sign(upd) != np.sign(
            ref32[k] - v)).sum())
    print(f"{name} sharded (4, 2) step: bf16 loss {loss_mesh:.6f}, single "
          f"{float(got['loss_single']):.6f}, reference "
          f"{float(m_ref['loss']):.6f}; bf16 params max |diff| "
          f"{d_single:.3g} vs single, {d_ref:.3g} vs reference; f32 "
          f"updates flipped {flips['single']} vs single, "
          f"{flips['reference']} vs reference of {total}; f32 gradients "
          f"worst relative L2 {g_single:.3g} vs single, {g_vs_ref:.3g} vs "
          f"jax.grad (limit {GRAD_TOL:g}); the unreduced data-parallel "
          f"gradient {g_fault:.3g}")
    assert abs(loss_mesh - float(got["loss_single"])) < LOSS_TOL
    assert abs(loss_mesh - float(m_ref["loss"])) < LOSS_TOL
    assert abs(float(got["loss_mesh32"]) - float(got["loss_single32"])) \
        < LOSS_TOL
    assert d_single < PARAM_TOL and d_ref < PARAM_TOL
    assert g_single <= GRAD_TOL and g_vs_ref <= GRAD_TOL
    assert flips["single"] <= FLIP_SHARE * total
    assert flips["reference"] <= FLIP_SHARE * total
    # the gradient check catches a gradient left unreduced over "data"
    assert g_fault > 10 * GRAD_TOL


def test_pipeline_matches_reference_sequential(tmp_path):
    L, D, M, MB = 8, 16, 6, 4
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)

    def seq(h):
        def body(c, lp):
            return jnp.tanh(c @ lp["w"] + lp["b"]), None
        return jax.lax.scan(body, h, {"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)})[0]

    want = np.asarray(jax.vmap(seq)(jnp.asarray(x)))
    np.savez(tmp_path / "in.npz", w=w, b=b, x=x)
    run_ranks(tmp_path, f"""
        import numpy as np
        from torch.distributed.tensor import DTensor
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.runtime.pipeline import pipeline_apply, split_stages

        d = np.load({str(tmp_path / "in.npz")!r})
        mesh = make_test_mesh((4,), ("pod",), device_type="cpu")
        staged = split_stages({{"w": torch.from_numpy(d["w"]),
                               "b": torch.from_numpy(d["b"])}}, 4)
        staged = shd.place(staged, {{"w": shd.P("pod", None, None, None),
                                    "b": shd.P("pod", None, None)}}, mesh)
        assert staged["w"].to_local().shape == (1, 2, 16, 16)
        got = pipeline_apply(lambda lp, h: torch.tanh(h @ lp["w"] + lp["b"]),
                             staged, torch.from_numpy(d["x"]), mesh, "pod")
        np.save({str(tmp_path)!r} + f"/out{{RANK}}.npy", got.numpy())
    """, n=4, timeout=120)
    for r in range(4):
        got = np.load(tmp_path / f"out{r}.npy")
        err = float(np.abs(got - want).max())
        print(f"rank {r}: pipeline max |err| {err:.3g}")
        assert err < 1e-5


def test_compressed_sync_accuracy_and_bytes(tmp_path):
    out = run_ranks(tmp_path, """
        import numpy as np
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.roofline import DeviceCounters
        HALF_STEP = 0.5 + 1e-4
        from repro_torch.runtime.compressed_sync import (
            compressed_pod_mean, uncompressed_pod_mean)

        mesh = make_test_mesh((2, 4), ("pod", "data"), device_type="cpu")
        rng = np.random.default_rng(0)
        g = torch.from_numpy((rng.standard_normal((256, 64)) * 1e-3
                              ).astype(np.float32))
        # the same g on both pods: the mean is g, within half the int8
        # step (round to nearest) and the f32 scale's rounding
        with DeviceCounters() as c_cmp:
            got = compressed_pod_mean({"w": g}, mesh)["w"]
        with DeviceCounters() as c_ref:
            base = uncompressed_pod_mean({"w": g}, mesh)["w"]
        step = float(g.abs().max()) / 127
        err = float((got - g).abs().max())
        assert err <= HALF_STEP * step, (err, step)
        # the bf16 all-reduce's mean is g rounded through bf16
        assert torch.equal(base, g.to(torch.bfloat16).float())
        # pods that differ: pod p holds (p + 1) g, the mean 1.5 g
        pod = mesh.get_local_rank("pod")
        got2 = compressed_pod_mean({"w": g * (pod + 1)}, mesh)["w"]
        step2 = sum(float((g * (p + 1)).abs().max()) / 127
                    for p in range(2)) / 2
        assert float((got2 - 1.5 * g).abs().max()) <= HALF_STEP * step2
        b_cmp, b_ref = c_cmp.collective_bytes, c_ref.collective_bytes
        assert c_cmp.payload["all-gather"] == 2 * 256 * 64 + 2 * 4
        assert c_ref.payload["all-reduce"] == 256 * 64 * 2
        assert b_cmp < 0.6 * b_ref, (b_cmp, b_ref)
        if RANK == 0:
            print("ERR", err, "STEP", step, "BYTES", b_ref, b_cmp)
    """, n=8, timeout=120)
    assert "BYTES" in out
    print(out)


def test_elastic_reshard_restore(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tree = """
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_test_mesh
        tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
                "b": torch.ones(8)}
    """
    run_ranks(tmp_path, textwrap.dedent(tree) + textwrap.dedent(f"""
        mesh8 = make_test_mesh((4, 2), ("data", "model"), device_type="cpu")
        tree8 = shd.place(tree, {{"w": shd.P("data", None),
                                 "b": shd.P(None)}}, mesh8)
        CheckpointManager({ckpt!r}).save(5, tree8)
    """), n=8, timeout=120)
    run_ranks(tmp_path, textwrap.dedent(tree) + textwrap.dedent(f"""
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.runtime import elastic_mesh_shape
        new = elastic_mesh_shape(4, model_parallel=2)
        assert new["shape"] == (2, 2)
        mesh4 = make_test_mesh(new["shape"], new["axes"], device_type="cpu")
        sh4 = shd.to_named({{"w": shd.P("data", "model"),
                            "b": shd.P(None)}}, mesh4)
        out = CheckpointManager({ckpt!r}).restore(tree, shardings=sh4)
        w = out["w"]
        assert isinstance(w, DTensor) and w.placements == (Shard(0), Shard(1))
        i, j = mesh4.get_local_rank("data"), mesh4.get_local_rank("model")
        assert torch.equal(w.to_local(), tree["w"][4 * i:4 * i + 4,
                                                   4 * j:4 * j + 4])
        assert torch.equal(w.full_tensor(), tree["w"])
        assert torch.equal(out["b"].full_tensor(), tree["b"])
        if RANK == 0:
            print("RESHARD_OK")
    """), n=4, timeout=120)
