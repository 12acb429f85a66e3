"""The port's sharding rules, specs, runtime resolution, state bytes and
roofline arithmetic against the reference, on the CPU.

The rules read only a mesh's axis sizes, so both packages take the same
``SimpleNamespace(shape=...)`` stand-in for the production meshes and
every comparison is exact: ``param_pspecs`` of all ten architectures at
full width on the single- and multi-pod meshes in both axis profiles,
``cache_pspecs`` and ``input_pspecs`` of every applicable (arch x shape),
``resolve_runtime`` of every cell, the abstract params, cache and inputs
(shapes and dtypes against ``jax.eval_shape``), and the dry run's
``state_bytes_per_device`` against the reference's
``_tree_bytes_sharded`` (and the values ``chip_smoke.py`` holds the
card's dry-run rows to).  Importing the reference's dry run sets
``XLA_FLAGS``: the fixture brings JAX's backend up first and puts the
variable back.  Placements are held on a DeviceMesh in a fake world.
"""
import dataclasses
import math
import os
import pathlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.models.common import named_leaves

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
MESHES = {"single": SINGLE, "multi": MULTI}


def _jax_leaves(tree):
    """(path, leaf) of a JAX pytree of dicts, sorted keys (JAX's order)."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP)):
        out.append((tuple(k.key for k in path), leaf))
    return out


def _same_specs(port_tree, ref_tree):
    got = [(p, tuple(s)) for p, s in named_leaves(port_tree)]
    want = [(p, tuple(s)) for p, s in _jax_leaves(ref_tree)]
    assert got == want


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _same_shapes(port_tree, ref_tree):
    got = [(p, tuple(t.shape), _dtype_name(t.dtype))
           for p, t in named_leaves(port_tree)]
    want = [(p, tuple(t.shape), _dtype_name(t.dtype))
            for p, t in _jax_leaves(ref_tree)]
    assert got == want


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()          # the backend is up before the flag is set
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jdryrun


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_pspecs_match_reference(name):
    jarch, arch = jconfigs.get_arch(name), configs.get_arch(name)
    jparams = jspecs.abstract_params(jarch)
    params = specs.abstract_params(arch)
    _same_shapes(params, jparams)
    for sizes in MESHES.values():
        for profile in ("tp", "dp"):
            _same_specs(shd.param_pspecs(params, sizes, profile),
                        jshd.param_pspecs(jparams,
                                          SimpleNamespace(shape=sizes),
                                          profile))
    # without a mesh no axis is dropped
    _same_specs(shd.param_pspecs(params), jshd.param_pspecs(jparams))


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_cache_and_input_pspecs_match_reference(name):
    jarch, arch = jconfigs.get_arch(name), configs.get_arch(name)
    for shape_name, shape in configs.SHAPES.items():
        if not configs.shape_applicable(arch, shape)[0]:
            continue
        jshape = jconfigs.SHAPES[shape_name]
        rt = specs.resolve_runtime(arch, shape)
        jrt = jspecs.resolve_runtime(jarch, jshape)
        batch, jbatch = specs.input_specs(arch, shape, rt), \
            jspecs.input_specs(jarch, jshape, jrt)
        _same_shapes(batch, jbatch)
        if shape.kind == "decode":
            cache = specs.cache_specs(arch, shape, rt)
            jcache = jspecs.cache_specs(jarch, jshape, jrt)
            _same_shapes(cache, jcache)
        for sizes in MESHES.values():
            mesh = SimpleNamespace(shape=sizes)
            for include_model in (False, True):
                baxes = shd.batch_axes_for(sizes, shape.global_batch,
                                           include_model)
                assert baxes == jshd.batch_axes_for(
                    mesh, shape.global_batch, include_model)
                _same_specs(
                    shd.input_pspecs(batch, sizes, shape.global_batch, baxes),
                    jshd.input_pspecs(jbatch, mesh, shape.global_batch,
                                      baxes))
            _same_specs(shd.input_pspecs(batch, sizes, shape.global_batch),
                        jshd.input_pspecs(jbatch, mesh, shape.global_batch))
            if shape.kind == "decode":
                for kv in ("auto", "heads", "seq"):
                    _same_specs(
                        shd.cache_pspecs(cache, sizes, shape.global_batch,
                                         kv),
                        jshd.cache_pspecs(jcache, mesh, shape.global_batch,
                                          kv))


@pytest.mark.parametrize("sizes,batch,include_model", [
    (SINGLE, 256, False), (SINGLE, 8, False), (SINGLE, 1, False),
    (SINGLE, 24, False), (MULTI, 256, False), (MULTI, 16, False),
    (MULTI, 2, False), (MULTI, 1, False), (MULTI, 512, True),
    (SINGLE, 4096, True), (SINGLE, 32, True), ({"model": 4}, 8, False),
    ({"pod": 2, "data": 3}, 6, False), ({"pod": 4, "data": 2}, 2, False),
])
def test_batch_axes_for_edges(sizes, batch, include_model):
    assert shd.batch_axes_for(sizes, batch, include_model) == \
        jshd.batch_axes_for(SimpleNamespace(shape=sizes), batch,
                            include_model)


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_resolve_runtime_matches_reference(name):
    jarch, arch = jconfigs.get_arch(name), configs.get_arch(name)
    for shape_name, shape in configs.SHAPES.items():
        for n in (16, 32):
            for profile in ("baseline", "opt"):
                got = specs.resolve_runtime(arch, shape, n, profile)
                want = jspecs.resolve_runtime(
                    jarch, jconfigs.SHAPES[shape_name], n, profile)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                pol, jpol = specs.policy_for(got), jspecs.policy_for(want)
                assert [_dtype_name(d) for d in (pol.params, pol.compute,
                                                 pol.moments)] == \
                    [_dtype_name(d) for d in (jpol.params, jpol.compute,
                                              jpol.moments)]


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_opt_state_specs_match_reference(name):
    jarch, arch = jconfigs.get_arch(name), configs.get_arch(name)
    for preset in ("standard", "lean", "ultra_lean"):
        rt = configs.RuntimeConfig(dtype_preset=preset)
        jrt = jconfigs.RuntimeConfig(dtype_preset=preset)
        params = specs.abstract_params(arch, rt)
        jparams = jspecs.abstract_params(jarch, jrt)
        _same_shapes(params, jparams)
        _same_shapes(specs.abstract_opt_state(params, rt),
                     jspecs.abstract_opt_state(jparams, jrt))


def _ref_state_bytes(jdryrun, jarch, jshape, sizes, profile):
    """The reference dry run's analytic state bytes, as its run_cell
    computes them."""
    mesh = SimpleNamespace(shape=sizes)
    rt = jspecs.resolve_runtime(
        jarch, jshape, n_data_shards=sizes["data"] * sizes.get("pod", 1),
        profile=profile)
    policy = jspecs.policy_for(rt)
    pspec = jspecs.abstract_params(jarch, rt)
    pps = jshd.param_pspecs(pspec, mesh, rt.axis_profile)
    param_bytes = jdryrun._tree_bytes_sharded(pspec, pps, mesh)
    state = param_bytes
    if jshape.kind == "train":
        state += 2 * (param_bytes * policy.moments.dtype.itemsize //
                      jax.tree.leaves(pspec)[0].dtype.itemsize)
    if jshape.kind == "decode":
        cspec = jspecs.cache_specs(jarch, jshape, rt)
        cps = jshd.cache_pspecs(cspec, mesh, jshape.global_batch, rt.kv_shard)
        state += jdryrun._tree_bytes_sharded(cspec, cps, mesh)
    return state


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_state_bytes_match_reference(name, ref_dryrun):
    jarch, arch = jconfigs.get_arch(name), configs.get_arch(name)
    for shape_name, shape in configs.SHAPES.items():
        if not configs.shape_applicable(arch, shape)[0]:
            continue
        for sizes in MESHES.values():
            for profile in ("baseline", "opt"):
                plan = dryrun.plan_cell(arch, shape, sizes, profile)
                want = _ref_state_bytes(ref_dryrun, jarch,
                                        jconfigs.SHAPES[shape_name], sizes,
                                        profile)
                assert plan.state_bytes == want, (shape_name, sizes,
                                                  profile)
                assert plan.n_params == sum(
                    math.prod(t.shape) for t in jax.tree.leaves(
                        jspecs.abstract_params(jarch, jspecs.resolve_runtime(
                            jarch, jconfigs.SHAPES[shape_name]))))


def test_smoke_state_bytes_are_the_references(ref_dryrun):
    """``chip_smoke.py`` phase 14(d) holds the card's dry-run rows to
    ``DRYRUN_STATE_BYTES``: those are the reference's own values."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    name = smoke.DRYRUN_ARGS[smoke.DRYRUN_ARGS.index("--arch") + 1]
    shape = smoke.DRYRUN_ARGS[smoke.DRYRUN_ARGS.index("--shape") + 1]
    assert "--both-meshes" in smoke.DRYRUN_ARGS
    want = {f"pod{'x'.join(map(str, sizes.values()))}": _ref_state_bytes(
        ref_dryrun, jconfigs.get_arch(name), jconfigs.SHAPES[shape], sizes,
        "baseline") for sizes in (SINGLE, MULTI)}
    assert smoke.DRYRUN_STATE_BYTES == want


def test_model_flops_match_reference():
    for args in ((1e9, 1000, "train"), (1e9, 128, "decode"),
                 (10e9, 128, "decode", int(3e9)), (7e9, 4096, "prefill")):
        assert roofline.model_flops(*args) == jroofline.model_flops(*args)
    assert roofline.model_flops(1e9, 1000, "train") == 6e12
    assert roofline.model_flops(10e9, 128, "decode",
                                active_params=int(3e9)) == 2 * 3e9 * 128


def test_report_terms_and_dominant():
    """The reference's report test with the H100 figures."""
    hw = roofline.HW
    rep = roofline.RooflineReport(
        arch="a", shape="s", mesh="m", chips=256,
        flops_per_device=hw["peak_flops"],            # exactly 1 s
        hbm_bytes_per_device=hw["hbm_bw"] / 2,        # 0.5 s
        collective_bytes_per_device=hw["link_bw"] * 2,  # 2 s
        collectives={}, model_flops_global=hw["peak_flops"] * 256 * 0.5)
    assert abs(rep.compute_s - 1.0) < 1e-9
    assert abs(rep.memory_s - 0.5) < 1e-9
    assert rep.dominant == "collective"
    assert abs(rep.step_s - 2.0) < 1e-9
    assert abs(rep.mfu - 0.25) < 1e-9
    assert abs(rep.useful_flops_ratio - 0.5) < 1e-9
    assert set(rep.row()) == {
        "arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
        "dominant", "model_flops", "useful_ratio", "mfu_bound",
        "collectives"}
    # the H100 SXM's figures (NVIDIA data sheet) and one 400 Gb/s port
    assert hw["peak_flops"] == 989e12 and hw["hbm_bw"] == 3.35e12
    assert hw["link_bw"] == 50e9 and hw["hbm_bytes"] == 80e9


@pytest.fixture(scope="module")
def fake8():
    """A fake world of 8 ranks (this process rank 0) for the test's
    meshes, destroyed after the module."""
    with fake_world(8):
        yield {"42": make_test_mesh((4, 2), ("data", "model"),
                                    device_type="cpu"),
               "222": make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                                     device_type="cpu")}


@pytest.fixture
def mesh42(fake8):
    return fake8["42"]


@pytest.fixture
def mesh3(fake8):
    return fake8["222"]


@pytest.mark.parametrize("spec,want", [
    (shd.P(), (Replicate(), Replicate())),
    (shd.P(None, None), (Replicate(), Replicate())),
    (shd.P("data", None), (Shard(0), Replicate())),
    (shd.P(None, "model"), (Replicate(), Shard(1))),
    (shd.P("model", "data"), (Shard(1), Shard(0))),
    (shd.P(None, "data", "model"), (Shard(1), Shard(2))),
    (shd.P(("data", "model"), None), (Shard(0), Shard(0))),
    (shd.P(None, ("data", "model")), (Shard(1), Shard(1))),
])
def test_placements_two_axes(mesh42, spec, want):
    assert shd.to_placements(spec, mesh42) == want


@pytest.mark.parametrize("spec,want", [
    (shd.P(("pod", "data"), None, None), (Shard(0), Shard(0), Replicate())),
    (shd.P(("pod", "data"), None, "model"), (Shard(0), Shard(0), Shard(2))),
    (shd.P(None, ("pod", "data", "model")), (Shard(1), Shard(1), Shard(1))),
    (shd.P("pod", "model", "data"), (Shard(0), Shard(2), Shard(1))),
    (shd.P(None, None), (Replicate(), Replicate(), Replicate())),
])
def test_placements_three_axes(mesh3, spec, want):
    assert shd.to_placements(spec, mesh3) == want


@pytest.mark.parametrize("spec,match", [
    (shd.P(("model", "data")), "mesh order"),
    (shd.P(("data", "pod"), None), "mesh order"),
    (shd.P("data", "data"), "twice"),
    (shd.P("expert"), "not in the mesh"),
])
def test_placements_refuse(mesh3, spec, match):
    with pytest.raises(ValueError, match=match):
        shd.to_placements(spec, mesh3)


def test_place_keeps_the_jax_shard(mesh42):
    """Rank 0's shard of a tuple-axis spec is the first block in JAX's
    (tuple-order) layout, and every rule spec of a model places."""
    t = torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6)
    d = shd.place(t, shd.P(("data", "model"), None), mesh42)
    assert torch.equal(d.to_local(), t[:8])
    d = shd.place(t, shd.P(None, "model"), mesh42)
    assert torch.equal(d.to_local(), t[:, :3])
    arch = configs.tiny_variant(configs.get_arch("qwen3-1.7b"))
    params = specs.abstract_params(arch)
    pps = shd.param_pspecs(params, mesh42)
    named = shd.to_named(pps, mesh42)
    for (path, spec), (_, np_) in zip(named_leaves(pps),
                                      named_leaves(named)):
        assert np_.placements == shd.to_placements(spec, mesh42), path
    placed = shd.place(params, pps, mesh42)
    for (path, t), (_, p) in zip(named_leaves(params), named_leaves(placed)):
        assert tuple(p.shape) == tuple(t.shape), path


def _ssd_inputs(g, bt, h, q, p, n):
    x = torch.randn(bt, h, q, p, generator=g)
    dt = torch.rand(bt, h, q, generator=g) * 0.1
    cum = torch.cumsum(-dt, dim=-1)
    return (x, dt, cum, torch.randn(bt, q, n, generator=g),
            torch.randn(bt, q, n, generator=g),
            torch.randn(bt, h, p, n, generator=g))


@pytest.mark.parametrize("x_place,want", [
    ((Shard(0), Shard(1)), (Shard(0), Shard(1))),
    ((Shard(1), Shard(0)), (Shard(1), Shard(0))),
    ((Shard(0), Replicate()), (Shard(0), Replicate())),
])
def test_ssd_chunk_through_local_map(mesh42, x_place, want):
    """The SSD chunk on DTensors: a Shard on Bt or H stays local (B and
    C follow Bt, and are replicated over a head-sharding mesh dim), each
    rank's outputs are its block of the plain chunk's, and the gradient
    flows back through the map to every input."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    ins = [t.requires_grad_() for t in _ssd_inputs(g, 8, 4, 6, 5, 3)]
    y_ref, h_ref = ops.ssd_chunk(*ins)
    (y_ref.sum() + h_ref.sum()).backward()
    rows = tuple(p if p.is_shard(0) else Replicate() for p in x_place)
    placed = [distribute_tensor(t.detach(), mesh42,
                                rows if i in (3, 4) else x_place,
                                src_data_rank=None).requires_grad_()
              for i, t in enumerate(ins)]
    y, h = ops.ssd_chunk(*placed)
    assert y.placements == want and h.placements == want
    i, j = mesh42.get_local_rank("data"), mesh42.get_local_rank("model")

    def block(t, place):
        for mdim, p in enumerate(place):
            if p.is_shard():
                n = mesh42.size(mdim)
                k = (i, j)[mdim]
                size = t.shape[p.dim] // n
                t = t.narrow(p.dim, k * size, size)
        return t

    assert torch.equal(y.to_local(), block(y_ref, want))
    assert torch.equal(h.to_local(), block(h_ref, want))
    (y.to_local().sum() + h.to_local().sum()).backward()
    assert all(t.grad is not None for t in placed)
    assert torch.allclose(placed[0].grad.to_local(),
                          block(ins[0].grad, want), rtol=1e-5, atol=1e-6)


def test_ssd_chunk_redistributes_other_placements(mesh42):
    """A Shard on Q or P is neither batch nor head: the map replicates
    it first, and the outputs come back replicated over that mesh dim."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(1)
    ins = _ssd_inputs(g, 8, 4, 6, 4, 3)
    placed = [distribute_tensor(
        t, mesh42, (Shard(0), Shard(2) if t.ndim == 4 else Replicate()),
        src_data_rank=None) for t in ins]
    y, h = ops.ssd_chunk(*placed)
    assert y.placements == (Shard(0), Replicate())
    assert tuple(y.to_local().shape) == (2, 4, 6, 4)


def test_gather_and_decode_refuse_dtensors(mesh42):
    from repro_torch.kernels import ops
    table = shd.place(torch.randn(16, 4), shd.P(None, None), mesh42)
    with pytest.raises(TypeError, match="no DTensor"):
        ops.amm_gather(table, torch.arange(4), n_banks=4)
    q = shd.place(torch.randn(1, 2, 4), shd.P(None, None, None), mesh42)
    k = torch.randn(1, 1, 8, 4)
    with pytest.raises(TypeError, match="no DTensor"):
        ops.kv_decode(q, k, k, torch.tensor([5]), n_banks=2)
