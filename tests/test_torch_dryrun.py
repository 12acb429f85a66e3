"""The dry run on a fake world, and the roofline counters, on the CPU.

``test_dryrun_mini_mesh_all_families`` is the counterpart of the
reference's ``test_dryrun_mini_mesh_all_families``: the tiny train step
of the same seven families, with remat full and accumulation 2, run once
on a fake (4 data, 2 model) mesh through the dry run's own path
(``plan_cell`` + ``trace_step``), in a subprocess; all seven come back
with counted flops.

The counters (``launch/roofline.py``) count what one device runs:
  * on a (1, 1) mesh the sharded step's flops equal
    ``FlopCounterMode``'s count of the plain step;
  * on (4, 2) a matmul sharded by TP and FSDP counts exactly 1/8 of its
    global flops, and the weight's gather is counted as an all-gather;
  * payloads count in their real dtypes (an f32 all-reduce at 4 bytes an
    element, a bf16 one at 2), not the reference's f32-as-bf16 rule.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch, tiny_variant
from repro_torch.configs.base import RuntimeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.launch.roofline import DeviceCounters
from repro_torch.launch.steps import make_train_step
from repro_torch.models import DTypePolicy, init_model
from repro_torch.optim import adamw

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("qwen3-1.7b", "dbrx-132b", "mamba2-130m", "zamba2-2.7b",
            "internvl2-1b", "seamless-m4t-medium", "minicpm3-4b")


def test_dryrun_mini_mesh_all_families():
    code = textwrap.dedent(f"""
        import dataclasses as dc
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import SHAPES, get_arch, tiny_variant
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import fake_world, make_test_mesh

        shape = dc.replace(SHAPES["train_4k"], seq_len=32, global_batch=8)
        rt = dict(remat="full", accum_steps=2, seq_shard_acts=True)
        with fake_world(8):
            mesh = make_test_mesh((4, 2), ("data", "model"),
                                  device_type="cpu")
            for name in {FAMILIES!r}:
                plan = dryrun.plan_cell(tiny_variant(get_arch(name)), shape,
                                        {{"data": 4, "model": 2}},
                                        rt_overrides=rt)
                c, s = dryrun.trace_step(plan, mesh)
                assert c.flops > 0 and c.bytes > 0 and c.collective_bytes > 0
                print("TRACED", name, round(s, 1), c.flops,
                      c.collective_bytes, flush=True)
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=400, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-4000:]
    print(out.stdout)
    assert out.stdout.count("TRACED") == len(FAMILIES)


@pytest.fixture(scope="module")
def world():
    """A fake world of 8 ranks for this module's meshes."""
    with fake_world(8):
        yield {"11": make_test_mesh((1, 1), device_type="cpu"),
               "42": make_test_mesh((4, 2), device_type="cpu")}


def test_one_device_flops_equal_flop_counter(world):
    """On a (1, 1) mesh the counters see the plain step's local ops: the
    same flops as ``FlopCounterMode`` counts for the step without a
    mesh."""
    mesh = world["11"]
    arch = tiny_variant(get_arch("qwen3-1.7b"), n_layers=2, vocab=128)
    policy = DTypePolicy.standard()
    rt = RuntimeConfig(remat="none")
    params = init_model(0, arch, policy, "cpu")
    opt = adamw.init(params, policy)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, 127, (8, 32), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(arch, rt, policy)
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    pps = shd.param_pspecs(params, mesh)
    dp = shd.place(params, pps, mesh)
    do = shd.place(opt, {"m": pps, "v": pps, "step": shd.P()}, mesh)
    db = shd.place(batch, shd.input_pspecs(batch, mesh, 8), mesh)
    with shd.activation_sharding(mesh, shd.batch_axes_for(mesh, 8)), \
            DeviceCounters() as c:
        step(dp, do, db)
    assert fc.get_total_flops() > 0
    assert c.flops == fc.get_total_flops()


def test_tp_fsdp_matmul_counts_an_eighth(world):
    mesh = world["42"]
    b, d, f = 16, 32, 24
    x = shd.place(torch.randn(b, d), shd.P("data", None), mesh)
    w = shd.place(torch.randn(d, f), shd.P("data", "model"), mesh)
    with DeviceCounters() as c:
        y = x @ w
    assert isinstance(y, DTensor)
    assert c.flops * 8 == 2 * b * d * f
    # FSDP: the weight's data shards are gathered, [d, f / 2] f32
    assert c.payload["all-gather"] == d * (f // 2) * 4
    assert c.collectives["all-reduce"] == 0


def test_payloads_count_in_their_dtypes(world):
    """A Partial(sum) reduced to Replicate is one all-reduce: 4 bytes an
    f32 element (2 for bf16), times the ring factor 2."""
    mesh = world["42"]
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        t = DTensor.from_local(torch.ones(8, 8, dtype=dtype), mesh,
                               [Replicate(), Partial()], run_check=False)
        with DeviceCounters() as c:
            t.redistribute(mesh, [Replicate(), Replicate()])
        assert c.payload["all-reduce"] == 64 * size
        assert c.collectives["all-reduce"] == 2 * 64 * size
        assert c.collective_bytes == 2 * 64 * size
    t = DTensor.from_local(torch.ones(4, 8), mesh, [Shard(0), Replicate()],
                           run_check=False)
    with DeviceCounters() as c:
        t.redistribute(mesh, [Replicate(), Replicate()])
    assert c.payload["all-gather"] == 16 * 8 * 4
