"""Multi-pod dry run, as ``src/repro/launch/dryrun.py``, over DTensor in
a fake world.

For every (architecture x input shape) cell, run the step program once
against the production mesh -- 16x16 single-pod and 2x16x16 multi-pod --
in a ``fake_world`` of 256 or 512 ranks (this process is rank 0; nothing
runs on a device, so the mesh is a CPU mesh), on params, optimizer
state, cache and inputs placed by the sharding rules as DTensors whose
local shards are ``meta`` tensors: shapes and dtypes only, nothing is
allocated.  (Not ``FakeTensor``s: DTensor's propagation of a strided
shard, which a matmul over split heads makes, reads index values with
``tolist()``, which a fake tensor refuses.)  The step runs under the activation
sharder and ``roofline.DeviceCounters``, which count what rank 0 would
run: flops, matmul/gather bytes and collective bytes by kind.  Each cell
gives one row:

  * analytic, the reference's values: ``status``/``reason``, ``chips``,
    ``n_params``, ``active_params`` (MoE), ``rt``,
    ``state_bytes_per_device`` (params + moments for train, + cache for
    decode, sharded by the rules) and ``model_flops``;
  * counted: ``counted_flops_per_device``, ``counted_bytes_per_device``
    (the counters' bytes plus the analytic optimizer-update traffic),
    ``collective_bytes_per_device``, ``collectives`` by kind and the
    ``roofline`` row with the H100 ``HW``;
  * ``trace_s``, the seconds the step took to run on fake tensors (in
    place of the reference's lower and compile seconds), and the state
    against the H100's 80 GB (``state_share_of_hbm``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.jsonl

A cell that fails is written as ``status: "error"`` with its message,
and the process exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     PRODUCTION_AXES, PRODUCTION_SHAPE,
                                     axis_sizes, fake_world,
                                     make_production_mesh)
from repro_torch.launch.roofline import (HW, DeviceCounters, RooflineReport,
                                         model_flops)
from repro_torch.launch.specs import (abstract_opt_state, abstract_params,
                                      cache_specs, input_specs, policy_for,
                                      resolve_runtime)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.common import named_leaves


def _tree_bytes_sharded(spec_tree: dict, pspec_tree: dict, mesh) -> int:
    """Analytic per-device bytes of a sharded tree."""
    sizes = axis_sizes(mesh)
    specs = dict(named_leaves(pspec_tree))
    total = 0
    for path, leaf in named_leaves(spec_tree):
        shards = 1
        for axis in specs[path]:
            if axis is None:
                continue
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                shards *= sizes[a]
        total += math.prod(leaf.shape) * leaf.element_size() // max(shards,
                                                                    1)
    return total


def mesh_sizes(multi_pod: bool) -> "dict[str, int]":
    """The production mesh's axis sizes, without building it."""
    if multi_pod:
        return dict(zip(MULTI_POD_AXES, MULTI_POD_SHAPE))
    return dict(zip(PRODUCTION_AXES, PRODUCTION_SHAPE))


@dataclasses.dataclass
class CellPlan:
    """Everything about a cell that needs no mesh and no trace."""
    arch: ArchConfig
    shape: ShapeConfig
    rt: object
    params_spec: dict
    param_ps: dict
    batch_spec: dict
    batch_ps: dict
    baxes: tuple
    cache_spec: "dict | None"
    cache_ps: "dict | None"
    n_params: int
    active: "int | None"
    state_bytes: int
    opt_traffic: float
    tokens: int


def plan_cell(arch: ArchConfig, shape: ShapeConfig, sizes: "dict[str, int]",
              profile: str = "baseline", rt_overrides: "dict | None" = None
              ) -> CellPlan:
    """The cell's runtime config, abstract trees, their specs and the
    analytic fields of its row, from the mesh's axis sizes alone."""
    n_batch_shards = sizes["data"] * sizes.get("pod", 1)
    rt = resolve_runtime(arch, shape, n_data_shards=n_batch_shards,
                         profile=profile)
    if rt_overrides:
        rt = dataclasses.replace(rt, **rt_overrides)
    policy = policy_for(rt)
    params_spec = abstract_params(arch, rt)
    param_ps = shd.param_pspecs(params_spec, sizes, rt.axis_profile)
    batch_spec = input_specs(arch, shape, rt)
    baxes = shd.batch_axes_for(sizes, shape.global_batch,
                               include_model=rt.axis_profile == "dp")
    batch_ps = shd.input_pspecs(batch_spec, sizes, shape.global_batch,
                                batch_axes=baxes)
    n_params = sum(math.prod(t.shape) for _, t in named_leaves(params_spec))
    active = None
    if arch.family == "moe":
        # active = non-expert params + top_k/n_experts of expert params
        e_params = arch.n_layers * arch.n_experts * arch.d_model * \
            arch.d_ff * (3 if arch.gated_mlp else 2)
        active = n_params - e_params + e_params * arch.top_k // arch.n_experts
    param_bytes = _tree_bytes_sharded(params_spec, param_ps, sizes)
    state_bytes = param_bytes
    opt_traffic = 0.0
    cache_spec = cache_ps = None
    if shape.kind == "train":
        first = next(named_leaves(params_spec))[1]
        moment_bytes = param_bytes * policy.moments.itemsize // \
            first.element_size()
        state_bytes += 2 * moment_bytes
        # optimizer update: read p,m,v,g + write p,m,v (pure elementwise,
        # invisible to the matmul-based byte counter)
        opt_traffic = 4.0 * param_bytes + 4.0 * moment_bytes
    if shape.kind == "decode":
        cache_spec = cache_specs(arch, shape, rt)
        cache_ps = shd.cache_pspecs(cache_spec, sizes, shape.global_batch,
                                    rt.kv_shard)
        state_bytes += _tree_bytes_sharded(cache_spec, cache_ps, sizes)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return CellPlan(arch, shape, rt, params_spec, param_ps, batch_spec,
                    batch_ps, baxes, cache_spec, cache_ps, n_params, active,
                    state_bytes, opt_traffic, tokens)


def trace_step(plan: CellPlan, mesh) -> "tuple[DeviceCounters, float]":
    """Run the cell's step once on placed fake tensors under the
    activation sharder; returns the counters and the seconds it took."""
    rt, arch, shape = plan.rt, plan.arch, plan.shape
    policy = policy_for(rt)
    t0 = time.perf_counter()
    params = shd.place(plan.params_spec, plan.param_ps, mesh)
    batch = shd.place(plan.batch_spec, plan.batch_ps, mesh)
    if shape.kind == "train":
        opt_spec = abstract_opt_state(plan.params_spec, rt)
        opt_ps = {"m": plan.param_ps, "v": plan.param_ps, "step": shd.P()}
        opt = shd.place(opt_spec, opt_ps, mesh)
        step = make_train_step(arch, rt, policy)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(arch, policy, shape.seq_len)
        args = (params, batch)
    else:
        cache = shd.place(plan.cache_spec, plan.cache_ps, mesh)
        step = make_decode_step(arch, policy, mla_absorb=rt.mla_absorb)
        args = (params, cache, batch["tokens"])
    with shd.activation_sharding(mesh, plan.baxes, rt.seq_shard_acts,
                                 rt.axis_profile), \
            DeviceCounters() as counters:
        step(*args)
    return counters, time.perf_counter() - t0


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             rt_overrides: "dict | None" = None, verbose: bool = True,
             profile: str = "baseline") -> dict:
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}
    sizes = mesh_sizes(multi_pod)
    chips = math.prod(sizes.values())
    plan = plan_cell(arch, shape, sizes, profile, rt_overrides)
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        counters, trace_s = trace_step(plan, mesh)
    rt = plan.rt
    coll = {k: float(v) for k, v in counters.collectives.items()}
    rep = RooflineReport(
        arch=arch_name, shape=shape_name,
        mesh="pod2x16x16" if multi_pod else "pod16x16",
        chips=chips,
        flops_per_device=float(counters.flops),
        hbm_bytes_per_device=float(counters.bytes) + plan.opt_traffic,
        collective_bytes_per_device=float(counters.collective_bytes),
        collectives=coll,
        model_flops_global=model_flops(plan.n_params, plan.tokens,
                                       shape.kind, plan.active),
    )
    result = {
        "arch": arch_name, "shape": shape_name, "mesh": rep.mesh,
        "status": "ok", "chips": chips, "trace_s": trace_s,
        "n_params": plan.n_params, "active_params": plan.active,
        "state_bytes_per_device": plan.state_bytes,
        "state_share_of_hbm": plan.state_bytes / HW["hbm_bytes"],
        "rt": {"preset": rt.dtype_preset, "accum": rt.accum_steps,
               "seq_shard_acts": rt.seq_shard_acts,
               "axis_profile": rt.axis_profile, "profile": profile},
        "model_flops": rep.model_flops_global,
        "counted_flops_per_device": rep.flops_per_device,
        "counted_bytes_per_device": rep.hbm_bytes_per_device,
        "collective_bytes_per_device": rep.collective_bytes_per_device,
        "collectives": coll,
        "roofline": rep.row(),
    }
    if verbose:
        print(json.dumps(result, indent=1)[:2000])
        print(f"[{arch_name} x {shape_name} x {rep.mesh}] OK  "
              f"trace={trace_s:.1f}s  state/dev="
              f"{plan.state_bytes / 2**30:.2f}GiB  dominant={rep.dominant}  "
              f"terms=({rep.compute_s * 1e3:.1f}, {rep.memory_s * 1e3:.1f}, "
              f"{rep.collective_s * 1e3:.1f})ms  mfu_bound={rep.mfu:.3f}")
    return result


class _CellBoundary:
    """Records a cell's exception (with its traceback on stderr) and
    lets the sweep go on to the next cell: the reporting boundary of
    ``main``, where the reference catches ``Exception``."""

    def __enter__(self) -> "_CellBoundary":
        self.error = None
        return self

    def __exit__(self, typ, exc, tb) -> bool:
        if not isinstance(exc, Exception):
            return False
        traceback.print_exception(typ, exc, tb)
        self.error = exc
        return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "opt"])
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                with _CellBoundary() as cell:
                    res = run_cell(a, s, mp, profile=args.profile)
                if cell.error is not None:
                    res = {"arch": a, "shape": s,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": str(cell.error)[:500]}
                    failures += 1
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(res) + "\n")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
