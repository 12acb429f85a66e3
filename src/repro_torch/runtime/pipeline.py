"""GPipe-style pipeline parallelism over a mesh axis, as
``src/repro/runtime/pipeline.py``.

The layer stack is split into P contiguous stages; each rank along the
pipeline axis holds one stage's parameters.  Microbatches stream through
with the classic (M + P - 1)-tick schedule; boundary activations move to
the next stage with ``dist.batch_isend_irecv`` over the axis' process
group (the reference's ``ppermute`` inside ``shard_map``).  Intended for
the "pod" axis of the production mesh: cross-pod links are the slow
ones, and the pipeline moves only boundary activations across them.

As in the reference, every stage runs its layers at every tick (a stage
that holds no microbatch yet runs on zeros), only the last stage's
outputs are kept, and they reach every rank by a sum over the axis of
the outputs masked to the last stage (the reference's masked ``psum``).
At P = 1 the shift is the identity: NCCL sends to no rank of its own.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.common import named_leaves, tree_map


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """Reshape [L, ...] stacked layer params to [P, L/P, ...]."""

    def resh(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not divide into {n_stages} "
                             "stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])

    return tree_map(resh, stacked_params)


def _stage_params(staged: Any) -> Any:
    """This rank's [L/P, ...] params: the local shard of each DTensor
    placed ``Shard(0)`` on the pipeline axis."""
    return tree_map(lambda t: t.to_local()[0], staged)


def pipeline_apply(
    layer_fn: "Callable[[Any, torch.Tensor], torch.Tensor]",
    staged_params: Any,            # [P, L/P, ...] DTensors, Shard(0)
    microbatches: torch.Tensor,    # [M, mb, ...], the same on every rank
    mesh: DeviceMesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run the staged stack over microbatches; returns [M, mb, ...] on
    every rank of the axis."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    m = microbatches.shape[0]
    params = _stage_params(staged_params)
    n_local = next(named_leaves(params))[1].shape[0]
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    h = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(m + n_stages - 1):
        # the first stage ingests microbatch t (the last one past the end)
        if stage == 0:
            h = microbatches[min(t, m - 1)]
        for l in range(n_local):
            h = layer_fn(tree_map(lambda x: x[l], params), h)
        # the last stage retires microbatch t - P + 1
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outs[out_idx] = h
        if n_stages > 1:
            h = h.contiguous()
            got = torch.empty_like(h)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, h, nxt, group),
                    dist.P2POp(dist.irecv, got, prv, group)]):
                w.wait()
            h = got
    if stage != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs

