"""Compressed cross-pod gradient synchronization, as
``src/repro/runtime/compressed_sync.py``, over the "pod" axis' process
group.

Replaces the cross-pod bf16 all-reduce of gradients with:
  quantize int8 (per-tensor scale) -> all-gather over "pod" ->
  dequantize + mean locally.

A ring all-reduce moves ~2(n-1)/n x 2 bytes an element; the int8
all-gather (n-1)/n x 1 byte (+ one f32 scale a tensor): a ~4x cut of the
cross-pod wire traffic, at the cost of n receive buffers and the
quantization error.  Gradients vary across pods and are the same within
one.  A DTensor gradient (sharded over the other mesh axes) sends its
local shard, quantized with the scale of the whole tensor, so the result
is the reference's whatever the sharding.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_map


def _q_int8(g: torch.Tensor, amax: torch.Tensor
            ) -> "tuple[torch.Tensor, torch.Tensor]":
    scale = torch.clamp(amax.float(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def _local(g: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """(this rank's values, |max| over the whole tensor)."""
    if isinstance(g, DTensor):
        return g.to_local(), g.float().abs().amax().full_tensor()
    return g, g.float().abs().amax()


def _rewrap(like: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    if isinstance(like, DTensor):
        return DTensor.from_local(local, like.device_mesh, like.placements,
                                  run_check=False)
    return local


def compressed_pod_mean(grads: Any, mesh: DeviceMesh, axis: str = "pod"
                        ) -> Any:
    """Mean of per-pod gradient trees across the pod axis, int8 wire
    format."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def sync_leaf(g):
        local, amax = _local(g)
        q, s = _q_int8(local, amax)
        q_all = [torch.empty_like(q) for _ in range(n)]
        s_all = [torch.empty_like(s) for _ in range(n)]
        dist.all_gather(q_all, q, group=group)        # int8 on the wire
        dist.all_gather(s_all, s, group=group)        # one f32 a tensor
        deq = torch.stack(q_all).float() * torch.stack(s_all).reshape(
            (n,) + (1,) * local.ndim)
        return _rewrap(g, torch.mean(deq, dim=0).to(local.dtype))

    return tree_map(sync_leaf, grads)


def uncompressed_pod_mean(grads: Any, mesh: DeviceMesh, axis: str = "pod"
                          ) -> Any:
    """Baseline: bf16 sum-mean across pods (what the reference's psum
    does)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def sync_leaf(g):
        local = g.to_local() if isinstance(g, DTensor) else g
        x = local.to(torch.bfloat16, copy=True)
        dist.all_reduce(x, group=group)
        return _rewrap(g, (x / n).to(local.dtype))

    return tree_map(sync_leaf, grads)
