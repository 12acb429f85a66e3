"""Ops that the models and the kernel wrappers run the same way on a
plain tensor and on a DTensor (a sharded program, ``launch/sharding.py``).

On a plain tensor each is the one PyTorch op it names, so a model run
without a mesh runs what it ran before the port had a mesh.  On a
DTensor each gets round a gap in DTensor's sharding rules (found on
torch 2.11): it runs the op on each rank's own shard through
``local_map``, or first gathers a shard DTensor cannot split as GSPMD
would.  This module is the one place that knows those gaps: the models
and ``kernels/ops.py`` call it and hold no DTensor branch of their own.
It imports torch only, so it sits below both.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (``Partial``) reduced to ``Replicate``
    first, so that the redistribute after it never runs Shard -> Partial
    in the backward (some DTensor versions lack that)."""
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def no_dtensor(what: str, *tensors: torch.Tensor) -> None:
    """Raise if a DTensor is among ``tensors``: a kernel reads raw
    pointers of one device's tensors."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what} takes no DTensor: its kernel reads raw "
                        "pointers of one device's tensors; pass local "
                        "tensors (DTensor.to_local())")


def _gathered_along(t: DTensor, dim: int, parts: int) -> DTensor:
    """``t`` with ``dim`` gathered if the mesh dims that shard it do not
    divide ``parts``."""
    split = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
    if split and parts % math.prod(t.device_mesh.size(i) for i in split):
        t = t.redistribute(t.device_mesh, [
            Replicate() if i in split else p
            for i, p in enumerate(t.placements)])
    return t


def split_dim(t: torch.Tensor, dim: int, *shape: int) -> torch.Tensor:
    """``t.unflatten(dim, shape)`` (a projection's features split into
    heads, heads into groups).  A DTensor sharded along ``dim`` over more
    ranks than ``shape[0]`` divides into (8 kv heads on 16 model ranks)
    is first gathered along it: GSPMD reshards such a split by itself,
    DTensor refuses the view."""
    if isinstance(t, DTensor):
        dim %= t.ndim
        t = _gathered_along(t, dim, shape[0])
    return t.unflatten(dim, shape)


class _MergeHeads(torch.autograd.Function):
    """[..., H, D] -> [..., H * D] whose backward splits the gradient
    with ``split_dim``: the gradient may come back sharded along the
    merged dim over more ranks than H divides into."""

    @staticmethod
    def forward(ctx, t):
        ctx.heads = tuple(t.shape[-2:])
        return t.flatten(-2)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, -1, *ctx.heads)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``t.flatten(-2)``: heads [..., H, D] merged into features.  A
    DTensor's heads sharded unevenly (24 heads on 16 ranks) are gathered
    first: DTensor merges only even shards."""
    if not isinstance(t, DTensor):
        return t.flatten(-2)
    return _MergeHeads.apply(_gathered_along(t, t.ndim - 2, t.shape[-2]))


def cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(t, dim)``; a DTensor runs it on each rank's shard
    (``dim`` first gathered if it is sharded), since DTensor lacks a
    sharding rule for the ``flip`` in cumsum's backward on some
    versions."""
    if not isinstance(t, DTensor):
        return torch.cumsum(t, dim)
    dim %= t.ndim
    place = tuple(Replicate() if p.is_shard(dim) else p
                  for p in t.placements)
    return local_map(partial(torch.cumsum, dim=dim),
                     out_placements=list(place), in_placements=(place,),
                     redistribute_inputs=True)(t)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(*ts: torch.Tensor) -> "tuple[torch.Tensor, ...]":
    """``ts`` unchanged, their gradients made contiguous on the way back.
    For the local tensors inside a ``local_map``: a gradient that leaves
    the map strided (the transpose of a head split) reaches DTensor's
    view rules, which refuse a view of it."""
    return tuple(_ContiguousGrad.apply(t) for t in ts)


def _grad_plans(in_plans, out_plan) -> tuple:
    """A local map's gradient placements for its inputs: an input that
    is replicated over a mesh dim that splits the work (the output is
    sharded there) gets, on each rank, one part of its gradient, a
    ``Partial`` sum over that dim.  Left to its default, DTensor would
    take each rank's part for the whole gradient."""
    return tuple(tuple(Partial() if p.is_replicate() and o.is_shard() else p
                       for p, o in zip(plan, out_plan))
                 for plan in in_plans)


def per_head(fn, lead: torch.Tensor, *args, outputs: int = 1):
    """``fn(*tensors)`` for ``args`` of (tensor, (batch dim, head dim)),
    either dim None where the tensor has none; each of ``fn``'s
    ``outputs`` is laid out as ``lead``, [B, H, ...].  A DTensor ``lead``
    runs ``fn`` through ``local_map`` on each rank's batch rows and, where
    every head dim divides over the mesh dim, its heads; a tensor
    without that dim is replicated over the mesh dim (its gradient there
    a sum over the ranks' parts), any other placement (a
    sequence-sharded cache among them) is gathered first, and a plain
    tensor counts as replicated.  The gradients leave the map contiguous.
    DTensor's own rules for batched products refuse a head axis sharded
    behind the batch axis on some versions, and a kernel takes no
    DTensor."""
    ts = [t for t, _ in args]
    if not isinstance(lead, DTensor):
        return fn(*ts)
    mesh = lead.device_mesh
    plans = [[] for _ in args]
    out, heads = [], 1
    for i, p in enumerate(lead.placements):
        n = mesh.size(i)
        dim = 0 if p.is_shard(0) else 1 if p.is_shard(1) and all(
            t.shape[d[1]] % (heads * n) == 0 for t, d in args
            if d[1] is not None) else None
        heads *= n if dim == 1 else 1
        out.append(Replicate() if dim is None else Shard(dim))
        for plan, (_, dims) in zip(plans, args):
            d = None if dim is None else dims[dim]
            plan.append(Replicate() if d is None else Shard(d))
    ts = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in ts]
    return local_map(lambda *local: fn(*_contiguous_grads(*local)),
                     out_placements=out if outputs == 1 else
                     (tuple(out),) * outputs,
                     in_placements=tuple(tuple(p) for p in plans),
                     in_grad_placements=_grad_plans(plans, out),
                     redistribute_inputs=True)(*ts)


def expert_map(fn, xe: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
    """``fn(xe, *ws)`` for the experts' FFN, xe [B, E, C, D] and weights
    [E, ...].  DTensor inputs run it through ``local_map``,
    expert-parallel where the weights' expert axis is sharded (a rank
    runs its own experts on every row of its batch shard), data-parallel
    over the batch's shards (the weights' other shards gathered first):
    DTensor's views of the einsums' strided gradients fail on some
    versions, and a local call has none."""
    if not isinstance(xe, DTensor):
        return fn(xe, *ws)
    x_plan, w_plan = [], []
    for px, pw in zip(xe.placements, ws[0].placements):
        if pw.is_shard(0):
            x_plan.append(Shard(1))
            w_plan.append(Shard(0))
        else:
            x_plan.append(Shard(0) if px.is_shard(0) else Replicate())
            w_plan.append(Replicate())
    plans = (tuple(x_plan),) + (tuple(w_plan),) * len(ws)
    return local_map(lambda *ts: fn(*_contiguous_grads(*ts)),
                     out_placements=x_plan, in_placements=plans,
                     in_grad_placements=_grad_plans(plans, x_plan),
                     redistribute_inputs=True)(xe, *ws)


def embedding_rows(table: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is looked up vocab-parallel
    (Megatron): each rank looks up the rows of its vocab shard and zeroes
    the rest, and the shards' pending sum is reduced.  The table's
    feature shards and any shard that meets the tokens' batch shards are
    gathered first; its gradient there is a sum over the batch shards.  DTensor's own index and embedding rules fail on a
    batch sharded over several mesh dims, or mask the wrong shape."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    t_plan, k_plan, o_plan = [], [], []
    lo, rows = 0, table.shape[0]
    coord = mesh.get_coordinate()
    for i, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if pt.is_shard(0) and not pk.is_shard():
            rows //= mesh.size(i)
            lo += coord[i] * rows
            t_plan.append(Shard(0))
            k_plan.append(Replicate())
            o_plan.append(Partial())
        else:
            batch = pk if pk.is_shard(0) else Replicate()
            t_plan.append(Replicate())
            k_plan.append(batch)
            o_plan.append(batch)

    def lookup(tbl, tok):
        hit = (tok >= lo) & (tok < lo + rows)
        out = F.embedding(torch.where(hit, tok - lo, 0), tbl)
        return torch.where(hit[..., None], out, 0.0)

    plans = (tuple(t_plan), tuple(k_plan))
    out = local_map(lookup, out_placements=o_plan, in_placements=plans,
                    in_grad_placements=_grad_plans(plans, o_plan),
                    redistribute_inputs=True)(table, tokens)
    return settle(out)


def put(cache: dict, name: str, index: tuple, rows: torch.Tensor) -> None:
    """``cache[name][index] = rows``, in place.  Sharded rows (a
    DTensor) first turn the cache leaf into a DTensor laid out as they
    are, its leading layer axis unsharded, so that the write stays on
    each rank's own shard."""
    if isinstance(rows, DTensor) and not isinstance(cache[name], DTensor):
        rows = rows.redistribute(rows.device_mesh, [
            p if isinstance(p, Shard) else Replicate()
            for p in rows.placements])
        cache[name] = distribute_tensor(
            cache[name], rows.device_mesh,
            [Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
             for p in rows.placements], src_data_rank=None)
    cache[name][index] = rows


def write_at(cache: torch.Tensor, row: torch.Tensor, at: torch.Tensor,
             dim: int) -> None:
    """``cache.index_copy_(dim, at, row)``, ``at`` one index.  A DTensor
    cache may be sharded along ``dim`` (flash-decode over a sharded
    length), where DTensor has no in-place index write: a select over
    the axis, which each rank runs on its own shard."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(dim, at, row.to(cache.dtype))
        return
    shape = [1] * cache.ndim
    shape[dim] = cache.shape[dim]
    hit = (torch.arange(cache.shape[dim], device=cache.device) == at
           ).reshape(shape)
    cache.copy_(torch.where(hit, row.to(cache.dtype), cache))


def zero_pad(x: torch.Tensor, dim: int, before: int, after: int
             ) -> torch.Tensor:
    """``x`` with ``before`` and ``after`` zeros along ``dim`` (``F.pad``).
    A DTensor pads by a ``cat`` with zeros, which DTensor shards as it
    shards ``x``, where its pad rule fails on some versions."""
    dim %= x.ndim
    if not isinstance(x, DTensor):
        return F.pad(x, (0, 0) * (x.ndim - 1 - dim) + (before, after))

    def zeros(n):
        return x.new_zeros((*x.shape[:dim], n, *x.shape[dim + 1:]))
    return torch.cat([zeros(before), x, zeros(after)], dim=dim)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per row: ``torch.gather(x, -1, idx[..., None])``
    without its last axis (the gold logit).  A DTensor takes it by a
    masked reduce over the last axis, as the reference does under GSPMD:
    a gather over a vocab-sharded axis would gather the whole of ``x``."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    vocab = torch.arange(x.shape[-1], device=x.device)
    return torch.sum(torch.where(vocab == idx[..., None], x, 0.0), dim=-1)


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, dim=-1)``, the first maximal index.  A DTensor
    takes it as a masked reduce over the last axis, which a vocab-sharded
    DTensor runs by reductions across its shards (DTensor's own argmax
    fails on a sharded axis when the batch is a single row)."""
    if not isinstance(x, DTensor):
        return torch.argmax(x, dim=-1)
    top = torch.amax(x, dim=-1, keepdim=True)
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.amin(torch.where(x == top, idx, x.shape[-1]), dim=-1)


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient ``g`` in its param ``p``'s placements (its
    data-parallel sums reduced), as the reference's gradients take the
    params' shardings; anything else as it is."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g
