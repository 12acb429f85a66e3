"""Sharding rules engine, as ``src/repro/launch/sharding.py``, over
DTensor in place of GSPMD.

Maps every parameter / activation / cache tensor to a ``PartitionSpec``
over the production mesh axes ("pod", "data", "model"):

  * TP (Megatron): attention heads, FFN hidden, experts, vocab -> "model"
  * FSDP/ZeRO: the other matrix dim of every weight        -> "data"
  * DP: batch -> ("pod", "data")   (pod is pure DP; grads all-reduce)
  * SP (optional, rt.seq_shard_acts): boundary activations' sequence
    axis -> "model" (Megatron sequence parallelism)

Two layers.  The rules (``param_pspecs``, ``cache_pspecs``,
``input_pspecs``, ``batch_axes_for``) are the reference's, spec for spec;
they read only ``mesh.shape`` as a mapping (``mesh.axis_sizes`` gives one
for a ``DeviceMesh``), so a plain dict of axis sizes serves as well.
The placements (``to_placements``, ``to_named``, ``place``) turn a spec
into DTensor placements: for each mesh dim, ``Shard(d)`` where that
dim's axis name stands at tensor dim ``d``, else ``Replicate()``.  A
tuple of axes at one tensor dim (("pod", "data"), or the dp profile's
("data", "model")) shards that dim over several mesh dims; DTensor
splits those in mesh-dim order and JAX in tuple order, so a tuple must
list its axes in mesh order, and ``to_placements`` raises otherwise.

Model code calls :func:`constrain` with a *role* string; outside an
``activation_sharding`` context it is the identity, so the models stay
mesh-agnostic and give bit-equal results without one.  Inside, it
redistributes a DTensor to the role's spec (a plain tensor passes
through), and the context also enters DTensor's
``implicit_replication``: the models make plain tensors inside
(positions, masks, RoPE tables, a scan's zero state), which then count
as replicated on the mesh, as a constant is under GSPMD.
"""
from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import (DeviceMesh, DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.dtensor_ops import settle
from repro_torch.launch.mesh import axis_sizes


class PartitionSpec(tuple):
    """Per tensor dim: None, an axis name, or a tuple of axis names (the
    reference's ``jax.sharding.PartitionSpec``, as a plain tuple).  A
    tuple of one axis is that axis, as JAX normalises it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and
                                     len(a) == 1 else a for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# ----------------------------------------------------------------------
# Activation-sharding context
# ----------------------------------------------------------------------
_SHARDER: "contextvars.ContextVar[Callable | None]" = contextvars.ContextVar(
    "activation_sharder", default=None)
_TP_HINT: "contextvars.ContextVar[int]" = contextvars.ContextVar(
    "tp_hint", default=1)


def tp_hint() -> int:
    """Tensor-parallel degree the launcher is running for (1 = none).
    Models use it to replicate GQA kv heads up to a multiple of TP so
    the head axis shards exactly (kv replication, standard Megatron)."""
    return _TP_HINT.get()


def constrain(x: torch.Tensor, role: str, rt: Any = None) -> torch.Tensor:
    fn = _SHARDER.get()
    if fn is None:
        return x
    return fn(x, role, rt)


class activation_sharding:
    """``with activation_sharding(mesh, batch_axes, seq_shard_acts,
    axis_profile):`` installs the launcher's activation sharder and TP
    hint, and enters ``implicit_replication``."""

    def __init__(self, mesh: DeviceMesh, batch_axes: "tuple[str, ...]",
                 seq_shard_acts: bool = False, axis_profile: str = "tp"
                 ) -> None:
        sizes = axis_sizes(mesh)
        vocab_axis = "model" if axis_profile == "tp" else None

        def sharder(x: torch.Tensor, role: str, rt: Any = None
                    ) -> torch.Tensor:
            if x.ndim < 2 or not isinstance(x, DTensor):
                return x
            bspec = batch_axes if batch_axes else None
            seq = None
            if role == "hidden":
                if (seq_shard_acts and x.ndim == 3
                        and x.shape[1] % sizes["model"] == 0
                        and x.shape[1] > 1):
                    seq = "model"
                spec = P(bspec, seq, *([None] * (x.ndim - 2)))
            elif role == "tp_in":
                # explicit SP -> TP transition: activations enter the
                # tensor-parallel matmuls seq-unsharded, so the weights'
                # "model" sharding survives
                spec = P(bspec, *([None] * (x.ndim - 1)))
            elif role == "logits":
                spec = P(bspec, None, vocab_axis)
            else:
                return x
            want = to_placements(spec, x.device_mesh)
            if tuple(x.placements) == want:
                return x
            return settle(x).redistribute(x.device_mesh, want)

        self._sharder = sharder
        self._tp = sizes.get("model", 1) if axis_profile == "tp" else 1
        self._replication = implicit_replication()

    def __enter__(self) -> "activation_sharding":
        self._tokens = (_SHARDER.set(self._sharder), _TP_HINT.set(self._tp))
        self._replication.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._replication.__exit__(*exc)
        _SHARDER.reset(self._tokens[0])
        _TP_HINT.reset(self._tokens[1])


# ----------------------------------------------------------------------
# Batch axes
# ----------------------------------------------------------------------
def batch_axes_for(mesh, global_batch: int,
                   include_model: bool = False) -> "tuple[str, ...]":
    """Largest prefix of (pod, data[, model]) whose product divides the
    batch.  include_model=True is the pure-DP profile (no TP): the model
    axis becomes extra data parallelism."""
    sizes = axis_sizes(mesh)
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    axes: "list[str]" = []
    prod = 1
    for name in names:
        if name in sizes:
            n = sizes[name]
            if global_batch % (prod * n) == 0:
                axes.append(name)
                prod *= n
    # prefer ("data",) alone if pod doesn't fit but data does
    if not axes and "data" in sizes and global_batch % sizes["data"] == 0:
        axes = ["data"]
    return tuple(axes)


# ----------------------------------------------------------------------
# Parameter rules: leaf-name -> PartitionSpec of the *unstacked* tensor.
# A leading layer-stack axis (rank == len(spec)+1) gets None prepended.
# ----------------------------------------------------------------------
_PARAM_RULES: "dict[str, P]" = {
    # embeddings / head
    "embed": P("model", "data"),
    "head": P("data", "model"),
    "patch_proj": P(None, "data"),
    # attention (gqa)
    "wq": P("data", "model"),
    "wk": P("data", "model"),
    "wv": P("data", "model"),
    "wo": P("model", "data"),
    # attention (mla)
    "wq_a": P("data", None),
    "wq_b": P(None, "model"),
    "wkv_a": P("data", None),
    "wk_b": P(None, "model"),
    "wv_b": P(None, "model"),
    # mlp
    "w_up": P("data", "model"),
    "w_gate": P("data", "model"),
    "w_down": P("model", "data"),
    # moe (expert-stacked: E D F / E F D)
    "router": P("data", None),
    # mamba2
    "in_proj": P("data", "model"),
    "out_proj": P("model", "data"),
    "conv_w": P(None, "model"),
    # hybrid shared block
    "w_cat": P("data", "model"),
}

# expert-stacked MoE weights carry an [E, ...] axis -> experts on "model"
_MOE_EXPERT_RULES: "dict[str, P]" = {
    "w_up": P("model", "data", None),
    "w_gate": P("model", "data", None),
    "w_down": P("model", None, "data"),
}


def _fit_spec(spec: P, shape: "tuple[int, ...]", mesh) -> P:
    """Drop axes whose size does not divide the dimension (e.g. mamba
    in_proj's 2*d_inner + 2*state + H tail dim)."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        prod = 1
        for a in axes:
            prod *= sizes.get(a, 1)
        out.append(axis if dim % prod == 0 else None)
    return P(*out)


def _to_dp_profile(spec: P) -> P:
    """Pure-FSDP profile: no tensor parallelism -- the 'data' dim of each
    weight is sharded over BOTH mesh axes, 'model' dims replicate."""
    out = []
    for axis in spec:
        if axis == "data":
            out.append(("data", "model"))
        elif axis == "model":
            out.append(None)
        else:
            out.append(axis)
    return P(*out)


def _spec_for_path(names: "tuple[str, ...]", leaf: Any, mesh,
                   axis_profile: str) -> P:
    name = names[-1]
    stacked = names[0] in ("blocks", "enc_blocks")
    in_moe = "moe" in names
    if in_moe and name in _MOE_EXPERT_RULES:
        spec = _MOE_EXPERT_RULES[name]
    elif name in _PARAM_RULES:
        spec = _PARAM_RULES[name]
    else:
        spec = None  # norms, biases, A_log, scales... -> replicated
    rank = len(leaf.shape)
    if spec is None:
        return P(*([None] * rank))
    if axis_profile == "dp" and not in_moe:
        spec = _to_dp_profile(spec)
    if stacked and rank == len(spec) + 1:
        spec = P(None, *spec)
    elif rank != len(spec):
        # rank mismatch (e.g. tiny test config) -> replicate
        return P(*([None] * rank))
    return _fit_spec(spec, tuple(leaf.shape), mesh)


def _map_with_path(fn, tree: dict, path: tuple = ()) -> dict:
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def param_pspecs(params_shape: dict, mesh=None,
                 axis_profile: str = "tp") -> dict:
    """PartitionSpec tree matching a params (shape) tree.  With a mesh,
    axes that don't divide the dim are dropped (replicated)."""
    return _map_with_path(
        lambda p, l: _spec_for_path(p, l, mesh, axis_profile), params_shape)


def _prod(sizes: "dict[str, int]", axes: "tuple[str, ...]") -> int:
    out = 1
    for a in axes:
        out *= sizes[a]
    return max(out, 1)


def cache_pspecs(cache_shape: dict, mesh, global_batch: int,
                 kv_shard: str = "auto") -> dict:
    """Decode-cache specs.  KV caches [L, B, Hkv, S, D]: batch on
    (pod,data) when divisible; heads on "model" when divisible, else the
    sequence axis (flash-decode over sharded KV length)."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes_for(sizes, global_batch)
    bspec = baxes if baxes else None
    m = sizes.get("model", 1)
    nb = _prod(sizes, baxes)

    def spec(path, leaf) -> P:
        name = path[-1]
        rank = len(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v", "shared_k", "shared_v"):
            L, B, H, S, D = leaf.shape
            if kv_shard == "heads" or (kv_shard == "auto" and H % m == 0):
                return P(None, bspec if B % nb == 0 else None,
                         "model" if H % m == 0 else None, None, None)
            return P(None, bspec if B % nb == 0 else None,
                     None, "model" if S % m == 0 else None, None)
        if name in ("c_kv", "k_rope"):
            L, B, S, D = leaf.shape
            return P(None, bspec if B % nb == 0 else None,
                     "model" if S % m == 0 else None, None)
        if name == "ssm_h":
            L, B, H, Pd, N = leaf.shape
            return P(None, bspec if B % nb == 0 else None,
                     "model" if H % m == 0 else None, None, None)
        if name == "ssm_conv":
            L, B, W, C = leaf.shape
            return P(None, bspec if B % nb == 0 else None,
                     None, "model" if C % m == 0 else None)
        return P(*([None] * rank))

    return _map_with_path(spec, cache_shape)


def input_pspecs(batch_shape: dict, mesh, global_batch: int,
                 batch_axes: "tuple[str, ...] | None" = None) -> dict:
    sizes = axis_sizes(mesh)
    baxes = batch_axes_for(sizes, global_batch) if batch_axes is None \
        else batch_axes
    bspec = baxes if baxes else None

    def spec(path, leaf) -> P:
        rank = len(leaf.shape)
        if rank == 0:
            return P()
        if leaf.shape[0] == global_batch and \
                global_batch % _prod(sizes, baxes) == 0:
            return P(bspec, *([None] * (rank - 1)))
        return P(*([None] * rank))

    return _map_with_path(spec, batch_shape)


# ----------------------------------------------------------------------
# Placements
# ----------------------------------------------------------------------
def to_placements(spec: P, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where its axis name stands at tensor dim ``d``, else
    ``Replicate()``.  Raises on an axis the mesh lacks, an axis used
    twice, or a tuple of axes out of mesh order."""
    names = tuple(mesh.mesh_dim_names)
    at: "dict[str, int]" = {}
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        order = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh's {names}")
            if a in at:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            at[a] = d
            order.append(names.index(a))
        if order != sorted(order):
            raise ValueError(
                f"spec {spec}: the axes {axes} at dim {d} are not in mesh "
                f"order {names}; DTensor would split them in another order "
                "than JAX")
    return tuple(Shard(at[n]) if n in at else Replicate() for n in names)


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """A mesh and one tensor's placements on it (the counterpart of
    ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    placements: tuple


def to_named(tree_spec: Any, mesh: DeviceMesh) -> Any:
    """``NamedPlacement`` of every spec in a (nested dict) tree."""
    if isinstance(tree_spec, PartitionSpec):
        return NamedPlacement(mesh, to_placements(tree_spec, mesh))
    return {k: to_named(v, mesh) for k, v in tree_spec.items()}


def place(tree: Any, tree_spec: Any, mesh: DeviceMesh) -> Any:
    """Each tensor of ``tree`` as a DTensor placed by its spec.  Every
    rank must hold the same full tensors (made from one seed): each keeps
    its own shard of them, and nothing is sent."""
    if isinstance(tree_spec, PartitionSpec):
        return distribute_tensor(tree, mesh, to_placements(tree_spec, mesh),
                                 src_data_rank=None)
    return {k: place(tree[k], v, mesh) for k, v in tree_spec.items()}
