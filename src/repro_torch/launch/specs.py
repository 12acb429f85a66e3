"""Abstract input stand-ins for every (arch x shape) cell, as
``src/repro/launch/specs.py``: tensors on the ``meta`` device, which
carry a shape and a dtype and allocate nothing (the counterpart of
``jax.ShapeDtypeStruct``).

``abstract_params`` runs ``init_model`` under a ``FakeTensorMode`` and
keeps each leaf's shape and dtype as a meta tensor: the initialisers
draw from a ``torch.Generator``, which cannot live on the meta device,
and under the fake mode they draw nothing.  The fake mode costs about a
millisecond an initialiser (15 s for moonshot-v1-16b-a3b's 9216
expert matrices), so the shapes are kept per arch for the life of the
process, and each policy's params dtype is applied to them as
``init_model`` applies it (to the f32 leaves).  ``launch/dryrun.py``
runs a step on the stand-ins themselves, placed as DTensors.

Also resolves the per-cell RuntimeConfig (dtype preset, accumulation,
activation sequence-sharding, kv sharding): the launcher-side knobs
that make the big cells fit a device.
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, RuntimeConfig, ShapeConfig
from repro_torch.models.common import DTypePolicy, Params, tree_map
from repro_torch.models.lm import init_model, make_cache

I32 = torch.int32
BF16 = torch.bfloat16


def resolve_runtime(arch: ArchConfig, shape: ShapeConfig,
                    n_data_shards: int = 16,
                    profile: str = "baseline") -> RuntimeConfig:
    """Per-cell runtime knobs, the reference's rules.

    profile="baseline": uniform Megatron TP-16 + blanket accumulation
    rules.  profile="opt": accumulation chosen by activation-budget math
    (in-scan collective traffic scales linearly with accum, so accum is
    minimized subject to device memory), and small archs trade TP for
    pure FSDP over all devices (their TP reduction cost exceeds their
    compute).
    """
    n = arch.param_count_estimate()
    big = n >= 60e9
    huge = n >= 200e9
    accum = 1
    if shape.kind == "train":
        # n_data_shards should be the product of ALL batch axes (incl. pod)
        per_dev_seqs = max(shape.global_batch // n_data_shards, 1)
        if profile == "opt":
            # boundary activations (post-SP) must fit ~6 GB:
            # act_bytes = L * S * d_model * 2 / TP16 per sequence
            act_per_seq = arch.n_layers * shape.seq_len * arch.d_model * 2 / 16
            budget = 6e9
            need = act_per_seq * per_dev_seqs / budget
            accum = 1
            while accum < per_dev_seqs and need > accum:
                accum *= 2
        else:
            if huge:
                accum = per_dev_seqs
            elif big:
                accum = max(per_dev_seqs // 2, 1)
            elif arch.d_model >= 2048:
                accum = max(per_dev_seqs // 8, 1)
    preset = "standard"
    if big:
        preset = "lean"
    if huge:
        preset = "ultra_lean" if shape.kind != "train" else "lean"
    axis_profile = "tp"
    # dp profile: small archs trade TP for pure FSDP; _fit_spec degrades
    # weight sharding gracefully when dims don't divide 256
    if profile == "opt" and shape.kind == "train" and n < 8e9:
        axis_profile = "dp"
    return RuntimeConfig(
        dtype_preset=preset,
        accum_steps=accum,
        seq_shard_acts=(arch.d_model >= 6144 or shape.seq_len >= 32768)
        and axis_profile == "tp",
        kv_shard="auto",
        mla_absorb=profile == "opt",
        remat="full" if shape.kind == "train" else "none",
        axis_profile=axis_profile,
    )


def policy_for(rt: RuntimeConfig) -> DTypePolicy:
    return {"standard": DTypePolicy.standard(),
            "lean": DTypePolicy.lean(),
            "ultra_lean": DTypePolicy.ultra_lean()}[rt.dtype_preset]


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: ArchConfig, shape: ShapeConfig,
                rt: "RuntimeConfig | None" = None) -> dict:
    """Step inputs for the cell.

    train/prefill: token batch (+ modality stubs).  decode: one new
    token per sequence (+ the cache spec via ``cache_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), I32)}
    batch: dict = {}
    if arch.family == "vlm":
        s_text = s - arch.n_patches
        batch["patches"] = _meta((b, arch.n_patches, arch.vit_dim), BF16)
        batch["tokens"] = _meta((b, s_text), I32)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s_text), I32)
        return batch
    if arch.is_encdec:
        batch["frames"] = _meta((b, s, arch.d_model), BF16)
    batch["tokens"] = _meta((b, s), I32)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), I32)
    return batch


def cache_specs(arch: ArchConfig, shape: ShapeConfig,
                rt: "RuntimeConfig | None" = None) -> Params:
    rt = rt or resolve_runtime(arch, shape)
    return make_cache(arch, shape.seq_len, shape.global_batch,
                      policy_for(rt), device="meta")


def abstract_params(arch: ArchConfig,
                    rt: "RuntimeConfig | None" = None) -> Params:
    """The params tree of ``init_model`` as meta tensors."""
    rt = rt or RuntimeConfig()
    dtype = policy_for(rt).params
    return tree_map(lambda t: _meta(t.shape, dtype) if t.dtype ==
                    torch.float32 else t, _abstract_params(arch))


@functools.cache
def _abstract_params(arch: ArchConfig) -> Params:
    """``init_model``'s tree with f32 params, as meta tensors."""
    with FakeTensorMode():
        fake = init_model(0, arch, DTypePolicy.standard(), device="cpu")
    return tree_map(lambda t: _meta(t.shape, t.dtype), fake)


def abstract_opt_state(params_spec: Params,
                       rt: "RuntimeConfig | None" = None) -> Params:
    """AdamW's state for ``params_spec``: m and v in the policy's moment
    dtype, and the int32 step."""
    rt = rt or RuntimeConfig()
    moments = policy_for(rt).moments
    zeros = lambda t: _meta(t.shape, moments)  # noqa: E731
    return {"m": tree_map(zeros, params_spec),
            "v": tree_map(zeros, params_spec),
            "step": _meta((), I32)}
