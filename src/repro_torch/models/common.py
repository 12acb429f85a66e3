"""Shared model primitives: dtype policy, initializers, RMS norm.

Models are plain functions over a params dict that mirrors the JAX
pytree key for key (``src/repro/models/common.py``).  Layer stacks are
stacked on a leading [L, ...] axis, as in the JAX package, and consumed
by a Python loop that indexes layer ``l``.  RoPE, ``layer_norm`` and the
activation table wait for the attention slice (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: parameter and compute dtypes."""
    params: torch.dtype
    compute: torch.dtype

    @staticmethod
    def standard() -> "DTypePolicy":
        """f32 parameters, bf16 compute."""
        return DTypePolicy(torch.float32, torch.bfloat16)


def truncated_normal_init(gen: torch.Generator, shape: tuple[int, ...],
                          scale: float, dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Normal truncated to [-2, 2], times ``scale / sqrt(fan_in)`` with
    fan_in = ``shape[0]``, drawn by inverting the normal CDF from
    ``gen``'s uniforms, on ``gen``'s device.  The same distribution as
    the JAX initializer, not its values."""
    stddev = scale / max(1.0, (shape[0] if shape else 1)) ** 0.5
    lo, hi = (math.erf(-2.0 / math.sqrt(2.0)) + 1) / 2, \
        (math.erf(2.0 / math.sqrt(2.0)) + 1) / 2
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
    return (z.clamp(-2.0, 2.0) * stddev).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return truncated_normal_init(gen, (d_in, d_out), 1.0, dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm in f32 with a ``(1 + scale)`` gain, cast back to x's
    dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def norm_init(d: int, device: torch.device) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def tree_map(fn, tree: Params) -> Params:
    """``fn`` on every tensor of a nested dict, keys kept."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def count_params(params: Params) -> int:
    total = 0
    for v in params.values():
        total += count_params(v) if isinstance(v, dict) else v.numel()
    return total
