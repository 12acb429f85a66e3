"""Shared model primitives: dtype policy, initializers, RMS norm.

Models are plain functions over a params dict that mirrors the JAX
pytree key for key (``src/repro/models/common.py``).  Layer stacks are
stacked on a leading [L, ...] axis, as in the JAX package, and consumed
by a Python loop that indexes layer ``l``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch
import torch.nn.functional as F

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: parameter, compute and optimizer-moment
    dtypes.  The ``lean`` presets drop the f32 moments (and, ultra lean,
    the f32 parameters) for the largest archs."""
    params: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16
    moments: torch.dtype = torch.float32

    @staticmethod
    def standard() -> "DTypePolicy":
        """f32 parameters, bf16 compute, f32 moments."""
        return DTypePolicy(torch.float32, torch.bfloat16, torch.float32)

    @staticmethod
    def lean() -> "DTypePolicy":
        return DTypePolicy(torch.float32, torch.bfloat16, torch.bfloat16)

    @staticmethod
    def ultra_lean() -> "DTypePolicy":
        """bf16 params + bf16 moments: 6 bytes/param optimizer footprint."""
        return DTypePolicy(torch.bfloat16, torch.bfloat16, torch.bfloat16)


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in f32 (biased variance), cast back to x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_init(d: int, device: torch.device) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: "torch.device | None" = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Rotates
    the two halves of D (not interleaved pairs), in f32, and casts back
    to x's dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)         # [D/2]
    ang = positions[..., None].float() * freqs           # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                   # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Activations
# ----------------------------------------------------------------------
def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Nemotron-4's squared ReLU."""
    r = F.relu(x)
    return r * r


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: "dict[str, Callable[[torch.Tensor], torch.Tensor]]" = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "relu2": squared_relu,
    "relu": F.relu,
}


def stack_layer_init(layer_init: "Callable[[torch.Generator], Params]",
                     gen: torch.Generator, n_layers: int) -> Params:
    """Initialize L layers from ``gen`` in turn, stacked on axis 0 (the
    layout of the JAX package's ``vmap``-ed init)."""
    return _stack([layer_init(gen) for _ in range(n_layers)])


def _stack(trees: "list[Params]") -> Params:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def tree_map(fn, tree: Params) -> Params:
    """``fn`` on every tensor of a nested dict, keys kept."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def named_leaves(tree: Params, prefix: tuple = ()
                 ) -> "Iterator[tuple[tuple, torch.Tensor]]":
    """(path of dict keys, tensor) for every leaf, keys sorted at every
    level: the leaf order of JAX's ``tree_leaves`` over a dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from named_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def count_params(params: Params) -> int:
    total = 0
    for v in params.values():
        total += count_params(v) if isinstance(v, dict) else v.numel()
    return total
