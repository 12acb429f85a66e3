"""AdamW with global-norm clipping, decoupled weight decay and the
policy's moment dtype, as ``src/repro/optim/adamw.py`` computes it.

Functional: ``init -> state``, ``update(grads, state, params, cfg,
policy) -> (new_params, new_state, stats)``.  The state mirrors the
params dict: ``{"m", "v"}`` in ``policy.moments`` and ``"step"``, an
int32 scalar tensor.  ``update`` returns new tensors and touches no
input.  Not ``torch.optim.AdamW``: the decay rule here is the
reference's (``_decayable(path) and p.ndim >= 2``, the path being the
dict keys), so a stacked ``conv_b`` [L, C] is decayed and a stacked
norm ``scale`` is not.  The schedule, the clip scale and the bias
corrections are f32 scalars on the params' device, as JAX computes
them.
"""
from __future__ import annotations

import dataclasses
import math
import torch

from repro_torch.models.common import (DTypePolicy, Params, named_leaves,
                                       tree_map)

NO_DECAY = ("scale", "bias", "A_log", "D", "dt_bias")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to
    ``min_lr_frac`` of it; ``step`` an integer tensor, the result f32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params: Params, policy: DTypePolicy | None = None) -> Params:
    policy = policy or DTypePolicy.standard()
    device = next(t for _, t in named_leaves(params)).device
    zeros = lambda p: torch.zeros_like(p, dtype=policy.moments)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the f32 sum of squares, summed leaf by leaf in JAX's
    leaf order."""
    total = 0
    for _, g in named_leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _decayable(path: tuple) -> bool:
    # no decay on norms / biases / 1-D tensors (rank checked at the call)
    return not any(n in NO_DECAY for n in path)


@torch.no_grad()
def update(grads: Params, state: Params, params: Params,
           cfg: AdamWConfig, policy: DTypePolicy | None = None
           ) -> "tuple[Params, Params, dict]":
    policy = policy or DTypePolicy.standard()
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(path, p, g, m, v):
        g32 = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if _decayable(path) and p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m32.to(policy.moments), v32.to(policy.moments)

    def walk(p, g, m, v, path):
        if isinstance(p, dict):
            outs = {k: walk(p[k], g[k], m[k], v[k], path + (k,)) for k in p}
            return tuple({k: o[i] for k, o in outs.items()}
                         for i in range(3))
        return upd(path, p, g, m, v)

    new_p, new_m, new_v = walk(params, grads, state["m"], state["v"], ())
    return new_p, {"m": new_m, "v": new_v, "step": step}, {
        "lr": lr, "grad_norm": gnorm}
