"""Feed-forward variants: gated (SwiGLU) and plain (squared-ReLU etc.),
as ``src/repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.models.common import ACTIVATIONS, Params, dense_init


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool) -> Params:
    p: Params = {
        "w_up": dense_init(gen, d_model, d_ff),
        "w_down": dense_init(gen, d_ff, d_model),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff)
    return p


def mlp_apply(params: Params, x: torch.Tensor, act: str = "silu"
              ) -> torch.Tensor:
    """Each weight is cast to x's dtype at its product, as in JAX."""
    f = ACTIVATIONS[act]
    up = x @ params["w_up"].to(x.dtype)
    if "w_gate" in params:
        up = f(x @ params["w_gate"].to(x.dtype)) * up
    else:
        up = f(up)
    return up @ params["w_down"].to(x.dtype)
