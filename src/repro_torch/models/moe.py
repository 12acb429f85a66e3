"""Mixture-of-Experts layer with sort-free capacity dispatch, as
``src/repro/models/moe.py``.

Routing: top-k softmax gating.  Dispatch builds, per batch row and
expert, a dense [E, C] table of token slots (C = capacity) from
cumulative positions; tokens over capacity are dropped (the residual
path carries them).  The expert FFNs run as batched products over the
expert axis, and the combine is a scatter-add in f32.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.dtensor_ops import expert_map
from repro_torch.models.common import ACTIVATIONS, Params, dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"
    gated: bool = True


def moe_init(gen: torch.Generator, cfg: MoEConfig) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

    def expert_stack(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out) for _ in range(e)])

    p: Params = {
        "router": dense_init(gen, d, e),
        "w_up": expert_stack(d, f),
        "w_down": expert_stack(f, d),
    }
    if cfg.gated:
        p["w_gate"] = expert_stack(d, f)
    return p


def _top_k(gates: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, the lower index first on ties (a
    stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params: Params, cfg: MoEConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].  Dispatch is per batch row: each row's
    expert queue positions come from a cumsum along its S*K choices.
    The overflow bin ``E*C`` and the pad token ``S`` take writes and are
    sliced away."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * s * k / e), 1)
    dev = x.device

    logits = (x @ params["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)                      # [B, S, E]
    top_g, top_e = _top_k(gates, k)                            # [B, S, K]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert's per-row queue
    flat_e = top_e.reshape(b, s * k)                           # [B, S*K]
    pos = torch.cumsum(F.one_hot(flat_e, e), dim=1) - 1        # row-local
    slot = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = slot < cap

    # row-token ids into the per-row dispatch table [B, E, C]
    dest = torch.where(keep, flat_e * cap + slot, e * cap)     # overflow bin
    token_ids = torch.arange(s, device=dev).repeat_interleave(k)
    table = torch.full((b, e * cap + 1), s, dtype=torch.long, device=dev)
    table = table.scatter(1, dest, token_ids.expand(b, -1))
    table = table[:, :-1].reshape(b, e, cap)                   # [B, E, C]

    # gather expert inputs; pad row s reads zeros
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    rows = torch.arange(b, device=dev)[:, None, None]
    xe = x_pad[rows, table]                                    # [B, E, C, D]

    ws = [params[k].to(x.dtype) for k in ("w_up", "w_gate", "w_down")
          if k in params]
    ye = expert_map(partial(_ffn_local, cfg), xe, *ws)

    # combine back with gate weights (row-local scatter-add)
    gate_tbl = torch.zeros((b, e * cap + 1), dtype=torch.float32,
                           device=dev).scatter(1, dest,
                                               top_g.reshape(b, s * k))
    gate_tbl = gate_tbl[:, :-1].reshape(b, e, cap)
    # per row (a DTensor shards the expert axis, which a flatten across
    # rows would cross): slot (e, c) adds into its token's row
    contrib = (ye * gate_tbl[..., None].to(ye.dtype)).reshape(
        b, e * cap, d).float()
    dest_rows = table.reshape(b, e * cap, 1).expand(-1, -1, d)
    y = torch.zeros((b, s + 1, d), dtype=torch.float32,
                    device=dev).scatter_add(1, dest_rows, contrib)
    return y[:, :s].to(x.dtype)


def _ffn_local(cfg: MoEConfig, xe, w_up, *rest):
    """The experts' FFN, [B, E, C, D] -> [B, E, C, D]."""
    f = ACTIVATIONS[cfg.act]
    up = torch.einsum("becd,edf->becf", xe, w_up)
    if cfg.gated:
        up = f(torch.einsum("becd,edf->becf", xe, rest[0])) * up
    else:
        up = f(up)
    return torch.einsum("becf,efd->becd", up, rest[-1])


def aux_load_balance_loss(params: Params, cfg: MoEConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style load balance loss: E * sum_e f_e * p_e."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    logits = (xt @ params["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    top_e = torch.argmax(gates, dim=-1)
    frac = F.one_hot(top_e, cfg.n_experts).float().mean(dim=0)
    prob = gates.mean(dim=0)
    return cfg.n_experts * torch.sum(frac * prob)
