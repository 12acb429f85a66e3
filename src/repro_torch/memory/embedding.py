"""Banked embedding table: the AMM plan applied to vocab gathers.

``banked_embedding_lookup`` routes through the XOR-banked gather kernel
when the planner chose AMM for the embedding stream (low-locality,
zipf-skewed token ids) and the bank count divides the table depth;
otherwise it uses a plain row gather.  That choice is the reference's
semantics, not a device fallback: the gather runs wherever the table
lies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import amm_gather
from repro_torch.memory.planner import StreamPlan


def banked_embedding_lookup(table: torch.Tensor, token_ids: torch.Tensor,
                            plan: StreamPlan | None = None) -> torch.Tensor:
    """table: [V, D]; token_ids: [...] int -> [..., D]."""
    flat = token_ids.reshape(-1)
    if plan is not None and plan.use_amm and \
            table.shape[0] % plan.n_banks == 0:
        out = amm_gather(table, flat, n_banks=plan.n_banks)
    else:
        out = table[flat.long()]
    return out.reshape(*token_ids.shape, table.shape[1])
