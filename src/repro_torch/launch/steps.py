"""Step factories for serving: prefill and one greedy decode step.

PyTorch runs eagerly, so a step is a closure over the architecture and
dtype policy; there is nothing to jit.  ``make_train_step`` waits for
the training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import DTypePolicy
from repro_torch.models.lm import decode_step, prefill


def make_prefill_step(arch: ArchConfig, policy: DTypePolicy,
                      cache_len: int) -> Callable:
    def prefill_step(params, batch):
        return prefill(params, arch, batch, cache_len, policy)

    return prefill_step


def make_decode_step(arch: ArchConfig, policy: DTypePolicy, *,
                     mla_absorb: bool = False) -> Callable:
    """A greedy step: (next token [B, 1] int32, logits, cache).  The
    attention families update ``cache``'s tensors in place."""
    def serve_step(params, cache, tokens):
        logits, cache = decode_step(params, arch, cache, tokens, policy,
                                    mla_absorb=mla_absorb)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_tok.to(torch.int32), logits, cache

    return serve_step
