"""Conventional baselines: ideal multiport RAM, array-partitioned banking,
and multi-pumping (paper section I).

Banking and multi-pumping have *identical functional semantics* to an
ideal RAM — what differs is timing (bank conflicts serialize; a
multi-pumped macro halves the external frequency), which the scheduler
models, not this state machine.

``ideal_step`` has a batched flat twin in
``repro_torch.core.amm.replay``; ``tests/test_torch_amm.py`` pins the two
paths equal.
"""
from __future__ import annotations

import torch

from repro_torch.core.amm.spec import AMMSpec

Tree = dict[str, torch.Tensor]


def ideal_init(spec: AMMSpec, values: torch.Tensor) -> Tree:
    return {"mem": values.clone()}


def ideal_read(state: Tree, addr: torch.Tensor) -> torch.Tensor:
    return state["mem"][addr]


def ideal_step(state, read_addrs, write_addrs, write_vals, write_mask):
    vals = state["mem"][read_addrs]
    mem = state["mem"]
    for p in range(write_addrs.shape[0]):  # later ports win, like LVT order
        a = write_addrs[p].reshape(1)
        mem = mem.index_put((a,), torch.where(
            write_mask[p], write_vals[p], mem[write_addrs[p]]).reshape(1))
    return {"mem": mem}, vals


def ideal_peek(state: Tree) -> torch.Tensor:
    return state["mem"]
