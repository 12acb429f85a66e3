"""Conventional baselines: ideal multiport RAM, array-partitioned banking,
and multi-pumping (paper section I).

Banking and multi-pumping have *identical functional semantics* to an
ideal RAM — what differs is timing (bank conflicts serialize; a
multi-pumped macro halves the external frequency), which the scheduler
models, not this state machine.  ``conflict_cycles`` is the banking
timing model: the cycles one group of parallel accesses needs.

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


# ----------------------------------------------------------------------
# Banking timing model
# ----------------------------------------------------------------------
def bank_of(addrs: torch.Tensor, n_banks: int) -> torch.Tensor:
    """Cyclic interleave: word address modulo bank count (paper IV-A:
    'arrays which have single-stride access can be partitioned
    cyclically')."""
    return torch.remainder(addrs, n_banks)


def conflict_cycles(addrs: torch.Tensor, mask: torch.Tensor, n_banks: int,
                    ports_per_bank: int = 1) -> torch.Tensor:
    """Cycles needed to issue one *group* of parallel accesses.

    addrs: [W] word addresses wanting to issue in the same cycle.
    mask:  [W] validity.
    Returns max over banks of ceil(hits / ports_per_bank); 0 if empty
    (an int32 scalar)."""
    return conflict_cycles_grouped(addrs[None], mask[None], n_banks,
                                   ports_per_bank)[0]


def conflict_cycles_grouped(addr_groups: torch.Tensor,
                            mask_groups: torch.Tensor, n_banks: int,
                            ports_per_bank: int = 1) -> torch.Tensor:
    """Vectorized over [G, W] groups -> [G] int32 cycles per group: one
    bincount of (group, bank) over the valid accesses."""
    g = addr_groups.shape[0]
    rows = torch.arange(g, device=addr_groups.device)[:, None]
    slot = (rows * n_banks + bank_of(addr_groups.long(), n_banks))
    hits = torch.bincount(slot[mask_groups.bool()],
                          minlength=g * n_banks).view(g, n_banks)
    worst = hits.amax(dim=1)
    return (-(-worst // ports_per_bank)).to(torch.int32)
