"""Table-based AMM designs (paper section II-B): LVT and remap table.

* LVT (live value table): one full-depth bank per write port (each
  conceptually replicated ``n_read`` times in hardware for read scaling —
  functionally the replicas are identical so we store one copy).  The
  LVT records, per address, which write-port bank holds the newest value.

* Remap table: ``n_write + 1`` full-depth banks.  Each incoming write is
  steered to a bank not used by another write this cycle (always possible
  with one spare bank); the remap table tracks the live bank per address.

These are the per-step models: one cycle a call, each port's condition a
``torch.where`` over both branches (no value is read back to the host).
``repro_torch.core.amm.replay`` carries the batched flat twins of both
step functions; ``tests/test_torch_amm.py`` pins the two paths equal.
"""
from __future__ import annotations

import torch

from repro_torch.core.amm.spec import AMMSpec

Tree = dict[str, torch.Tensor]


def _set(x: torch.Tensor, index: tuple, value: torch.Tensor) -> torch.Tensor:
    """``x`` with ``x[index] = value`` (a new tensor; one element; an
    index is a scalar tensor or a Python int)."""
    idx = tuple(torch.full((1,), i, device=x.device) if isinstance(i, int)
                else i.reshape(1) for i in index)
    return x.index_put(idx, value.reshape(1))


# ----------------------------------------------------------------------
# LVT
# ----------------------------------------------------------------------
def lvt_init(spec: AMMSpec, values: torch.Tensor) -> Tree:
    banks = values[None, :].repeat(spec.n_write, 1)
    table = torch.zeros((spec.depth,), dtype=torch.int32, device=values.device)
    return {"banks": banks, "lvt": table}


def lvt_read(state: Tree, addr: torch.Tensor) -> torch.Tensor:
    return state["banks"][state["lvt"][addr].long(), addr]


def lvt_write_port(state: Tree, port: int, addr: torch.Tensor,
                   value: torch.Tensor, mask: torch.Tensor) -> Tree:
    banks, lvt = state["banks"], state["lvt"]
    return {"banks": _set(banks, (port, addr),
                          torch.where(mask, value, banks[port, addr])),
            "lvt": _set(lvt, (addr,), torch.where(mask, port, lvt[addr]))}


def lvt_step(state, read_addrs, write_addrs, write_vals, write_mask):
    vals = lvt_read(state, read_addrs)
    n_write = state["banks"].shape[0]
    for p in range(n_write):  # ports resolve in order; later port wins
        state = lvt_write_port(state, p, write_addrs[p], write_vals[p],
                               write_mask[p])
    return state, vals


def lvt_peek(state: Tree) -> torch.Tensor:
    table = state["lvt"]
    idx = torch.arange(table.shape[0], device=table.device)
    return state["banks"][table.long(), idx]


# ----------------------------------------------------------------------
# Remap table
# ----------------------------------------------------------------------
def remap_init(spec: AMMSpec, values: torch.Tensor) -> Tree:
    banks = values[None, :].repeat(spec.n_write + 1, 1)
    table = torch.zeros((spec.depth,), dtype=torch.int32, device=values.device)
    return {"banks": banks, "map": table}


def remap_read(state: Tree, addr: torch.Tensor) -> torch.Tensor:
    return state["banks"][state["map"][addr].long(), addr]


def remap_step(state, read_addrs, write_addrs, write_vals, write_mask):
    vals = remap_read(state, read_addrs)
    banks, table = state["banks"], state["map"]
    n_banks = banks.shape[0]
    used = torch.zeros((n_banks,), dtype=torch.bool, device=banks.device)
    rot = torch.arange(n_banks, device=banks.device)
    for p in range(write_addrs.shape[0]):
        a, v, m = write_addrs[p], write_vals[p], write_mask[p]
        # first bank, scanning from the preferred one, not used this cycle
        order = (table[a].long() + rot) % n_banks
        free = (~used[order]).to(torch.int32)
        bank = order[free.argmax()]  # argmax: the first free slot
        banks = _set(banks, (bank, a), torch.where(m, v, banks[bank, a]))
        table = _set(table, (a,), torch.where(m, bank.to(torch.int32),
                                              table[a]))
        used = _set(used, (bank,), used[bank] | m)
    return {"banks": banks, "map": table}, vals


def remap_peek(state: Tree) -> torch.Tensor:
    table = state["map"]
    idx = torch.arange(table.shape[0], device=table.device)
    return state["banks"][table.long(), idx]
