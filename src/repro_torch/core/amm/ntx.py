"""Non-table XOR-based AMM designs (paper section II-A).

Three functional models, each a state machine over word payloads
(``uint32`` words carried as int32 bits, see
:mod:`repro_torch.core.amm.replay`):

* ``h_ntx_rd``  — H-NTX-Rd: hierarchical read scaling.  Bank0 stores the
  low half, Bank1 the high half, Ref stores ``Bank0 ^ Bank1``.  A second
  read hitting the same bank is served as ``other_bank[o] ^ ref[o]``.
  Scaling to ``2**k`` read ports recurses: every bank (including Ref) is
  itself an H-NTX-Rd structure -> a ternary tree with ``3**k`` leaves.

* ``b_ntx_wr``  — B-NTX-Wr: banks store *encoded* data ``D ^ Ref``.
  Two conflicting writes are absorbed by re-pointing ``Ref`` (the paper's
  RMW sequence: ``T = S1[j]^Ref[j]; Ref[j] = W1 ^ S0[j]; S1[j] = Ref[j]^T``).

* ``hb_ntx``    — HB-NTX-RdWr (paper Fig 2): B-NTX-Wr at the top level
  where S0 / S1 / Ref are each H-NTX-Rd trees, yielding nR x 2W.

The models expose ``init / read / read_parity / write* / step / peek``.
``read`` decodes through the direct path; ``read_parity`` decodes through
the XOR-reconstruction path that hardware uses under a bank conflict.

Addresses, values and masks are tensors on the state's device.  Every
update is functional (a new tensor, the old state left as it was) and
every condition of the reference's ``lax.cond`` is a ``torch.where``
over both branches, carried down as a write mask, so a step never reads
a value back to the host.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.amm.spec import AMMSpec

Tree = dict[str, Any]


def _set(x: torch.Tensor, addr: torch.Tensor, value: torch.Tensor
         ) -> torch.Tensor:
    """``x`` with ``x[addr] = value`` (a new tensor; ``addr`` a scalar)."""
    return x.index_put((addr.reshape(1),), value.reshape(1))


def _always(addr: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=addr.device)


# ======================================================================
# H-NTX-Rd : ternary XOR parity tree
# ======================================================================
def h_init(values: torch.Tensor, levels: int) -> Tree:
    if levels == 0:
        return {"leaf": values.clone()}
    half = values.shape[0] // 2
    lo, hi = values[:half], values[half:]
    return {
        "b0": h_init(lo, levels - 1),
        "b1": h_init(hi, levels - 1),
        "ref": h_init(lo ^ hi, levels - 1),
    }


def _h_depth(node: Tree) -> int:
    if "leaf" in node:
        return node["leaf"].shape[0]
    return 2 * _h_depth(node["b0"])


def _split(addr: torch.Tensor, half: int):
    hi = addr >= half
    return hi, torch.where(hi, addr - half, addr)


def h_read(node: Tree, addr: torch.Tensor) -> torch.Tensor:
    """Direct-path read of logical address ``addr`` (scalar or [R])."""
    if "leaf" in node:
        return node["leaf"][addr]
    hi, off = _split(addr, _h_depth(node["b0"]))
    return torch.where(hi, h_read(node["b1"], off), h_read(node["b0"], off))


def h_read_parity(node: Tree, addr: torch.Tensor) -> torch.Tensor:
    """Conflict-path read: reconstruct from the *other* bank and Ref,
    recursing through the parity path at every level of the tree."""
    if "leaf" in node:
        return node["leaf"][addr]
    hi, off = _split(addr, _h_depth(node["b0"]))
    ref = h_read_parity(node["ref"], off)
    rec0 = h_read_parity(node["b1"], off) ^ ref
    rec1 = h_read_parity(node["b0"], off) ^ ref
    return torch.where(hi, rec1, rec0)


def h_write(node: Tree, addr: torch.Tensor, value: torch.Tensor,
            mask: torch.Tensor | None = None) -> Tree:
    """Single-port write maintaining the parity invariant at every level;
    where ``mask`` is false the tree is returned unchanged."""
    if mask is None:
        mask = _always(addr)
    if "leaf" in node:
        leaf = node["leaf"]
        return {"leaf": _set(leaf, addr, torch.where(mask, value,
                                                     leaf[addr]))}
    hi, off = _split(addr, _h_depth(node["b0"]))
    # the reference's two branches: a write into b1 (hi) or b0 (lo),
    # each with Ref re-encoded against the other half
    other = torch.where(hi, h_read(node["b0"], off), h_read(node["b1"], off))
    return {
        "b0": h_write(node["b0"], off, value, mask & ~hi),
        "b1": h_write(node["b1"], off, value, mask & hi),
        "ref": h_write(node["ref"], off, value ^ other, mask),
    }


def h_peek(node: Tree) -> torch.Tensor:
    if "leaf" in node:
        return node["leaf"]
    return torch.cat([h_peek(node["b0"]), h_peek(node["b1"])])


# ======================================================================
# B-NTX-Wr : encoded banks + reference, 2 conflict-free writes
# ======================================================================
def b_init(values: torch.Tensor) -> Tree:
    half = values.shape[0] // 2
    # Banks store encoded data D ^ Ref; with Ref == 0 that's D itself.
    return {"s0": values[:half].clone(), "s1": values[half:].clone(),
            "ref": torch.zeros_like(values[:half])}


def _b_half(state: Tree) -> int:
    return state["ref"].shape[0]


def b_read(state: Tree, addr: torch.Tensor) -> torch.Tensor:
    hi, off = _split(addr, _b_half(state))
    enc = torch.where(hi, state["s1"][off], state["s0"][off])
    return enc ^ state["ref"][off]


def b_write1(state: Tree, addr: torch.Tensor, value: torch.Tensor,
             mask: torch.Tensor | None = None) -> Tree:
    """Non-conflict single write: S_h[o] = W ^ Ref[o] (where ``mask``)."""
    if mask is None:
        mask = _always(addr)
    hi, off = _split(addr, _b_half(state))
    enc = value ^ state["ref"][off]
    s0, s1 = state["s0"], state["s1"]
    return {**state,
            "s0": _set(s0, off, torch.where(mask & ~hi, enc, s0[off])),
            "s1": _set(s1, off, torch.where(mask & hi, enc, s1[off]))}


def b_write_conflict(state: Tree, addr: torch.Tensor, value: torch.Tensor,
                     mask: torch.Tensor | None = None) -> Tree:
    """Second conflicting write into the same bank as the first one.

    Paper sequence (both writes landed in bank h):
        T      = S_other[j] ^ Ref[j]        # save the other half's value
        Ref[j] = W1 ^ S_h[j]                # re-point Ref so S_h decodes to W1
        S_other[j] = Ref[j] ^ T             # re-encode the other half
    """
    if mask is None:
        mask = _always(addr)
    hi, off = _split(addr, _b_half(state))
    s0, s1, ref = state["s0"], state["s1"], state["ref"]
    a0, a1, r = s0[off], s1[off], ref[off]
    t = torch.where(hi, a0, a1) ^ r         # hi: the other half is s0
    new_ref = value ^ torch.where(hi, a1, a0)
    return {
        "s0": _set(s0, off, torch.where(mask & hi, new_ref ^ t, a0)),
        "s1": _set(s1, off, torch.where(mask & ~hi, new_ref ^ t, a1)),
        "ref": _set(ref, off, torch.where(mask, new_ref, r)),
    }


def b_write2(state: Tree, a0, v0, m0, a1, v1, m1) -> Tree:
    """Dual-port write with the paper's conflict handling."""
    half = _b_half(state)
    state = b_write1(state, a0, v0, m0)
    same_bank = m0 & ((a0 >= half) == (a1 >= half))
    state = b_write_conflict(state, a1, v1, m1 & same_bank)
    return b_write1(state, a1, v1, m1 & ~same_bank)


def b_peek(state: Tree) -> torch.Tensor:
    return torch.cat([state["s0"] ^ state["ref"], state["s1"] ^ state["ref"]])


# ======================================================================
# HB-NTX-RdWr : B at the top, every bank an H read tree (paper Fig 2)
# ======================================================================
def hb_init(values: torch.Tensor, read_levels: int) -> Tree:
    half = values.shape[0] // 2
    return {
        "s0": h_init(values[:half], read_levels),
        "s1": h_init(values[half:], read_levels),
        "ref": h_init(torch.zeros_like(values[:half]), read_levels),
    }


def _hb_half(state: Tree) -> int:
    return _h_depth(state["ref"])


def hb_read(state: Tree, addr: torch.Tensor) -> torch.Tensor:
    hi, off = _split(addr, _hb_half(state))
    enc = torch.where(hi, h_read(state["s1"], off), h_read(state["s0"], off))
    return enc ^ h_read(state["ref"], off)


def hb_read_parity(state: Tree, addr: torch.Tensor) -> torch.Tensor:
    hi, off = _split(addr, _hb_half(state))
    enc = torch.where(hi, h_read_parity(state["s1"], off),
                      h_read_parity(state["s0"], off))
    return enc ^ h_read_parity(state["ref"], off)


def hb_write1(state: Tree, addr: torch.Tensor, value: torch.Tensor,
              mask: torch.Tensor | None = None) -> Tree:
    if mask is None:
        mask = _always(addr)
    hi, off = _split(addr, _hb_half(state))
    enc = value ^ h_read(state["ref"], off)
    return {**state,
            "s0": h_write(state["s0"], off, enc, mask & ~hi),
            "s1": h_write(state["s1"], off, enc, mask & hi)}


def hb_write_conflict(state: Tree, addr: torch.Tensor, value: torch.Tensor,
                      mask: torch.Tensor | None = None) -> Tree:
    if mask is None:
        mask = _always(addr)
    hi, off = _split(addr, _hb_half(state))
    a0, a1 = h_read(state["s0"], off), h_read(state["s1"], off)
    t = torch.where(hi, a0, a1) ^ h_read(state["ref"], off)
    new_ref = value ^ torch.where(hi, a1, a0)
    return {
        "s0": h_write(state["s0"], off, new_ref ^ t, mask & hi),
        "s1": h_write(state["s1"], off, new_ref ^ t, mask & ~hi),
        "ref": h_write(state["ref"], off, new_ref, mask),
    }


def hb_write2(state: Tree, a0, v0, m0, a1, v1, m1) -> Tree:
    half = _hb_half(state)
    state = hb_write1(state, a0, v0, m0)
    same_bank = m0 & ((a0 >= half) == (a1 >= half))
    state = hb_write_conflict(state, a1, v1, m1 & same_bank)
    return hb_write1(state, a1, v1, m1 & ~same_bank)


def hb_peek(state: Tree) -> torch.Tensor:
    ref = h_peek(state["ref"])
    return torch.cat([h_peek(state["s0"]) ^ ref, h_peek(state["s1"]) ^ ref])


# ======================================================================
# Uniform step() wrappers (read-before-write semantics)
# ======================================================================
def h_step(state, read_addrs, write_addrs, write_vals, write_mask):
    if write_addrs.shape[0] != 1:
        raise ValueError(
            f"h_ntx_rd has a single write port, got {write_addrs.shape[0]}"
        )
    vals = h_read(state, read_addrs)
    state = h_write(state, write_addrs[0], write_vals[0], write_mask[0])
    return state, vals


def b_step(state, read_addrs, write_addrs, write_vals, write_mask):
    vals = b_read(state, read_addrs)
    state = b_write2(
        state,
        write_addrs[0], write_vals[0], write_mask[0],
        write_addrs[1], write_vals[1], write_mask[1],
    )
    return state, vals


def hb_step(state, read_addrs, write_addrs, write_vals, write_mask):
    vals = hb_read(state, read_addrs)
    state = hb_write2(
        state,
        write_addrs[0], write_vals[0], write_mask[0],
        write_addrs[1], write_vals[1], write_mask[1],
    )
    return state, vals


def make_ntx(spec: AMMSpec, values: torch.Tensor):
    """Factory: returns (state, fns dict) for the requested NTX design."""
    if spec.kind == "h_ntx_rd":
        if spec.n_write != 1:
            raise ValueError("h_ntx_rd supports a single write port")
        state = h_init(values, spec.read_tree_levels)
        return state, {
            "read": h_read,
            "read_parity": h_read_parity,
            "step": h_step,
            "peek": h_peek,
        }
    if spec.kind == "b_ntx_wr":
        state = b_init(values)
        return state, {
            "read": b_read,
            "read_parity": b_read,  # B has no read-scaling parity path
            "step": b_step,
            "peek": b_peek,
        }
    if spec.kind == "hb_ntx":
        state = hb_init(values, spec.read_tree_levels)
        return state, {
            "read": hb_read,
            "read_parity": hb_read_parity,
            "step": hb_step,
            "peek": hb_peek,
        }
    raise ValueError(f"not an NTX design: {spec.kind}")
