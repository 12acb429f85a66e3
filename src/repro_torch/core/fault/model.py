"""Architectural fault model: what can break inside an AMM's storage.

The taxonomy covers the three standard SRAM failure classes, lowered
onto the *flat replay state* of every design kind
(:mod:`repro_torch.core.amm.replay`):

``bit_flip``   transient single-event upset — one bit of one word of one
               physical bank XORs at an injection cycle; heals when the
               word is overwritten.
``stuck_at``   hard single-bit fault — one bit is forced to 0/1 from the
               injection cycle onward; writes to it never take.
``bank_loss``  whole-structure failure — an entire physical leaf bank
               (one row of a 2-D state matrix, one word-interleaved
               bank of a banked array, or a whole 1-D structure) reads
               as zeros from the injection cycle onward.

A :class:`FaultSpec` is a *logical* description; :func:`build_masks`
lowers a batch of them (in numpy ``uint32``, then viewed once as int32
bits) to the stacked :class:`repro_torch.core.amm.replay.FaultMask`
tensors the batched fault replay consumes.  :func:`sample_faults` draws
a seeded, reproducible population over the design's physical storage:
the same draws as the JAX package, so campaigns match its goldens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.amm import replay as rp
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.device import resolve_device

FAULT_KINDS: tuple[str, ...] = ("bit_flip", "stuck_at", "bank_loss")

__all__ = ["FAULT_KINDS", "FaultSpec", "state_geometry", "sample_faults",
           "build_masks", "tile_states"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected physical fault.

    Attributes:
      kind: one of :data:`FAULT_KINDS`.
      key: flat-state array the fault lands in (``banks`` / ``s0`` /
        ``s1`` / ``ref`` / ``mem`` — data storage only; the LVT/remap
        steering tables are out of scope for this campaign model).
      bank: row index for 2-D state matrices (leaf bank / write bank);
        for 1-D arrays under ``bank_loss`` it selects the
        word-interleaved bank when the design is ``banked`` (the
        ``mem`` words with ``index % n_banks == bank``), else 0.
      offset: word offset inside the bank (ignored by ``bank_loss``).
      bit: bit position 0..width-1 (``bit_flip`` / ``stuck_at``).
      value: the forced bit value for ``stuck_at`` (0 or 1).
      cycle: injection cycle (reads from this cycle on see the fault).
    """

    kind: str
    key: str
    bank: int
    offset: int
    bit: int
    value: int
    cycle: int


def state_geometry(spec: AMMSpec) -> dict[str, tuple[int, ...]]:
    """Shapes of the *data* arrays of ``spec``'s flat replay state
    (steering tables excluded — they are logic, not SRAM content)."""
    k = spec.read_tree_levels
    if spec.kind == "h_ntx_rd":
        return {"banks": (3 ** k, spec.depth >> k)}
    if spec.kind == "b_ntx_wr":
        half = spec.depth // 2
        return {"s0": (half,), "s1": (half,), "ref": (half,)}
    if spec.kind == "hb_ntx":
        half = spec.depth // 2
        shape = (3 ** k, half >> k)
        return {"s0": shape, "s1": shape, "ref": shape}
    if spec.kind == "lvt":
        return {"banks": (spec.n_write, spec.depth)}
    if spec.kind == "remap":
        return {"banks": (spec.n_write + 1, spec.depth)}
    return {"mem": (spec.depth,)}


def sample_faults(spec: AMMSpec, n_faults: int, seed: int,
                  n_cycles: int,
                  kinds: tuple[str, ...] = FAULT_KINDS) -> list[FaultSpec]:
    """Draw a deterministic fault population over ``spec``'s storage.

    Faults are injected in the first half of the trace so every fault
    has post-injection reads to classify.  The same ``(spec, seed,
    n_faults, n_cycles, kinds)`` always yields the same population.
    """
    for k in kinds:
        if k not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {k!r}")
    geo = state_geometry(spec)
    keys = sorted(geo)
    rng = np.random.default_rng([seed, rp.spec_seed(spec, salt="fault")])
    faults = []
    for _ in range(n_faults):
        kind = kinds[rng.integers(len(kinds))]
        key = keys[rng.integers(len(keys))]
        shape = geo[key]
        if len(shape) == 2:
            bank = int(rng.integers(shape[0]))
            offset = int(rng.integers(shape[1]))
        else:
            nb = spec.n_banks if spec.kind == "banked" else 1
            bank = int(rng.integers(nb)) if kind == "bank_loss" else 0
            offset = int(rng.integers(shape[0]))
        faults.append(FaultSpec(
            kind=kind, key=key, bank=bank, offset=offset,
            bit=int(rng.integers(spec.width if spec.width <= 32 else 32)),
            value=int(rng.integers(2)),
            cycle=int(rng.integers(max(1, n_cycles // 2)))))
    return faults


def _lower_one(spec: AMMSpec, geo: dict, f: FaultSpec,
               xor_once: dict, stuck_mask: dict, stuck_val: dict) -> None:
    """Fill one fault's numpy ``uint32`` masks in place."""
    if f.key not in geo:
        raise KeyError(f"{f.key!r} is not a data array of {spec.describe()}")
    shape = geo[f.key]
    bit = np.uint32(1) << np.uint32(f.bit % 32)
    if f.kind == "bit_flip":
        idx = (f.bank, f.offset) if len(shape) == 2 else (f.offset,)
        xor_once[f.key][idx] ^= bit
    elif f.kind == "stuck_at":
        idx = (f.bank, f.offset) if len(shape) == 2 else (f.offset,)
        stuck_mask[f.key][idx] |= bit
        if f.value:
            stuck_val[f.key][idx] |= bit
        else:
            stuck_val[f.key][idx] &= ~bit
    elif f.kind == "bank_loss":
        full = np.uint32(0xFFFFFFFF)
        if len(shape) == 2:
            stuck_mask[f.key][f.bank, :] = full
            stuck_val[f.key][f.bank, :] = 0
        elif spec.kind == "banked" and spec.n_banks > 1:
            # banked arrays interleave words across banks: losing bank b
            # kills every word with index % n_banks == b
            stuck_mask[f.key][f.bank::spec.n_banks] = full
            stuck_val[f.key][f.bank::spec.n_banks] = 0
        else:
            stuck_mask[f.key][:] = full
            stuck_val[f.key][:] = 0
    else:
        raise ValueError(f"unknown fault kind {f.kind!r}")


def build_masks(spec: AMMSpec, faults: list[FaultSpec],
                device: "str | torch.device | None" = None) -> rp.FaultMask:
    """Lower ``faults`` to a stacked :class:`FaultMask` (axis 0 = fault
    instance) on ``device`` (CUDA when None), ready for
    :func:`repro_torch.core.amm.replay.replay_faulty_batched`.

    Non-data state keys (LVT/remap steering tables) get all-zero masks
    so the dict matches the full flat state.
    """
    dev = resolve_device(device)
    tmpl = rp.init_flat(spec, device="cpu")
    geo = state_geometry(spec)
    F = len(faults)
    per_key = {
        k: tuple(np.zeros((F,) + tuple(v.shape), np.uint32)
                 for _ in range(3))
        for k, v in tmpl.items()
    }
    for i, f in enumerate(faults):
        xor_once = {k: a[0][i] for k, a in per_key.items()}
        stuck_mask = {k: a[1][i] for k, a in per_key.items()}
        stuck_val = {k: a[2][i] for k, a in per_key.items()}
        _lower_one(spec, geo, f, xor_once, stuck_mask, stuck_val)

    def as_state(j: int) -> rp.FlatState:
        return {k: rp.words(a[j], dev) for k, a in per_key.items()}

    return rp.FaultMask(
        torch.tensor([f.cycle for f in faults], dtype=torch.int32,
                     device=dev),
        as_state(0), as_state(1), as_state(2))


def tile_states(spec: AMMSpec, values, n: int,
                device: "str | torch.device | None" = None) -> rp.FlatState:
    """``n`` identical initial flat states on ``device`` (the batch axis
    for a campaign: every fault instance starts from the same contents).
    Each lane is its own copy, never a view shared with another lane."""
    base = rp.init_flat(spec, values, device)
    return {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
            for k, v in base.items()}
