"""Whole-trace AMM replay engine, on a leading batch axis.

Every design's state is a dict of fixed-shape tensors (a *flat state*).
The H-NTX ternary tree is a ``(3**k, leaf_depth)`` bank matrix plus
three path-index tables (the direct leaf, the ``2**k`` write-path
leaves and the ``2**k`` parity-reconstruction leaves, see
:class:`HTables`); LVT, remap, banked and ideal states are flat already.

The step functions are written once, for a batch of independent design
instances: axis 0 of every state tensor is the instance (lane) axis.
:func:`replay` is the batch of one; :func:`replay_batched` runs many
instances, each on its own ``[T, ...]`` trace or all on one shared trace.
A replay is a Python loop over the T cycles that launches tensor
operations and never waits for the device: no value is read back to the
host, and conditional updates are masked ``torch.where`` writes (an XOR
write of a masked-to-zero delta is the H-NTX conditional).

Words are ``uint32`` in the paper's models.  Here they are carried as
``int32`` tensors that hold the same bits (XOR, AND, OR and NOT give the
same bits); :func:`words` makes them from numpy ``uint32`` and
``convert.flat_state_to_numpy`` views them back.  The LVT and remap
steering tables (``lvt``, ``map``) are ``int32`` values.

Fault injection (:class:`FaultMask`, :func:`replay_faulty`,
:func:`replay_faulty_batched`) applies per-lane masks at the start of
every cycle, before its reads; ``repro_torch.core.fault`` samples and
classifies the faults.

Flat state converts to and from the step models' pytree state
(``repro_torch.core.amm.ntx`` / ``lvt`` / ``banked``) through
:func:`flatten_state` / :func:`unflatten_state`, leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import itertools
import zlib
from functools import lru_cache, partial
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.amm.spec import AMMSpec
from repro_torch.device import resolve_device

FlatState = dict[str, torch.Tensor]

# flat-state keys that hold int32 steering values, not words
STEERING_KEYS = ("lvt", "map")

__all__ = [
    "ReplayResult", "HTables", "h_tables", "words",
    "init_flat", "flatten_state", "unflatten_state", "peek_flat",
    "replay", "replay_batched", "make_trace", "spec_seed",
    "FaultMask", "zero_fault", "replay_faulty", "replay_faulty_batched",
]


class ReplayResult(NamedTuple):
    """Per-cycle outputs of a whole-trace replay (a leading batch axis
    on each for the batched entry points).

    ``read_vals``   [T, R] int32 words — direct-path reads.
    ``parity_vals`` [T, R] int32 words — XOR-reconstruction-path reads
                    (equal to ``read_vals`` whenever the design is correct).
    ``write_banks`` [T, W] int32 or None — for ``remap`` only: the physical
                    bank each masked write was steered to (-1 where the
                    port was idle).
    """

    read_vals: torch.Tensor
    parity_vals: torch.Tensor
    write_banks: torch.Tensor | None


def words(x, device: "str | torch.device") -> torch.Tensor:
    """``uint32`` words (numpy or a list) as an int32 tensor holding the
    same bits on ``device``; an int32 tensor is taken as such bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"words must be int32 bit patterns, got {x.dtype}")
        return x.to(device)
    a = np.ascontiguousarray(np.asarray(x).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


# ======================================================================
# H-NTX path-index tables
# ======================================================================
@dataclasses.dataclass(frozen=True)
class HTables:
    """Precomputed leaf-path tables for one H-NTX-Rd tree geometry.

    A tree over ``depth`` words with ``levels=k`` has ``3**k`` leaves of
    ``leaf_depth = depth >> k`` words, indexed by base-3 digits
    (0 = b0, 1 = b1, 2 = ref), most-significant level first.  For every
    logical address ``a``:

    ``direct[a]``        the single leaf the direct read path lands in.
    ``write_paths[a]``   the ``2**k`` leaves an invariant-maintaining
                         write touches (each level: own child OR ref).
    ``parity_paths[a]``  the ``2**k`` leaves whose XOR reconstructs the
                         word (each level: *other* child OR ref).
    ``offset[a]``        the word offset inside every one of those leaves.
    """

    depth: int
    levels: int
    leaf_depth: int
    direct: np.ndarray        # [depth]        int32
    write_paths: np.ndarray   # [depth, 2**k]  int32
    parity_paths: np.ndarray  # [depth, 2**k]  int32
    offset: np.ndarray        # [depth]        int32


@lru_cache(maxsize=None)
def h_tables(depth: int, levels: int) -> HTables:
    k = levels
    addrs = np.arange(depth, dtype=np.int64)
    off = addrs.copy()
    bits = np.zeros((depth, k), np.int64)
    cur = depth
    for lvl in range(k):
        half = cur // 2
        hi = (off >= half).astype(np.int64)
        bits[:, lvl] = hi
        off -= hi * half
        cur = half
    w3 = 3 ** np.arange(k - 1, -1, -1, dtype=np.int64)  # MSB level first
    direct = bits @ w3
    n_paths = 1 << k
    write_paths = np.zeros((depth, n_paths), np.int64)
    parity_paths = np.zeros((depth, n_paths), np.int64)
    for j, choice in enumerate(itertools.product((0, 1), repeat=k)):
        c = np.asarray(choice, np.int64)  # 1 = take the ref branch
        write_paths[:, j] = np.where(c, 2, bits) @ w3
        parity_paths[:, j] = np.where(c, 2, 1 - bits) @ w3
    return HTables(depth, k, depth >> k, direct.astype(np.int32),
                   write_paths.astype(np.int32),
                   parity_paths.astype(np.int32), off.astype(np.int32))


class _HIndex(NamedTuple):
    """:class:`HTables` as int64 index tensors on one device."""

    direct: torch.Tensor
    write: torch.Tensor
    parity: torch.Tensor
    offset: torch.Tensor


@lru_cache(maxsize=None)
def _h_index(depth: int, levels: int, device: torch.device) -> _HIndex:
    tb = h_tables(depth, levels)
    return _HIndex(*(torch.from_numpy(a).long().to(device) for a in
                     (tb.direct, tb.write_paths, tb.parity_paths,
                      tb.offset)))


def _lanes(lane: torch.Tensor, ndim: int) -> torch.Tensor:
    """The lane index shaped to broadcast against a [B, ...] index of
    ``ndim`` dimensions."""
    return lane.view((-1,) + (1,) * (ndim - 1))


def _h_direct(ix: _HIndex, lane, banks, addr):
    """Direct-path read; banks [B, 3**k, leaf]; addr [B] or [B, R]."""
    return banks[_lanes(lane, addr.dim()), ix.direct[addr], ix.offset[addr]]


def _h_parity(ix: _HIndex, lane, banks, addr):
    """Reconstruction-path read: XOR of the 2**k parity-path leaves."""
    leaves = banks[_lanes(lane, addr.dim() + 1), ix.parity[addr],
                   ix.offset[addr].unsqueeze(-1)]          # [..., 2**k]
    out = leaves[..., 0]
    for j in range(1, leaves.shape[-1]):
        out = out ^ leaves[..., j]
    return out


def _h_xor_write(ix: _HIndex, lane, banks, addr, delta) -> None:
    """XOR ``delta`` [B] into every write-path leaf of ``addr`` [B], in
    place.  ``ref = b0 ^ b1`` holds at every level, so a logical write of
    ``v`` is ``delta = v ^ old`` XORed into the write-path leaves, and a
    masked-off write is ``delta = 0``.  The rows of one path set are
    distinct and the lanes are, so no element is written twice."""
    rows = ix.write[addr]                                   # [B, 2**k]
    o = ix.offset[addr].unsqueeze(-1)
    lanes = _lanes(lane, 2)
    banks[lanes, rows, o] = banks[lanes, rows, o] ^ delta.unsqueeze(-1)


def _h_set_write(ix: _HIndex, lane, banks, addr, value, mask) -> None:
    delta = torch.where(mask, value ^ _h_direct(ix, lane, banks, addr), 0)
    _h_xor_write(ix, lane, banks, addr, delta)


# ======================================================================
# Per-cycle step functions: state [B, ...] updated in place; trace rows
# ra [B, R], wa / wv / wm [B, W]; return (vals, parity, aux)
# ======================================================================
def _split(addr: torch.Tensor, half: int):
    hi = addr >= half
    return hi, torch.where(hi, addr - half, addr)


def _h_step(ix: _HIndex, lane, state: FlatState, ra, wa, wv, wm):
    banks = state["banks"]
    vals = _h_direct(ix, lane, banks, ra)
    parity = _h_parity(ix, lane, banks, ra)
    _h_set_write(ix, lane, banks, wa[:, 0], wv[:, 0], wm[:, 0])
    return vals, parity, None


def _b_step(half: int, state: FlatState, ra, wa, wv, wm):
    s0, s1, ref = state["s0"], state["s1"], state["ref"]
    hi, off = _split(ra, half)
    vals = torch.where(hi, s1.gather(1, off), s0.gather(1, off)) \
        ^ ref.gather(1, off)
    # write port 0: plain encoded write into its half
    hi0, off0 = _split(wa[:, :1], half)
    m0 = wm[:, :1]
    enc0 = wv[:, :1] ^ ref.gather(1, off0)
    s0.scatter_(1, off0, torch.where(m0 & ~hi0, enc0, s0.gather(1, off0)))
    s1.scatter_(1, off0, torch.where(m0 & hi0, enc0, s1.gather(1, off0)))
    # write port 1: plain if it lands in the other bank, else the paper's
    # Ref re-pointing RMW sequence.  Every read of port 1 comes after
    # port 0's writes and before any of port 1's.
    hi1, off1 = _split(wa[:, 1:2], half)
    m1, v1 = wm[:, 1:2], wv[:, 1:2]
    conflict = m1 & m0 & (hi0 == hi1)
    plain = m1 & ~(m0 & (hi0 == hi1))
    r1, a0, a1 = ref.gather(1, off1), s0.gather(1, off1), s1.gather(1, off1)
    enc1 = v1 ^ r1
    t = torch.where(hi1, a0, a1) ^ r1
    new_ref = v1 ^ torch.where(hi1, a1, a0)
    m_s0 = (plain & ~hi1) | (conflict & hi1)
    v_s0 = torch.where(conflict & hi1, new_ref ^ t, enc1)
    m_s1 = (plain & hi1) | (conflict & ~hi1)
    v_s1 = torch.where(conflict & ~hi1, new_ref ^ t, enc1)
    s0.scatter_(1, off1, torch.where(m_s0, v_s0, a0))
    s1.scatter_(1, off1, torch.where(m_s1, v_s1, a1))
    ref.scatter_(1, off1, torch.where(conflict, new_ref, r1))
    return vals, vals, None


def _hb_step(ix: _HIndex, lane, half: int, state: FlatState, ra, wa, wv,
             wm):
    s0, s1, ref = state["s0"], state["s1"], state["ref"]
    direct = partial(_h_direct, ix, lane)
    par = partial(_h_parity, ix, lane)
    hi, off = _split(ra, half)
    vals = torch.where(hi, direct(s1, off), direct(s0, off)) \
        ^ direct(ref, off)
    parity = torch.where(hi, par(s1, off), par(s0, off)) ^ par(ref, off)
    # write port 0
    hi0, off0 = _split(wa[:, 0], half)
    m0 = wm[:, 0]
    enc0 = wv[:, 0] ^ direct(ref, off0)
    _h_set_write(ix, lane, s0, off0, enc0, m0 & ~hi0)
    _h_set_write(ix, lane, s1, off0, enc0, m0 & hi0)
    # write port 1: all of its reads after port 0's writes, before its own
    hi1, off1 = _split(wa[:, 1], half)
    m1, v1 = wm[:, 1], wv[:, 1]
    conflict = m1 & m0 & (hi0 == hi1)
    plain = m1 & ~(m0 & (hi0 == hi1))
    r1, a0, a1 = direct(ref, off1), direct(s0, off1), direct(s1, off1)
    enc1 = v1 ^ r1
    t = torch.where(hi1, a0, a1) ^ r1
    new_ref = v1 ^ torch.where(hi1, a1, a0)
    m_s0 = (plain & ~hi1) | (conflict & hi1)
    v_s0 = torch.where(conflict & hi1, new_ref ^ t, enc1)
    m_s1 = (plain & hi1) | (conflict & ~hi1)
    v_s1 = torch.where(conflict & ~hi1, new_ref ^ t, enc1)
    _h_set_write(ix, lane, s0, off1, v_s0, m_s0)
    _h_set_write(ix, lane, s1, off1, v_s1, m_s1)
    _h_set_write(ix, lane, ref, off1, new_ref, conflict)
    return vals, parity, None


def _lvt_step(n_write: int, lane, state: FlatState, ra, wa, wv, wm):
    banks, lvt = state["banks"], state["lvt"]
    vals = banks[_lanes(lane, 2), lvt.gather(1, ra).long(), ra]
    for p in range(n_write):  # ports resolve in order; later port wins
        a, m = wa[:, p], wm[:, p]
        banks[lane, p, a] = torch.where(m, wv[:, p], banks[lane, p, a])
        lvt[lane, a] = torch.where(m, p, lvt[lane, a])
    return vals, vals, None


def _remap_step(n_banks: int, lane, state: FlatState, ra, wa, wv, wm):
    banks, table = state["banks"], state["map"]
    vals = banks[_lanes(lane, 2), table.gather(1, ra).long(), ra]
    used = torch.zeros((lane.shape[0], n_banks), dtype=torch.bool,
                       device=lane.device)
    rot = torch.arange(n_banks, device=lane.device)
    chosen = []
    for p in range(wa.shape[1]):
        a, v, m = wa[:, p], wv[:, p], wm[:, p]
        # first bank, scanning from the preferred one, not used this cycle
        # (argmax returns the first maximum)
        order = (table[lane, a].long().unsqueeze(1) + rot) % n_banks
        free = (~used.gather(1, order)).to(torch.int32)
        bank = order.gather(1, free.argmax(1, keepdim=True)).squeeze(1)
        banks[lane, bank, a] = torch.where(m, v, banks[lane, bank, a])
        bank32 = bank.to(torch.int32)
        table[lane, a] = torch.where(m, bank32, table[lane, a])
        used[lane, bank] = used[lane, bank] | m
        chosen.append(torch.where(m, bank32, -1))
    return vals, vals, torch.stack(chosen, 1)


def _ideal_step(state: FlatState, ra, wa, wv, wm):
    mem = state["mem"]
    vals = mem.gather(1, ra)
    for p in range(wa.shape[1]):  # later ports win, like LVT order
        a = wa[:, p:p + 1]
        mem.scatter_(1, a, torch.where(wm[:, p:p + 1], wv[:, p:p + 1],
                                       mem.gather(1, a)))
    return vals, vals, None


def _step_fn(spec: AMMSpec, lane: torch.Tensor) -> Callable:
    dev = lane.device
    if spec.kind == "h_ntx_rd":
        return partial(_h_step, _h_index(spec.depth, spec.read_tree_levels,
                                         dev), lane)
    if spec.kind == "b_ntx_wr":
        return partial(_b_step, spec.depth // 2)
    if spec.kind == "hb_ntx":
        return partial(_hb_step, _h_index(spec.depth // 2,
                                          spec.read_tree_levels, dev),
                       lane, spec.depth // 2)
    if spec.kind == "lvt":
        return partial(_lvt_step, spec.n_write, lane)
    if spec.kind == "remap":
        return partial(_remap_step, spec.n_write + 1, lane)
    if spec.kind in ("ideal", "banked", "multipump"):
        return _ideal_step
    raise ValueError(f"unknown design kind: {spec.kind}")


# ======================================================================
# Flat state construction / conversion
# ======================================================================
def _h_encode(values: torch.Tensor, levels: int) -> torch.Tensor:
    """Canonical leaf matrix [..., 3**levels, n >> levels] for logical
    content ``values`` [..., n]: recursively stack [encode(lo),
    encode(hi), encode(lo ^ hi)] (b0/b1/ref order)."""
    if levels == 0:
        return values.unsqueeze(-2)
    half = values.shape[-1] // 2
    lo, hi = values[..., :half], values[..., half:]
    return torch.cat([_h_encode(lo, levels - 1), _h_encode(hi, levels - 1),
                      _h_encode(lo ^ hi, levels - 1)], dim=-2)


def _init_flat(spec: AMMSpec, values: torch.Tensor) -> FlatState:
    """Flat state of ``values`` [..., depth] int32 words; any leading
    axes are batch axes."""
    k = spec.read_tree_levels
    lead = values.shape[:-1]
    if spec.kind == "h_ntx_rd":
        return {"banks": _h_encode(values, k)}
    if spec.kind == "b_ntx_wr":
        half = spec.depth // 2
        return {"s0": values[..., :half].clone(),
                "s1": values[..., half:].clone(),
                "ref": torch.zeros_like(values[..., :half])}
    if spec.kind == "hb_ntx":
        half = spec.depth // 2
        return {"s0": _h_encode(values[..., :half], k),
                "s1": _h_encode(values[..., half:], k),
                "ref": _h_encode(torch.zeros_like(values[..., :half]), k)}
    if spec.kind == "lvt":
        return {"banks": values.unsqueeze(-2).repeat(
                    (1,) * len(lead) + (spec.n_write, 1)),
                "lvt": torch.zeros(lead + (spec.depth,), dtype=torch.int32,
                                   device=values.device)}
    if spec.kind == "remap":
        return {"banks": values.unsqueeze(-2).repeat(
                    (1,) * len(lead) + (spec.n_write + 1, 1)),
                "map": torch.zeros(lead + (spec.depth,), dtype=torch.int32,
                                   device=values.device)}
    if spec.kind in ("ideal", "banked", "multipump"):
        return {"mem": values.clone()}
    raise ValueError(f"unknown design kind: {spec.kind}")


def init_flat(spec: AMMSpec, values=None,
              device: "str | torch.device | None" = None) -> FlatState:
    """Flat initial state holding logical content ``values`` [..., depth]
    (numpy ``uint32`` or int32 bits; zeros if None) on ``device`` (CUDA
    when None).  Leading axes of ``values`` become lane axes."""
    dev = resolve_device(device)
    if values is None:
        values = torch.zeros((spec.depth,), dtype=torch.int32, device=dev)
    values = words(values, dev)
    if values.dim() == 0 or values.shape[-1] != spec.depth:
        raise ValueError(f"init values must be [..., {spec.depth}]")
    return _init_flat(spec, values)


def _h_flatten(node: dict) -> torch.Tensor:
    if "leaf" in node:
        return node["leaf"][None, :]
    return torch.cat([_h_flatten(node["b0"]), _h_flatten(node["b1"]),
                      _h_flatten(node["ref"])])


def _h_unflatten(banks: torch.Tensor) -> dict:
    if banks.shape[0] == 1:
        return {"leaf": banks[0]}
    third = banks.shape[0] // 3
    return {"b0": _h_unflatten(banks[:third]),
            "b1": _h_unflatten(banks[third:2 * third]),
            "ref": _h_unflatten(banks[2 * third:])}


def flatten_state(spec: AMMSpec, state: Any) -> FlatState:
    """Step-path pytree state -> flat replay state (the same leaves)."""
    if spec.kind == "h_ntx_rd":
        return {"banks": _h_flatten(state)}
    if spec.kind == "hb_ntx":
        return {"s0": _h_flatten(state["s0"]), "s1": _h_flatten(state["s1"]),
                "ref": _h_flatten(state["ref"])}
    return dict(state)  # b_ntx_wr / lvt / remap / ideal are already flat


def unflatten_state(spec: AMMSpec, flat: FlatState) -> Any:
    """Flat replay state -> step-path pytree state."""
    if spec.kind == "h_ntx_rd":
        return _h_unflatten(flat["banks"])
    if spec.kind == "hb_ntx":
        return {"s0": _h_unflatten(flat["s0"]),
                "s1": _h_unflatten(flat["s1"]),
                "ref": _h_unflatten(flat["ref"])}
    return dict(flat)


def peek_flat(spec: AMMSpec, flat: FlatState) -> torch.Tensor:
    """Decode the full logical array [depth] from a flat state."""
    if spec.kind in ("h_ntx_rd", "hb_ntx"):
        n = spec.depth if spec.kind == "h_ntx_rd" else spec.depth // 2
        ix = _h_index(n, spec.read_tree_levels,
                      next(iter(flat.values())).device)

        def direct(banks):
            return banks[ix.direct, ix.offset]

        if spec.kind == "h_ntx_rd":
            return direct(flat["banks"])
        ref = direct(flat["ref"])
        return torch.cat([direct(flat["s0"]) ^ ref, direct(flat["s1"]) ^ ref])
    if spec.kind == "b_ntx_wr":
        return torch.cat([flat["s0"] ^ flat["ref"], flat["s1"] ^ flat["ref"]])
    if spec.kind in ("lvt", "remap"):
        table = flat["lvt" if spec.kind == "lvt" else "map"]
        idx = torch.arange(table.shape[0], device=table.device)
        return flat["banks"][table.long(), idx]
    return flat["mem"]


# ======================================================================
# Whole-trace replay
# ======================================================================
class FaultMask(NamedTuple):
    """One physical fault, lowered to per-state-array masks.

    Applied at the start of every cycle, *before* the cycle's reads — so
    reads from cycle ``cycle`` onward observe the corrupted storage, and
    in-cycle writes behave like real hardware (a later write overwrites a
    transient flip; a stuck bit re-asserts itself every cycle, so writes
    never take).

    ``cycle``      int32 — the injection cycle ([B] when batched).
    ``xor_once``   per-key int32 bits XORed into the state at ``cycle``
                   only (transient single-event upset).
    ``stuck_mask`` per-key bit mask forced from ``cycle`` onward.
    ``stuck_val``  the value those bits are forced to (stuck-at-0/1 and
                   whole-bank loss = a full-word mask stuck to zero).

    Every key of the design's flat state is present (zeros = untouched);
    :func:`zero_fault` builds the no-op template.  For
    :func:`replay_faulty_batched` every tensor carries the lane axis.
    """

    cycle: torch.Tensor
    xor_once: FlatState
    stuck_mask: FlatState
    stuck_val: FlatState


def _apply_fault(state: FlatState, fm: FaultMask, cycle: int) -> None:
    """Apply each lane's fault to ``state`` [B, ...] in place at
    ``cycle``: the XOR once, at the injection cycle, then the stuck bits
    from then on."""
    armed = fm.cycle <= cycle
    once = fm.cycle == cycle
    for k, v in state.items():
        a, o = _lanes(armed, v.dim()), _lanes(once, v.dim())
        sm, sv = fm.stuck_mask[k], fm.stuck_val[k]
        v2 = torch.where(o, v ^ fm.xor_once[k], v)
        v.copy_(torch.where(a, (v2 & ~sm) | (sv & sm), v2))


def _as_ops(read_addrs, write_addrs, write_vals, write_mask,
            device: torch.device) -> tuple[torch.Tensor, ...]:
    def host(x, dtype):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.array(x, dtype=dtype))

    return (host(read_addrs, np.int64).to(device, torch.int64),
            host(write_addrs, np.int64).to(device, torch.int64),
            words(write_vals, device),
            host(write_mask, bool).to(device, torch.bool))


def _run(spec: AMMSpec, states: FlatState, fault: FaultMask | None,
         ops: tuple, share_trace: bool, device: torch.device
         ) -> tuple[FlatState, ReplayResult]:
    """Replay lanes ``states`` [B, ...] (copied, never written) through
    ``ops`` ([T, ...] shared, or [B, T, ...] one per lane)."""
    state = {k: v.to(device, copy=True) for k, v in states.items()}
    n = next(iter(state.values())).shape[0]
    ra, wa, wv, wm = _as_ops(*ops, device)
    if share_trace:
        ra, wa, wv, wm = (x.unsqueeze(0).expand((n,) + x.shape)
                          for x in (ra, wa, wv, wm))
    if fault is not None:
        fault = FaultMask(fault.cycle.to(device),
                          *({k: v.to(device) for k, v in d.items()}
                            for d in fault[1:]))
    lane = torch.arange(n, device=device)
    step = _step_fn(spec, lane)
    n_cycles = ra.shape[1]
    outs = []
    for t in range(n_cycles):
        if fault is not None:
            _apply_fault(state, fault, t)
        outs.append(step(state, ra[:, t], wa[:, t], wv[:, t], wm[:, t]))
    if n_cycles == 0:
        empty = torch.empty((n, 0, ra.shape[2]), dtype=torch.int32,
                            device=device)
        aux = torch.empty((n, 0, wa.shape[2]), dtype=torch.int32,
                          device=device) if spec.kind == "remap" else None
        return state, ReplayResult(empty, empty.clone(), aux)
    vals, parity, aux = zip(*outs)
    return state, ReplayResult(
        torch.stack(vals, 1), torch.stack(parity, 1),
        None if aux[0] is None else torch.stack(aux, 1))


def _one(state: FlatState) -> FlatState:
    return {k: v.unsqueeze(0) for k, v in state.items()}


def _unbatch(state: FlatState, res: ReplayResult
             ) -> tuple[FlatState, ReplayResult]:
    return ({k: v[0] for k, v in state.items()},
            ReplayResult(*(None if x is None else x[0] for x in res)))


def replay(spec: AMMSpec, state: FlatState, read_addrs, write_addrs,
           write_vals, write_mask,
           device: "str | torch.device | None" = None
           ) -> tuple[FlatState, ReplayResult]:
    """Replay a whole op trace on ``device`` (CUDA when None).

    Args:
      state: flat state from :func:`init_flat` / :func:`flatten_state`
        (not written: the replay works on a copy).
      read_addrs:  [T, n_read]  integer addresses.
      write_addrs: [T, n_write] integer addresses.
      write_vals:  [T, n_write] ``uint32`` words (or int32 bits).
      write_mask:  [T, n_write] bool.

    Returns ``(final_state, ReplayResult)``; reads are served before
    writes within each cycle, exactly like the per-step path.
    """
    dev = resolve_device(device)
    return _unbatch(*_run(spec, _one(state), None, (
        read_addrs, write_addrs, write_vals, write_mask), True, dev))


def replay_batched(spec: AMMSpec, states: FlatState, read_addrs,
                   write_addrs, write_vals, write_mask,
                   share_trace: bool = False,
                   device: "str | torch.device | None" = None
                   ) -> tuple[FlatState, ReplayResult]:
    """:func:`replay` across design instances: axis 0 of every state
    tensor is the instance.  With ``share_trace=False`` the four trace
    arrays are [B, T, ...], one trace per instance; with
    ``share_trace=True`` one [T, ...] trace drives every instance."""
    return _run(spec, states, None, (read_addrs, write_addrs, write_vals,
                                     write_mask), share_trace,
                resolve_device(device))


def zero_fault(spec: AMMSpec,
               device: "str | torch.device | None" = None) -> FaultMask:
    """The identity fault (all masks zero) for ``spec``'s flat state."""
    tmpl = init_flat(spec, device=device)

    def zeros() -> FlatState:
        return {k: torch.zeros_like(v) for k, v in tmpl.items()}

    return FaultMask(torch.zeros((), dtype=torch.int32,
                                 device=resolve_device(device)),
                     zeros(), zeros(), zeros())


def replay_faulty(spec: AMMSpec, state: FlatState, fault: FaultMask,
                  read_addrs, write_addrs, write_vals, write_mask,
                  device: "str | torch.device | None" = None
                  ) -> tuple[FlatState, ReplayResult]:
    """:func:`replay` with ``fault`` injected at the start of every
    cycle.  With :func:`zero_fault` masks the result is bit-identical to
    the clean replay."""
    one = FaultMask(fault.cycle.reshape(1), *map(_one, fault[1:]))
    return _unbatch(*_run(spec, _one(state), one, (
        read_addrs, write_addrs, write_vals, write_mask), True,
        resolve_device(device)))


def replay_faulty_batched(spec: AMMSpec, states: FlatState,
                          faults: FaultMask, read_addrs, write_addrs,
                          write_vals, write_mask, share_trace: bool = True,
                          device: "str | torch.device | None" = None
                          ) -> tuple[FlatState, ReplayResult]:
    """Batched :func:`replay_faulty`: axis 0 of ``states`` and of every
    ``faults`` tensor is the fault instance, so a whole campaign (F
    faults against one design and op stream) is one loop over the
    cycles.  ``share_trace=True`` (the campaign default) drives every
    instance with one [T, ...] trace."""
    return _run(spec, states, faults, (read_addrs, write_addrs, write_vals,
                                       write_mask), share_trace,
                resolve_device(device))


def make_trace(spec: AMMSpec, n_cycles: int, seed: int = 0,
               write_prob: float = 0.5,
               rng: np.random.Generator | None = None):
    """Random op trace in replay layout (numpy; handy for tests/benchmarks).

    Pass ``rng`` to draw from an existing generator instead of ``seed``.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    ra = rng.integers(0, spec.depth, (n_cycles, spec.n_read)).astype(np.int32)
    wa = rng.integers(0, spec.depth, (n_cycles, spec.n_write)).astype(np.int32)
    wv = rng.integers(0, 2**32, (n_cycles, spec.n_write), dtype=np.uint32)
    wm = rng.random((n_cycles, spec.n_write)) < write_prob
    return ra, wa, wv, wm


def spec_seed(spec: AMMSpec, salt: str = "") -> int:
    """Stable per-spec RNG seed (unlike ``hash()``, identical across runs)."""
    return zlib.crc32((salt + spec.describe()).encode())
