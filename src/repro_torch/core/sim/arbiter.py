"""Per-kind memory-arbitration layer (paper II + III-C).

The port-constrained scheduler used to model every conflict-free design
as an ideal ``n_read x n_write`` multiport and only serialized
``banked``.  That erases exactly the cycle-level structure the paper's
AMM families differ in: NTX parity-path reads fan out across internal
leaf banks, B-NTX pairs same-bank writes through the Ref re-pointing
flow, LVT broadcasts every write to its read replicas, remap steers
writes under a no-two-writes-share-a-bank constraint, and multipumping
buys its ports from an internally doubled clock rather than real wiring.

This module (the descriptor half of the JAX package's
``core/sim/arbiter.py``) compiles an :class:`AMMSpec` into a compact
numeric :class:`ArbDescriptor`, and exports the descriptors, their
fixed-shape bounds and the NTX leaf-path tables as the per-design
tensors of the batched timing backend (``core/sim/batched_cycle.py``,
the ``cycle_lanes`` kernel and its plain version), which apply the
per-cycle issue rules below.  The reference's pure-Python
``PortArbiter`` is not copied yet.

Per-kind issue rules (one external cycle)
-----------------------------------------
``ideal`` / ``lvt``
    ``n_read`` loads + ``n_write`` stores, any addresses.  LVT is
    conflict-free because every write-port bank is replicated per read
    port (the broadcast is a cost/energy effect, not a timing one).
``banked``
    each of ``n_banks`` banks is a dual-port macro serving up to
    ``ports_per_bank`` accesses; conflicts serialize (seed semantics,
    pinned by the seed goldens).
``multipump``
    the advertised ``n_read``/``n_write`` ports are delivered by an
    internally double-clocked dual-port macro: per external cycle at
    most ``ports_per_bank * clock_ratio`` total accesses, capped per
    direction by the advertised port counts.  (The seed granted
    ``2*n_read`` reads *and* ``2*n_write`` writes — double-counting the
    pumping that already pays for the advertised ports.)
``h_ntx_rd``
    ``3**k`` leaf banks, one read port per (leaf, sub-bank).  A read
    takes its direct leaf if free, else the whole ``2**k``-leaf parity
    path (all leaves must be free) — else it stalls
    (``parity_fanout_stalls``).  The single write port always issues
    (the invariant-maintaining XOR scatter has dedicated write ports).
``b_ntx_wr`` / ``hb_ntx``
    two data structures (address halves) plus a Ref structure, each an
    ``h_ntx``-style tree (``k == 0`` for plain B-NTX).  A read consumes
    the direct (or parity) leaves of its data tree *and* of the Ref
    tree.  The first write per half issues plainly; a second write into
    an already-written half is the paper's pair-conflict flow: it needs
    the single Ref re-pointing unit plus read access to the *other*
    data tree and the Ref tree at its offset — if any of those leaf
    read ports were consumed this cycle the write stalls
    (``write_pair_stalls``); successful re-points are counted as
    ``write_pair_rmws`` (cross-validated against the functional models'
    conflict condition in ``core/amm/replay``).
``remap``
    ``n_write + 1`` full-depth banks and a live-map table.  A read must
    hit the bank currently holding its word (``map[word]``); a bank
    serves ``ports_per_bank`` accesses per cycle.  A write is steered to
    the first bank — scanning from the word's current bank, exactly the
    ``replay._remap_step`` rule — that has no write this cycle and a
    port left; the map is updated to the chosen bank.  Both read
    over-subscription and failed steering count as
    ``bank_conflict_stalls``.

AMM leaf sub-banking (``AMMSpec.n_banks`` on AMM kinds) splits every
leaf macro into ``n_banks`` word-interleaved sub-banks with independent
ports: two accesses to the same leaf no longer conflict unless they
also share ``offset % n_banks``.  For LVT/remap the sub-banking is a
cost/frequency effect only (their arbitration is bank-granular).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from repro_torch.core.amm.spec import AMMSpec

# kind ids, as in the reference (and csrc/cycle_lanes.cu)
KIND_IDEAL, KIND_BANKED, KIND_MULTIPUMP = 0, 1, 2
KIND_H_NTX, KIND_B_NTX, KIND_HB_NTX = 3, 4, 5
KIND_LVT, KIND_REMAP = 6, 7

KIND_IDS: dict[str, int] = {
    "ideal": KIND_IDEAL, "banked": KIND_BANKED, "multipump": KIND_MULTIPUMP,
    "h_ntx_rd": KIND_H_NTX, "b_ntx_wr": KIND_B_NTX, "hb_ntx": KIND_HB_NTX,
    "lvt": KIND_LVT, "remap": KIND_REMAP,
}

_NTX_KINDS = (KIND_H_NTX, KIND_B_NTX, KIND_HB_NTX)

# descriptor field layout (row per array), as in the reference
F_KIND, F_RD, F_WR, F_SLOTS, F_NBANKS, F_DEPTH, F_LEVELS, F_HALF, \
    F_SUB, F_MAXFAIL, F_CONFIGURED, F_NLEAVES, F_TREE_DEPTH = range(13)
N_FIELDS = 13

# stall causes of the issue rules
STALL_NONE, STALL_BANK, STALL_PARITY, STALL_PAIR = 0, 1, 2, 3

# The canonical stall taxonomy, in STALL_BANK/STALL_PARITY/STALL_PAIR
# order.  ``ScheduleResult.stall_breakdown``, the batched backend's
# results and ``DSEPoint``'s stall fields derive their key set from it.
STALL_KEYS: tuple[str, ...] = ("bank_conflict", "parity_fanout",
                               "write_pair")


@dataclasses.dataclass(frozen=True)
class ArbDescriptor:
    """Compact numeric arbitration descriptor for one array's memory.

    Attributes mirror the descriptor row: ``rd``/``wr`` are the
    per-external-cycle datapath budgets (multipump folded in), ``slots``
    the shared port-slot budget (binding for multipump only),
    ``n_banks`` the internal bank count (banked / remap), ``levels`` the
    NTX read-tree height ``k``, ``n_leaves`` = ``3**k`` leaves per tree,
    ``tree_depth`` the words per tree (full depth for h_ntx, the half
    for b/hb), ``half`` the top-level split point, ``sub`` the leaf
    sub-banking factor, and ``max_failed`` the deferral-scan cap.
    """

    kind: int
    rd: int
    wr: int
    slots: int
    n_banks: int
    depth: int
    levels: int
    half: int
    sub: int
    max_failed: int
    n_leaves: int
    tree_depth: int
    write_broadcast: int        # LVT: replicas each write lands in (cost)
    clock_ratio: int            # multipump: internal clock multiple

    def row(self) -> list[int]:
        """Descriptor row in the ``F_*`` layout."""
        out = [0] * N_FIELDS
        out[F_KIND] = self.kind
        out[F_RD] = self.rd
        out[F_WR] = self.wr
        out[F_SLOTS] = self.slots
        out[F_NBANKS] = self.n_banks
        out[F_DEPTH] = self.depth
        out[F_LEVELS] = self.levels
        out[F_HALF] = self.half
        out[F_SUB] = self.sub
        out[F_MAXFAIL] = self.max_failed
        out[F_CONFIGURED] = 1
        out[F_NLEAVES] = self.n_leaves
        out[F_TREE_DEPTH] = self.tree_depth
        return out


def compile_spec(spec: AMMSpec, ports_per_bank: int = 2) -> ArbDescriptor:
    """Compile one memory design into its arbitration descriptor."""
    kind = KIND_IDS[spec.kind]
    rd, wr = spec.n_read, spec.n_write
    k = spec.read_tree_levels
    clock_ratio = 2 if kind == KIND_MULTIPUMP else 1
    slots = (ports_per_bank * clock_ratio if kind == KIND_MULTIPUMP
             else rd + wr)
    n_banks = 1
    levels = half = 0
    n_leaves = tree_depth = 0
    sub = 1
    if kind == KIND_BANKED:
        n_banks = spec.n_banks
    elif kind == KIND_REMAP:
        n_banks = spec.n_write + 1
    elif kind == KIND_H_NTX:
        levels, n_leaves, tree_depth = k, 3 ** k, spec.depth
        sub = max(spec.n_banks, 1)
    elif kind in (KIND_B_NTX, KIND_HB_NTX):
        levels = k if kind == KIND_HB_NTX else 0
        n_leaves, tree_depth = 3 ** levels, spec.depth // 2
        half = spec.depth // 2
        sub = max(spec.n_banks, 1)
    # deferral-scan cap: seed formula for seed kinds (goldens), scaled to
    # the internal structure for the new ones
    if kind in _NTX_KINDS:
        trees = 1 if kind == KIND_H_NTX else 3
        max_failed = 4 * trees * n_leaves * sub * ports_per_bank + 8
    elif kind == KIND_REMAP:
        max_failed = 4 * n_banks * ports_per_bank + 8
    else:
        max_failed = 4 * spec.n_banks * ports_per_bank + 8
    return ArbDescriptor(
        kind=kind, rd=rd, wr=wr, slots=slots, n_banks=n_banks,
        depth=spec.depth, levels=levels, half=half, sub=sub,
        max_failed=max_failed, n_leaves=n_leaves, tree_depth=tree_depth,
        write_broadcast=spec.n_read if kind == KIND_LVT else 1,
        clock_ratio=clock_ratio,
    )


# ----------------------------------------------------------------------
# NTX leaf-path tables (numpy mirror of replay.h_tables)
# ----------------------------------------------------------------------
@lru_cache(maxsize=None)
def ntx_tables(tree_depth: int, levels: int):
    """``(direct, offset, parity)`` leaf-path tables for one tree.

    Same construction as ``core/amm/replay.h_tables``, numpy-only:
    ``direct[a]`` is the leaf the direct read path
    lands in, ``offset[a]`` the word offset inside every path leaf, and
    ``parity[a]`` the ``2**k`` leaves whose XOR reconstructs the word.
    """
    k = levels
    addrs = np.arange(tree_depth, dtype=np.int64)
    off = addrs.copy()
    bits = np.zeros((tree_depth, k), np.int64)
    cur = tree_depth
    for lvl in range(k):
        half = cur // 2
        hi = (off >= half).astype(np.int64)
        bits[:, lvl] = hi
        off -= hi * half
        cur = half
    w3 = 3 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    direct = (bits @ w3) if k else np.zeros(tree_depth, np.int64)
    n_paths = 1 << k
    parity = np.zeros((tree_depth, n_paths), np.int64)
    for j in range(n_paths):
        c = np.asarray([(j >> (k - 1 - lvl)) & 1 for lvl in range(k)],
                       np.int64)
        parity[:, j] = (np.where(c, 2, 1 - bits) @ w3) if k else 0
    return (direct.astype(np.int64), off.astype(np.int64), parity)


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# scheduler glue
# ----------------------------------------------------------------------
def compile_descriptors(mem: "dict[int, AMMSpec]", n_arrays: int,
                        ports_per_bank: int) -> "list[ArbDescriptor | None]":
    """Per-array descriptors (``None`` where no spec is configured)."""
    out: "list[ArbDescriptor | None]" = [None] * n_arrays
    for aid in range(n_arrays):
        spec = mem.get(aid)
        if spec is not None:
            out[aid] = compile_spec(spec, ports_per_bank)
    return out


def descriptor_matrix(descs: "list[ArbDescriptor | None]") -> np.ndarray:
    """``[n_arrays, N_FIELDS]`` int64 descriptor matrix."""
    n = max(len(descs), 1)
    mat = np.zeros((n, N_FIELDS), np.int64)
    for aid, d in enumerate(descs):
        if d is not None:
            mat[aid] = d.row()
    return np.ascontiguousarray(mat)


# ----------------------------------------------------------------------
# device-tensor export (batched timing backend)
# ----------------------------------------------------------------------
def device_limits(descs: "list[ArbDescriptor | None]",
                  ) -> tuple[int, int, int, int, int]:
    """Fixed-shape bounds one design's descriptors need on device.

    Returns ``(scan_slots, key_space, bank_slots, table_depth,
    parity_paths)``:

    * ``scan_slots`` — max candidates one array's per-cycle deferral
      scan can pop: every pop either issues (``rd + wr`` cap) or defers
      (``max_failed`` cap), so the scan never looks further;
    * ``key_space`` — NTX (tree, leaf, sub-bank) port-key ids,
      ``3 * n_leaves * sub``;
    * ``bank_slots`` — banked/remap per-cycle bank-usage counters;
    * ``table_depth`` — words addressed by per-word state (NTX path
      tables are per ``tree_depth`` word, the remap live map per
      ``depth`` word);
    * ``parity_paths`` — widest NTX parity fan-out ``2**levels``.
    """
    slots = keys = banks = depth = paths = 0
    for d in descs:
        if d is None:
            continue
        slots = max(slots, d.rd + d.wr + d.max_failed)
        banks = max(banks, d.n_banks)
        if d.kind in _NTX_KINDS:
            keys = max(keys, 3 * d.n_leaves * d.sub)
            depth = max(depth, d.tree_depth)
            paths = max(paths, 1 << d.levels)
        elif d.kind == KIND_REMAP:
            depth = max(depth, d.depth)
    return slots, keys, banks, depth, paths


def descriptor_device_tables(
    descs: "list[ArbDescriptor | None]", n_arrays: int, table_depth: int,
    parity_paths: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded per-array NTX leaf-path tables for the batched backend.

    Returns ``(direct, offset, parity)`` of shapes ``[n_arrays,
    table_depth]`` / ``[n_arrays, table_depth, parity_paths]`` (int32,
    zero where an array is not an NTX kind or beyond its tree depth) —
    the same :func:`ntx_tables` geometry both reference loops use.
    """
    a = max(n_arrays, 1)
    d_pad = max(table_depth, 1)
    p_pad = max(parity_paths, 1)
    direct = np.zeros((a, d_pad), np.int32)
    offset = np.zeros((a, d_pad), np.int32)
    parity = np.zeros((a, d_pad, p_pad), np.int32)
    for aid, d in enumerate(descs):
        if d is None or d.kind not in _NTX_KINDS:
            continue
        dr, off, par = ntx_tables(d.tree_depth, d.levels)
        direct[aid, :d.tree_depth] = dr
        offset[aid, :d.tree_depth] = off
        parity[aid, :d.tree_depth, :par.shape[1]] = par
    return direct, offset, parity
