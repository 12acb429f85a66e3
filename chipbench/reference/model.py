"""The reference's memory designs, arbitration descriptors, cost model
and Pareto reduction: the paper's formulas written out once more for
the benchmark, so that ``correct`` is decided by code the program under
test does not share.

A design point is ``(kind, n_read, n_write, n_banks)`` applied to every
array of a trace, times an unroll factor that scales the functional
units.  Costs follow the paper's 45 nm analytic SRAM and glue-logic
models (CACTI-like macros, tabulated standard cells); the arithmetic
runs in float64 in the same order as the paper's reproduction, so sound
programs agree to the last bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from chipbench.reference.trace import FU_ORDER

AMM_KINDS = ("h_ntx_rd", "b_ntx_wr", "hb_ntx", "lvt", "remap")

# base functional-unit mix at unroll 1
BASE_FU = {"fadd": 1, "fmul": 1, "fdiv": 1, "iadd": 2, "imul": 1,
           "icmp": 2, "logic": 4}
MIN_CYCLE_NS = 0.9

# arbitration kinds
K_IDEAL, K_BANKED, K_MULTIPUMP = 0, 1, 2
K_H_NTX, K_B_NTX, K_HB_NTX = 3, 4, 5
K_LVT, K_REMAP = 6, 7
KIND_IDS = {"ideal": K_IDEAL, "banked": K_BANKED, "multipump": K_MULTIPUMP,
            "h_ntx_rd": K_H_NTX, "b_ntx_wr": K_B_NTX, "hb_ntx": K_HB_NTX,
            "lvt": K_LVT, "remap": K_REMAP}
NTX = (K_H_NTX, K_B_NTX, K_HB_NTX)


def label(kind: str, n_read: int, n_write: int, n_banks: int) -> str:
    """A design's name as sweeps report it (``banked4``,
    ``hb_ntx-4R2W-b4``)."""
    if kind == "banked":
        return f"banked{n_banks}"
    base = f"{kind}-{n_read}R{n_write}W"
    return f"{base}-b{n_banks}" if kind in AMM_KINDS and n_banks > 1 \
        else base


# ----------------------------------------------------------------------
# one array's memory
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mem:
    kind: str
    n_read: int
    n_write: int
    depth: int
    width: int
    n_banks: int

    @property
    def levels(self) -> int:
        return int(math.log2(self.n_read)) if self.n_read > 1 else 0

    def leaf_banks(self) -> "tuple[int, int]":
        """(leaf macros, words in each)."""
        n, k = self.depth, self.levels
        if self.kind == "h_ntx_rd":
            return 3 ** k, n // (2 ** k)
        if self.kind == "b_ntx_wr":
            return 3, n // 2
        if self.kind == "hb_ntx":
            return 3 * 3 ** k, n // (2 * 2 ** k)
        if self.kind == "lvt":
            return self.n_write * max(self.n_read, 1), n
        if self.kind == "remap":
            return self.n_write + 1, n
        if self.kind == "banked":
            return self.n_banks, -(-n // self.n_banks)
        return 1, n

    def table_bits(self) -> int:
        if self.kind == "lvt":
            return self.depth * max(
                1, math.ceil(math.log2(max(self.n_write, 2))))
        if self.kind == "remap":
            return self.depth * max(
                1, math.ceil(math.log2(self.n_write + 1)))
        return 0


def array_mem(kind: str, n_read: int, n_write: int, n_banks: int,
              depth: int, width_bits: int) -> Mem:
    """The memory a design gives one array of ``depth`` words."""
    if kind == "banked":
        nb = min(n_banks, max(depth // 4, 1))
        return Mem("banked", 2 * nb, 2 * nb, depth, width_bits, nb)
    depth = max(depth, 4 * max(n_read, n_write, 1))
    sub = 1
    if kind in AMM_KINDS and n_banks > 1:
        leaf_depth = Mem(kind, n_read, n_write, depth, width_bits,
                         1).leaf_banks()[1]
        sub = min(n_banks, 1 << max(leaf_depth.bit_length() - 1, 0))
    return Mem(kind, n_read, n_write, depth, width_bits, sub)


# ----------------------------------------------------------------------
# arbitration descriptor of one array's memory
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Arb:
    kind: int
    rd: int                 # reads a cycle
    wr: int                 # writes a cycle
    slots: int              # accesses a cycle in all (multipump's bind)
    n_banks: int            # banked banks, remap banks
    depth: int
    levels: int             # NTX read-tree height k
    half: int               # B/HB-NTX split point
    sub: int                # leaf sub-banks
    max_failed: int         # deferral-scan cap a cycle
    n_leaves: int
    tree_depth: int
    write_broadcast: int    # LVT replicas a write lands in


def arbitration(m: Mem, ports_per_bank: int) -> Arb:
    kind = KIND_IDS[m.kind]
    k = m.levels
    slots = ports_per_bank * 2 if kind == K_MULTIPUMP else m.n_read + m.n_write
    n_banks, levels, half, n_leaves, tree_depth, sub = 1, 0, 0, 0, 0, 1
    if kind == K_BANKED:
        n_banks = m.n_banks
    elif kind == K_REMAP:
        n_banks = m.n_write + 1
    elif kind == K_H_NTX:
        levels, n_leaves, tree_depth = k, 3 ** k, m.depth
        sub = max(m.n_banks, 1)
    elif kind in (K_B_NTX, K_HB_NTX):
        levels = k if kind == K_HB_NTX else 0
        n_leaves, tree_depth = 3 ** levels, m.depth // 2
        half = m.depth // 2
        sub = max(m.n_banks, 1)
    if kind in NTX:
        trees = 1 if kind == K_H_NTX else 3
        max_failed = 4 * trees * n_leaves * sub * ports_per_bank + 8
    elif kind == K_REMAP:
        max_failed = 4 * n_banks * ports_per_bank + 8
    else:
        max_failed = 4 * m.n_banks * ports_per_bank + 8
    return Arb(kind=kind, rd=m.n_read, wr=m.n_write, slots=slots,
               n_banks=n_banks, depth=m.depth, levels=levels, half=half,
               sub=sub, max_failed=max_failed, n_leaves=n_leaves,
               tree_depth=tree_depth,
               write_broadcast=m.n_read if kind == K_LVT else 1)


def ntx_paths(tree_depth: int, levels: int):
    """``(direct, offset, parity)`` for one NTX read tree: the leaf a
    word's direct read lands in, the word's offset inside every leaf of
    its paths, and the ``2**k`` leaves whose XOR rebuilds it."""
    k = levels
    off = np.arange(tree_depth, dtype=np.int64)
    bits = np.zeros((tree_depth, k), np.int64)
    cur = tree_depth
    for lvl in range(k):
        h = cur // 2
        hi = (off >= h).astype(np.int64)
        bits[:, lvl] = hi
        off -= hi * h
        cur = h
    w3 = 3 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    direct = bits @ w3 if k else np.zeros(tree_depth, np.int64)
    parity = np.zeros((tree_depth, 1 << k), np.int64)
    for j in range(1 << k):
        c = np.asarray([(j >> (k - 1 - lvl)) & 1 for lvl in range(k)],
                       np.int64)
        parity[:, j] = np.where(c, 2, 1 - bits) @ w3 if k else 0
    return direct, off, parity


# ----------------------------------------------------------------------
# costs (45 nm)
# ----------------------------------------------------------------------
_BITCELL_UM2 = {1: 0.342, 2: 0.647}
_PERIPH_UM2_PER_SQRT_BIT = 28.0
_ACCESS_NS = {1: 0.28, 2: 0.35}
_ACCESS_NS_PER_SQRT_BIT = 0.00082
_ENERGY_PJ = {1: 1.9, 2: 2.7}
_ENERGY_PJ_PER_SQRT_BIT = 0.0218
_LEAK_MW_PER_BIT = 3.3e-4

_XOR2 = (1.12, 0.042, 1.9)          # area um2, delay ns, energy fJ
_MUX2 = (1.41, 0.038, 1.5)
_DFF_AREA_UM2, _DFF_ENERGY_FJ = 4.52, 3.1
_CMP_BIT_AREA_UM2 = 1.9
_LEAK_NW_PER_UM2 = 18.0

FU_AREA_MM2 = {"fadd": 0.0031, "fmul": 0.0117, "fdiv": 0.0220,
               "iadd": 0.00028, "imul": 0.0019, "icmp": 0.00011,
               "logic": 0.00007}
FU_POWER_MW = {"fadd": 1.9, "fmul": 6.3, "fdiv": 9.8, "iadd": 0.14,
               "imul": 1.2, "icmp": 0.06, "logic": 0.03}
FU_LEAK_MW = {k: v * 0.08 for k, v in FU_POWER_MW.items()}


@dataclasses.dataclass(frozen=True)
class Macro:
    area_mm2: float
    access_ns: float
    energy_rd_pj: float
    energy_wr_pj: float
    leakage_mw: float

    def times(self, copies: int) -> "Macro":
        return Macro(self.area_mm2 * copies, self.access_ns,
                     self.energy_rd_pj, self.energy_wr_pj,
                     self.leakage_mw * copies)


def macro(depth: int, width: int, ports: int) -> Macro:
    bits = depth * width
    sq = math.sqrt(bits)
    area_um2 = _BITCELL_UM2[ports] * bits + _PERIPH_UM2_PER_SQRT_BIT * sq
    e_rd = _ENERGY_PJ[ports] + _ENERGY_PJ_PER_SQRT_BIT * sq
    return Macro(area_mm2=area_um2 * 1e-6,
                 access_ns=_ACCESS_NS[ports] + _ACCESS_NS_PER_SQRT_BIT * sq,
                 energy_rd_pj=e_rd, energy_wr_pj=e_rd * 1.12,
                 leakage_mw=_LEAK_MW_PER_BIT * bits)


@dataclasses.dataclass(frozen=True)
class Logic:
    area_mm2: float
    delay_ns: float
    energy_pj: float
    leakage_mw: float

    def __add__(self, o: "Logic") -> "Logic":
        return Logic(self.area_mm2 + o.area_mm2,
                     max(self.delay_ns, o.delay_ns),
                     self.energy_pj + o.energy_pj,
                     self.leakage_mw + o.leakage_mw)


def _logic(area_um2: float, delay_ns: float, energy_fj: float) -> Logic:
    return Logic(area_um2 * 1e-6, delay_ns, energy_fj * 1e-3,
                 area_um2 * _LEAK_NW_PER_UM2 * 1e-6)


def xor_stage(width: int, fanin: int) -> Logic:
    gates = max(fanin - 1, 0) * width
    depth = max(1, math.ceil(math.log2(max(fanin, 2))))
    return _logic(_XOR2[0] * gates, _XOR2[1] * depth, _XOR2[2] * gates)


def mux_tree(width: int, ways: int) -> Logic:
    gates = max(ways - 1, 0) * width
    depth = max(1, math.ceil(math.log2(max(ways, 2))))
    return _logic(_MUX2[0] * gates, _MUX2[1] * depth, _MUX2[2] * gates)


def register_table(entries: int, bits_per_entry: int) -> Logic:
    n = entries * bits_per_entry
    return _logic(_DFF_AREA_UM2 * n, 0.12,
                  _DFF_ENERGY_FJ * bits_per_entry) \
        + mux_tree(bits_per_entry, max(2, entries // 64))


def bank_decoder(n_banks: int, addr_bits: int) -> Logic:
    n = max(1, n_banks) * addr_bits
    return _logic(_CMP_BIT_AREA_UM2 * n,
                  0.05 + 0.01 * math.log2(max(n_banks, 2)), 1.2 * n)


def _addr_bits(depth: int) -> int:
    return max(1, math.ceil(math.log2(max(depth, 2))))


@dataclasses.dataclass(frozen=True)
class MemCost:
    area_mm2: float
    read_energy_pj: float
    write_energy_pj: float
    leakage_mw: float
    cycle_ns: float


def mem_cost(m: Mem) -> MemCost:
    n_banks, bank_depth = m.leaf_banks()
    width, k = m.width, m.levels
    if m.kind == "ideal":
        one = macro(m.depth, width, 2)
        pairs = max(m.n_read + m.n_write - 1, 1)
        area = one.area_mm2 * (0.55 * pairs + 0.45)
        glue = Logic(0.0, 0.0, 0.0, 0.0)
        access = one.access_ns * (1.0 + 0.15 * (pairs - 1))
        e_rd, e_wr = one.energy_rd_pj, one.energy_wr_pj
        leak = one.leakage_mw * (0.4 * pairs + 0.6)
    elif m.kind == "multipump":
        one = macro(m.depth, width, 2)
        glue = bank_decoder(2, _addr_bits(m.depth))
        area, access = one.area_mm2, one.access_ns
        e_rd, e_wr, leak = one.energy_rd_pj, one.energy_wr_pj, one.leakage_mw
    elif m.kind == "banked":
        all_banks = macro(bank_depth, width, 2).times(n_banks)
        glue = bank_decoder(n_banks, _addr_bits(m.depth)) \
            + mux_tree(width, max(n_banks, 2))
        one = macro(bank_depth, width, 2)
        area, access = all_banks.area_mm2, one.access_ns
        e_rd, e_wr = one.energy_rd_pj, one.energy_wr_pj
        leak = all_banks.leakage_mw
    elif m.kind in ("h_ntx_rd", "b_ntx_wr", "hb_ntx"):
        sub = max(m.n_banks, 1)
        one = macro(-(-bank_depth // sub), width, 2)
        all_leaves = one.times(n_banks * sub)
        area, leak = all_leaves.area_mm2, all_leaves.leakage_mw
        glue = bank_decoder(n_banks, _addr_bits(m.depth))
        glue = glue + mux_tree(width, max(2 * k, 2))
        if sub > 1:
            glue = glue + bank_decoder(sub, _addr_bits(bank_depth)) \
                + mux_tree(width, sub)
        fanin = (2 if k > 0 else 1) + (1 if m.kind != "h_ntx_rd" else 0)
        if fanin > 1:
            glue = glue + xor_stage(width, fanin)
        glue = glue + xor_stage(width, 3)
        access = one.access_ns
        rd_banks = 1 + (1 if k > 0 else 0) + (1 if m.kind != "h_ntx_rd"
                                               else 0)
        wr_banks = 2 if m.kind == "h_ntx_rd" else 3
        e_rd = one.energy_rd_pj * rd_banks
        e_wr = one.energy_wr_pj * 2 + one.energy_rd_pj * (wr_banks - 2 + 1)
    elif m.kind in ("lvt", "remap"):
        sub = max(m.n_banks, 1)
        one = macro(-(-bank_depth // sub), width, 2)
        all_leaves = one.times(n_banks * sub)
        table = register_table(m.depth,
                               max(1, m.table_bits() // max(m.depth, 1)))
        glue = table + mux_tree(width, max(m.n_write + 1, 2)) \
            + bank_decoder(n_banks, _addr_bits(m.depth))
        if sub > 1:
            glue = glue + bank_decoder(sub, _addr_bits(bank_depth)) \
                + mux_tree(width, sub)
        area, leak = all_leaves.area_mm2, all_leaves.leakage_mw
        access = one.access_ns
        e_rd = one.energy_rd_pj + table.energy_pj
        broadcast = m.n_read if m.kind == "lvt" else 1
        e_wr = (one.energy_wr_pj * broadcast if m.kind == "lvt"
                else one.energy_wr_pj) + table.energy_pj
    else:
        raise ValueError(m.kind)
    freq = 0.5 if m.kind == "multipump" else 1.0
    return MemCost(area_mm2=area + glue.area_mm2,
                   read_energy_pj=e_rd + glue.energy_pj,
                   write_energy_pj=e_wr + glue.energy_pj,
                   leakage_mw=leak + glue.leakage_mw,
                   cycle_ns=(access + glue.delay_ns) / freq)


def static_cost(costs: "list[MemCost]", unroll: int) -> "tuple[float, float]":
    """(area_mm2, cycle_ns) of a point before any schedule."""
    cycle_ns = max([MIN_CYCLE_NS] + [c.cycle_ns for c in costs])
    area = sum(c.area_mm2 for c in costs)
    area += sum(FU_AREA_MM2[k] * v * unroll for k, v in BASE_FU.items())
    return area, cycle_ns


def point_cost(costs: "list[MemCost]", unroll: int, cycles: int,
               issued: int, loads: "list[int]", stores: "list[int]"
               ) -> dict:
    """A scheduled point's time, area and power (arrays in trace
    order)."""
    area, cycle_ns = static_cost(costs, unroll)
    time_us = cycles * cycle_ns * 1e-3
    e_pj = 0.0
    for c, nl, ns in zip(costs, loads, stores):
        e_pj += nl * c.read_energy_pj + ns * c.write_energy_pj
    p_mem = e_pj / max(time_us, 1e-9) * 1e-3
    p_leak = sum(c.leakage_mw for c in costs)
    fu_total = sum(v * unroll for v in BASE_FU.values())
    util = min(1.0, issued / max(cycles * fu_total, 1))
    p_fu = sum(FU_POWER_MW[k] * v * unroll * util + FU_LEAK_MW[k] * v * unroll
               for k, v in BASE_FU.items())
    return {"cycle_ns": cycle_ns, "time_us": time_us, "area_mm2": area,
            "power_mw": p_mem + p_leak + p_fu}


def fu_budgets(unroll: int) -> "list[int]":
    return [BASE_FU.get(name, 1) * unroll for name in FU_ORDER]


def pareto(points: "list[dict]", cost: str) -> "list[tuple[str, int]]":
    """The (design, unroll) of the points on the (time_us, ``cost``)
    front, by time: a point is on it when every point before it in
    (time, cost) order costs more."""
    front, best = [], float("inf")
    for p in sorted(points, key=lambda p: (p["time_us"], p[cost])):
        if p[cost] < best - 1e-12:
            front.append((p["design"], p["unroll"]))
            best = p[cost]
    return front
