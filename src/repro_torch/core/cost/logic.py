"""Synthesized read/write-path logic cost tables @ 45nm (paper III-A).

Stand-ins for the paper's Synopsys DC @ UMC 45nm synthesis of the AMM
glue logic, tabulated per standard cell (typical 45nm educational/UMC
library values) and composed per design.  All functions return
(area_mm2, delay_ns, energy_pj_per_op, leakage_mw).
"""
from __future__ import annotations

import dataclasses
import math

# Per-cell constants, 45nm typical corner.
_XOR2_AREA_UM2 = 1.12
_XOR2_DELAY_NS = 0.042
_XOR2_ENERGY_FJ = 1.9
_MUX2_AREA_UM2 = 1.41
_MUX2_DELAY_NS = 0.038
_MUX2_ENERGY_FJ = 1.5
_DFF_AREA_UM2 = 4.52
_DFF_ENERGY_FJ = 3.1
_CMP_BIT_AREA_UM2 = 1.9
_LEAK_NW_PER_UM2 = 18.0


@dataclasses.dataclass(frozen=True)
class LogicCost:
    area_mm2: float
    delay_ns: float
    energy_pj: float
    leakage_mw: float

    def __add__(self, o: "LogicCost") -> "LogicCost":
        return LogicCost(
            self.area_mm2 + o.area_mm2,
            max(self.delay_ns, o.delay_ns),
            self.energy_pj + o.energy_pj,
            self.leakage_mw + o.leakage_mw,
        )


ZERO = LogicCost(0.0, 0.0, 0.0, 0.0)


def _mk(area_um2: float, delay_ns: float, energy_fj: float) -> LogicCost:
    return LogicCost(
        area_mm2=area_um2 * 1e-6,
        delay_ns=delay_ns,
        energy_pj=energy_fj * 1e-3,
        leakage_mw=area_um2 * _LEAK_NW_PER_UM2 * 1e-6,
    )


def xor_stage(width: int, fanin: int = 2) -> LogicCost:
    """XOR-reduce of ``fanin`` words of ``width`` bits (tree)."""
    n_gates = max(fanin - 1, 0) * width
    depth = max(1, math.ceil(math.log2(max(fanin, 2))))
    return _mk(_XOR2_AREA_UM2 * n_gates, _XOR2_DELAY_NS * depth,
               _XOR2_ENERGY_FJ * n_gates)


def mux_tree(width: int, ways: int) -> LogicCost:
    n_gates = max(ways - 1, 0) * width
    depth = max(1, math.ceil(math.log2(max(ways, 2))))
    return _mk(_MUX2_AREA_UM2 * n_gates, _MUX2_DELAY_NS * depth,
               _MUX2_ENERGY_FJ * n_gates)


def register_table(entries: int, bits_per_entry: int) -> LogicCost:
    """LVT / remap table held in flops (paper II-B)."""
    n = entries * bits_per_entry
    # table access energy: only one entry's flops toggle + read mux
    c = _mk(_DFF_AREA_UM2 * n, 0.12, _DFF_ENERGY_FJ * bits_per_entry)
    return c + mux_tree(bits_per_entry, max(2, entries // 64))


def bank_decoder(n_banks: int, addr_bits: int) -> LogicCost:
    n = max(1, n_banks) * addr_bits
    return _mk(_CMP_BIT_AREA_UM2 * n, 0.05 + 0.01 * math.log2(max(n_banks, 2)),
               1.2 * n)
