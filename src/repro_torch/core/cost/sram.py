"""CACTI-like analytical SRAM macro model @ 45nm (paper III-A).

The paper synthesizes AMM read/write-path logic in Synopsys DC at UMC
45nm and uses CACTI for the SRAM macros.  Neither tool ships here, so we
use an analytical model with constants calibrated against published
CACTI 6.5 45nm ITRS-HP numbers for small scratchpad macros (1KB-256KB).
Calibration anchors (CACTI 6.5, 45nm, 1 bank, RW port):

    size    access(ns)  energy/rd(pJ)  area(mm^2)  leakage(mW)
    4KB     ~0.45       ~5.5           ~0.022      ~1.8
    32KB    ~0.78       ~12.9          ~0.121      ~11.6
    256KB   ~1.42       ~33.1          ~0.900      ~86.4

The model interpolates with the usual sqrt/log structure:
  access ~ a0 + a1*sqrt(bits)      (wordline/bitline RC)
  energy ~ e0 + e1*sqrt(bits)      (bitline swing dominates)
  area   ~ bitcell*bits*portf + periphery*sqrt(bits)
  leak   ~ l1*bits
Port scaling: a second independent port roughly doubles bitcell area
(6T->dual-ported 8T) and adds wordline load (x1.25 access, x1.4 energy).
True multiport beyond 2 ports is exactly what EDA flows do NOT offer
(paper I) — ``sram_macro`` therefore rejects ports > 2; multi-ported
behaviour must be composed algorithmically (see compose.py).
"""
from __future__ import annotations

import dataclasses
import math

# Calibrated constants (45nm).
_BITCELL_UM2 = {1: 0.342, 2: 0.647}       # 6T vs 8T-ish dual port
_AREA_PERIPH_UM2_PER_SQRT_BIT = 28.0
_ACCESS_NS_BASE = {1: 0.28, 2: 0.35}
_ACCESS_NS_PER_SQRT_BIT = 0.00082
_ENERGY_PJ_BASE = {1: 1.9, 2: 2.7}
_ENERGY_PJ_PER_SQRT_BIT = 0.0218
_LEAK_MW_PER_BIT = 3.3e-4


@dataclasses.dataclass(frozen=True)
class MacroCost:
    area_mm2: float
    access_ns: float
    energy_rd_pj: float
    energy_wr_pj: float
    leakage_mw: float
    bits: int

    def scaled(self, copies: int) -> "MacroCost":
        return MacroCost(
            self.area_mm2 * copies,
            self.access_ns,
            self.energy_rd_pj,
            self.energy_wr_pj,
            self.leakage_mw * copies,
            self.bits * copies,
        )


def sram_macro(depth: int, width: int, ports: int = 1) -> MacroCost:
    """Cost of one SRAM macro of ``depth`` words x ``width`` bits.

    ports=1: single RW port; ports=2: true dual port (1R1W or 2RW) —
    the limit of vendor memory-compiler support the paper builds on.
    """
    if ports not in (1, 2):
        raise ValueError(
            "no EDA support for true multiport SRAM beyond 2 ports "
            "(paper section I) — compose an AMM instead"
        )
    bits = depth * width
    if bits <= 0:
        raise ValueError("empty macro")
    sq = math.sqrt(bits)
    area_um2 = _BITCELL_UM2[ports] * bits + _AREA_PERIPH_UM2_PER_SQRT_BIT * sq
    access = _ACCESS_NS_BASE[ports] + _ACCESS_NS_PER_SQRT_BIT * sq
    e_rd = _ENERGY_PJ_BASE[ports] + _ENERGY_PJ_PER_SQRT_BIT * sq
    return MacroCost(
        area_mm2=area_um2 * 1e-6,
        access_ns=access,
        energy_rd_pj=e_rd,
        energy_wr_pj=e_rd * 1.12,  # write drivers swing full rail
        leakage_mw=_LEAK_MW_PER_BIT * bits,
        bits=bits,
    )
