"""Compose SRAM-macro + glue-logic costs into a full AMM design cost
(paper III-A: 'By combining the synthesis results of read-path and
write-path logic, and estimation from CACTI (SRAM) we can evaluate the
overall performance and cost of an AMM design').
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.cost import logic as lg
from repro_torch.core.cost.sram import MacroCost, sram_macro


@dataclasses.dataclass(frozen=True)
class MemoryCost:
    """Whole-memory cost for one AMMSpec."""
    area_mm2: float
    read_energy_pj: float     # per read access (all banks it touches)
    write_energy_pj: float    # per write access
    leakage_mw: float
    access_ns: float          # read path: macro + decode + XOR/mux
    cycle_ns: float           # min clock period the memory sustains
    max_freq_ghz: float

    @property
    def summary(self) -> dict:
        return dataclasses.asdict(self)


def _addr_bits(depth: int) -> int:
    return max(1, math.ceil(math.log2(max(depth, 2))))


def memory_cost(spec: AMMSpec) -> MemoryCost:
    """Area / energy / latency of one memory design point."""
    n_banks, bank_depth = spec.leaf_banks()
    width = spec.width
    k = spec.read_tree_levels

    if spec.kind in ("ideal",):
        # circuit-level true multiport: not manufacturable via compilers
        # (paper I); modelled as port-scaled bitcells for reference only.
        macro = sram_macro(spec.depth, width, ports=2)
        port_pairs = max(spec.n_read + spec.n_write - 1, 1)
        area = macro.area_mm2 * (0.55 * port_pairs + 0.45)
        glue = lg.ZERO
        access = macro.access_ns * (1.0 + 0.15 * (port_pairs - 1))
        e_rd, e_wr = macro.energy_rd_pj, macro.energy_wr_pj
        leak = macro.leakage_mw * (0.4 * port_pairs + 0.6)
        rd_banks = wr_banks = 1
    elif spec.kind == "multipump":
        macro = sram_macro(spec.depth, width, ports=2)
        glue = lg.bank_decoder(2, _addr_bits(spec.depth))
        area, access = macro.area_mm2, macro.access_ns
        e_rd, e_wr, leak = macro.energy_rd_pj, macro.energy_wr_pj, macro.leakage_mw
        rd_banks = wr_banks = 1
    elif spec.kind == "banked":
        macro = sram_macro(bank_depth, width, ports=2).scaled(n_banks)
        glue = lg.bank_decoder(n_banks, _addr_bits(spec.depth)) + lg.mux_tree(
            width, max(n_banks, 2)
        )
        area, access = macro.area_mm2, sram_macro(bank_depth, width, 2).access_ns
        e_rd = sram_macro(bank_depth, width, 2).energy_rd_pj
        e_wr = sram_macro(bank_depth, width, 2).energy_wr_pj
        leak = macro.leakage_mw
        rd_banks = wr_banks = 1
    elif spec.kind in ("h_ntx_rd", "b_ntx_wr", "hb_ntx"):
        # leaf sub-banking (banking-structure axis): each of the
        # n_banks leaf structures becomes `sub` smaller interleaved
        # macros — shorter wordlines (faster access, the cycle-time
        # coupling consumed by the scheduler's cycle_ns) at the price of
        # a per-leaf decoder/mux.
        sub = max(spec.n_banks, 1)
        one = sram_macro(-(-bank_depth // sub), width, ports=2)
        macro = one.scaled(n_banks * sub)
        area, leak = macro.area_mm2, macro.leakage_mw
        # Read path: bank select mux per level + XOR with ref on conflict
        # (and B-decode XOR for the write-paired variants).
        glue = lg.bank_decoder(n_banks, _addr_bits(spec.depth))
        glue = glue + lg.mux_tree(width, max(2 * k, 2))
        if sub > 1:
            glue = glue + lg.bank_decoder(sub, _addr_bits(bank_depth)) \
                + lg.mux_tree(width, sub)
        xor_fanin_rd = (2 if k > 0 else 1) + (1 if spec.kind != "h_ntx_rd" else 0)
        if xor_fanin_rd > 1:
            glue = glue + lg.xor_stage(width, xor_fanin_rd)
        # Write path: RMW XOR dance (read-other + ref update).
        glue = glue + lg.xor_stage(width, 3)
        access = one.access_ns
        # A read touches bank+ref on the conflict path; a write touches its
        # bank + ref (+ other-bank read on the B path).
        rd_banks = 1 + (1 if k > 0 else 0) + (1 if spec.kind != "h_ntx_rd" else 0)
        wr_banks = 2 if spec.kind == "h_ntx_rd" else 3
        e_rd = one.energy_rd_pj * rd_banks
        e_wr = one.energy_wr_pj * 2 + one.energy_rd_pj * (wr_banks - 2 + 1)
    elif spec.kind in ("lvt", "remap"):
        sub = max(spec.n_banks, 1)      # leaf sub-banking (cost/freq only)
        one = sram_macro(-(-bank_depth // sub), width, ports=2)
        macro = one.scaled(n_banks * sub)
        table_bits = max(1, spec.table_bits() // max(spec.depth, 1))
        table = lg.register_table(spec.depth, table_bits)
        glue = table + lg.mux_tree(width, max(spec.n_write + 1, 2)) + \
            lg.bank_decoder(n_banks, _addr_bits(spec.depth))
        if sub > 1:
            glue = glue + lg.bank_decoder(sub, _addr_bits(bank_depth)) \
                + lg.mux_tree(width, sub)
        area, leak = macro.area_mm2, macro.leakage_mw
        access = one.access_ns
        e_rd = one.energy_rd_pj + table.energy_pj
        if spec.kind == "lvt":
            # every write broadcasts to its bank's read replicas: the
            # fan-out the reference's arbitration descriptor records
            # (repro.core.sim.arbiter.compile_spec: write_broadcast =
            # n_read for LVT)
            e_wr = one.energy_wr_pj * spec.n_read + table.energy_pj
        else:
            e_wr = one.energy_wr_pj + table.energy_pj
        rd_banks = wr_banks = 1
    else:  # pragma: no cover
        raise ValueError(spec.kind)

    area_total = area + glue.area_mm2
    leak_total = leak + glue.leakage_mw
    access_total = access + glue.delay_ns
    # Non-table AMMs operate at max frequency (paper I); multipump halves
    # the *external* frequency via frequency_factor.
    cycle = access_total / spec.frequency_factor
    return MemoryCost(
        area_mm2=area_total,
        read_energy_pj=e_rd + glue.energy_pj,
        write_energy_pj=e_wr + glue.energy_pj,
        leakage_mw=leak_total,
        access_ns=access_total,
        cycle_ns=cycle,
        max_freq_ghz=1.0 / cycle,
    )


# ----------------------------------------------------------------------
# Functional-unit costs (Aladdin-style 45nm FU library).
# ----------------------------------------------------------------------
FU_AREA_MM2 = {
    "fadd": 0.0031, "fmul": 0.0117, "fdiv": 0.0220,
    "iadd": 0.00028, "imul": 0.0019, "icmp": 0.00011, "logic": 0.00007,
}
FU_POWER_MW = {  # dynamic power at full utilization, 1 GHz
    "fadd": 1.9, "fmul": 6.3, "fdiv": 9.8,
    "iadd": 0.14, "imul": 1.2, "icmp": 0.06, "logic": 0.03,
}
FU_LEAK_MW = {k: v * 0.08 for k, v in FU_POWER_MW.items()}
