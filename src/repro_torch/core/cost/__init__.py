from repro_torch.core.cost.compose import (FU_AREA_MM2, FU_LEAK_MW,
                                           FU_POWER_MW, MemoryCost,
                                           memory_cost)
from repro_torch.core.cost.logic import LogicCost
from repro_torch.core.cost.sram import MacroCost, sram_macro

__all__ = [
    "MemoryCost", "memory_cost", "MacroCost", "sram_macro", "LogicCost",
    "FU_AREA_MM2", "FU_POWER_MW", "FU_LEAK_MW",
]
