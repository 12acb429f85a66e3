"""Design-space exploration: the design templates, the costed sweep
over ``designs x unrolls`` on the batched timing backend
(:mod:`repro_torch.core.dse.sweep`) and its Pareto fronts
(:mod:`repro_torch.core.dse.pareto`)."""
from repro_torch.core.dse.pareto import (cost_at_time, design_space_expansion,
                                         pareto_front)
from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                        DesignPoint, DSEPoint, sweep_batched)

__all__ = ["DesignPoint", "DEFAULT_DESIGNS", "DEFAULT_UNROLLS", "DSEPoint",
           "sweep_batched", "pareto_front", "cost_at_time",
           "design_space_expansion"]
