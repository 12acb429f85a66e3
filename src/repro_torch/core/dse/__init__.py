"""Design-space exploration: the design templates, the costed sweep
over ``designs x unrolls`` on the batched timing backend
(:mod:`repro_torch.core.dse.sweep`), the cached sweep runner and its CLI
(:mod:`repro_torch.core.dse.runner`), the Pareto fronts
(:mod:`repro_torch.core.dse.pareto`) and the Fig-5 performance ratio and
rank correlation (:mod:`repro_torch.core.dse.ratio`)."""
from repro_torch.core.dse.pareto import (cost_at_time, design_space_expansion,
                                         pareto_front)
from repro_torch.core.dse.ratio import performance_ratio, spearman_rho
from repro_torch.core.dse.runner import (SweepCache, point_key, run_sweep,
                                         run_sweep_bench)
from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                        DesignPoint, DSEPoint,
                                        evaluate_batched, sweep_batched)

__all__ = ["DesignPoint", "DEFAULT_DESIGNS", "DEFAULT_UNROLLS", "DSEPoint",
           "evaluate_batched", "sweep_batched",
           "run_sweep", "run_sweep_bench", "SweepCache", "point_key",
           "pareto_front", "cost_at_time", "design_space_expansion",
           "performance_ratio", "spearman_rho"]
