"""Design-space exploration: the design templates, the costed sweep
over ``designs x unrolls`` on the batched timing backend
(:mod:`repro_torch.core.dse.sweep`: ``sweep``, ``evaluate_point``,
``evaluate_points`` with the pruned sweep's front cap, which the batch
layer :mod:`repro_torch.core.sim.batched_cycle` applies), the cached
sweep runner and its CLI (:mod:`repro_torch.core.dse.runner`) with its
surrogate pruning (:mod:`repro_torch.core.dse.surrogate`), the Pareto
fronts
(:mod:`repro_torch.core.dse.pareto`) and the Fig-5 performance ratio and
rank correlation (:mod:`repro_torch.core.dse.ratio`)."""
from repro_torch.core.dse.pareto import (cost_at_time, design_space_expansion,
                                         pareto_front)
from repro_torch.core.dse.ratio import performance_ratio, spearman_rho
from repro_torch.core.dse.runner import (SweepCache, point_key, run_sweep,
                                         run_sweep_bench)
from repro_torch.core.dse.surrogate import (DEFAULT_MARGIN, grid_predictions,
                                            predict, select_band)
from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                        DesignPoint, DSEPoint,
                                        evaluate_point, sweep)

__all__ = ["DesignPoint", "DEFAULT_DESIGNS", "DEFAULT_UNROLLS", "DSEPoint",
           "sweep", "evaluate_point",
           "run_sweep", "run_sweep_bench", "SweepCache", "point_key",
           "grid_predictions", "select_band", "predict", "DEFAULT_MARGIN",
           "pareto_front", "cost_at_time", "design_space_expansion",
           "performance_ratio", "spearman_rho"]
