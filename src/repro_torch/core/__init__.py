"""Core library: the paper's memory designs, their functional models,
their fault tolerance, their timing under each design, their costs and
the locality metric.

- ``repro_torch.core.amm``      — AMM design specifications, the per-step
  models (``make_amm``) and the whole-trace replay engine
  (``core.amm.replay``, batched over design instances, fault injection)
- ``repro_torch.core.fault``    — seeded fault campaigns and the
  resilience record of each design
- ``repro_torch.core.dse``      — the DSE design templates, the costed
  sweep on the batched timing backend and its Pareto fronts
- ``repro_torch.core.sim``      — traces, their prepared analysis and the
  batched timing backend (the cycle-accurate list scheduler)
- ``repro_torch.core.verify``   — the independent legality checker of
  the backend's event logs
- ``repro_torch.core.bench``    — the 15 benchmark traces
- ``repro_torch.core.cost``     — CACTI-like SRAM + logic cost models
- ``repro_torch.core.locality`` — Weinberg spatial-locality metric
"""
from repro_torch.core.amm import AMM_KINDS, AMMSpec, make_amm
from repro_torch.core.locality import spatial_locality_np, trace_locality

__all__ = [
    "AMMSpec", "AMM_KINDS", "make_amm",
    "spatial_locality_np", "trace_locality",
]
