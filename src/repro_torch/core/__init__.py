"""Core library: the paper's memory designs, their functional models,
their fault tolerance, their costs and the locality metric the planner
scores streams with.

- ``repro_torch.core.amm``      — AMM design specifications, the per-step
  models (``make_amm``) and the whole-trace replay engine
  (``core.amm.replay``, batched over design instances, fault injection)
- ``repro_torch.core.fault``    — seeded fault campaigns and the
  resilience record of each design
- ``repro_torch.core.dse``      — the DSE design templates (the sweep
  itself comes with the timing backend)
- ``repro_torch.core.cost``     — CACTI-like SRAM + logic cost models
- ``repro_torch.core.locality`` — Weinberg spatial-locality metric
"""
