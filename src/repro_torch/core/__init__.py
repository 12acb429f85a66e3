"""Core library: the paper's memory designs, their costs and the
locality metric the planner scores streams with.

- ``repro_torch.core.amm``      — AMM design specifications
- ``repro_torch.core.cost``     — CACTI-like SRAM + logic cost models
- ``repro_torch.core.locality`` — Weinberg spatial-locality metric
"""
