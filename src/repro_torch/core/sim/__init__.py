"""Cycle-accurate scheduling of benchmark traces under memory designs.

- ``trace``         — the dynamic trace (struct of arrays + CSR preds)
- ``prepared``      — one-time per-trace analysis and its padded device
  views
- ``arbiter``       — per-design arbitration descriptors and NTX
  leaf-path tables
- ``events``        — the per-node issue-event log
- ``scheduler``     — ``ScheduleConfig``/``ScheduleResult`` and
  ``schedule`` (one design)
- ``batched_cycle`` — the batched timing backend: every design lane of
  a grid in one ``cycle_lanes`` kernel launch
"""
from repro_torch.core.sim.events import EventLog
from repro_torch.core.sim.prepared import PreparedTrace, prepare_trace
from repro_torch.core.sim.scheduler import (ScheduleConfig, ScheduleResult,
                                            schedule)
from repro_torch.core.sim.trace import Trace, TraceBuilder

__all__ = ["EventLog", "PreparedTrace", "ScheduleConfig", "ScheduleResult",
           "Trace", "TraceBuilder", "prepare_trace", "schedule"]
