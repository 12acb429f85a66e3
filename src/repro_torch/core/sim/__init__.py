"""Cycle-accurate scheduling of benchmark traces under memory designs.

- ``trace``         — the dynamic trace (struct of arrays + CSR preds)
- ``prepared``      — one-time per-trace analysis and its padded device
  views
- ``arbiter``       — per-design arbitration descriptors and the NTX
  leaf-path geometry (``ntx_tables``)
- ``events``        — the per-node issue-event log
- ``scheduler``     — ``ScheduleConfig``/``ScheduleResult``,
  ``schedule`` (one design), ``schedule_events`` (with its log) and
  ``schedule_batch`` (many, with the pruned sweep's front cap)
- ``batched_cycle`` — the batched timing backend: every design lane of
  a grid in one ``cycle_lanes`` kernel launch (up to ``BATCH_LANES``
  lanes a launch), and the front cap's rule (``front_capped``,
  ``front_eligible``, ``schedule_front``)
"""
from repro_torch.core.sim.arbiter import (STALL_KEYS, ArbDescriptor,
                                          compile_spec, ntx_tables)
from repro_torch.core.sim.events import (PATH_BROADCAST, PATH_COMPUTE,
                                         PATH_DIRECT, PATH_NAMES,
                                         PATH_PAIR_RMW, PATH_PARITY,
                                         PATH_STEERED, EventLog)
from repro_torch.core.sim.prepared import (PreparedTrace, prepare_trace,
                                           trace_fingerprint)
from repro_torch.core.sim.scheduler import (ScheduleConfig, ScheduleResult,
                                            schedule, schedule_events)
from repro_torch.core.sim.trace import (FADD, FDIV, FMUL, IADD, ICMP, IMUL,
                                        LOAD, LOGIC, STORE, Trace,
                                        TraceBuilder)

__all__ = [
    "Trace", "TraceBuilder", "schedule", "ScheduleConfig", "ScheduleResult",
    "schedule_events", "EventLog", "STALL_KEYS",
    "PATH_COMPUTE", "PATH_DIRECT", "PATH_PARITY", "PATH_STEERED",
    "PATH_PAIR_RMW", "PATH_BROADCAST", "PATH_NAMES",
    "ArbDescriptor", "compile_spec", "ntx_tables",
    "PreparedTrace", "prepare_trace", "trace_fingerprint",
    "LOAD", "STORE", "FADD", "FMUL", "FDIV", "IADD", "IMUL", "ICMP", "LOGIC",
]
