"""Spans and counters of the port's design-space sweep.

A span marks one layer's work on the host.  While a ``torch.profiler``
profile is active it is a ``record_function`` range, so it lands on the
profiler's timeline beside the device's kernels and copies, on their
clock; with no profiler active it is one shared no-op context and costs
one check.  There is no switch: run the program under the profiler to
record its spans.

    with torch.profiler.profile(activities=[...]) as prof:
        run_sweep(pt, prune="surrogate")
    prof.export_chrome_trace("sweep.json")   # holds the SPANS below

Counters are plain integers, always on, read with :func:`counts`:

* ``dse.sweeps``: calls of ``runner.run_sweep``;
* ``batch.lanes``: lanes handed to ``ops.cycle_lanes``;
* ``batch.h2d_bytes``: bytes of the arrays ``lane_outputs`` copies to
  the device;
* ``dse.front_cap.dropped``: lanes that ``batched_cycle.schedule_front``
  ran and the front cap (``batched_cycle.front_capped``) then dropped.

``core/dse/sweep.py::evaluate_points`` opens ``dse.configs`` and
``dse.fold`` once a call and ``dse.front_cap`` once a capped call; the
batch layer, ``core/sim/batched_cycle.py``, opens ``dse.fold`` once a
launch and ``dse.front_cap`` once a capped call.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch

# every span the program records, outermost first
SPANS = ("dse.sweep", "dse.rank", "dse.configs", "dse.front_cap",
         "batch.descriptors", "batch.layout", "batch.h2d", "dse.fold",
         "dse.pareto")

_OFF = contextlib.nullcontext()
_COUNTS: Counter = Counter()


def span(name: str):
    """A context that records ``name`` on an active profiler's timeline,
    and does nothing when no profiler is active."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counts() -> dict:
    """A snapshot of every counter."""
    return dict(_COUNTS)
