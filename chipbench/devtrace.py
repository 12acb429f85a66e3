"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer metrics and the breakdown read: the device's busy time, each
device op's time and count, and the device's idle gaps labelled by what
the host was doing.

The trace is the profiler's Chrome-trace export: device work is in the
events of categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, the
host's in ``cpu_op`` and ``user_annotation`` (the benchmark's own
``record_function`` spans).  Times are in microseconds on one clock.
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def _merged(intervals: "list[tuple[float, float]]"):
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(path: str, window_span: str) -> dict:
    """Summary of the trace at ``path``.  The window runs from the first
    host span named ``window_span`` to the end of the last one."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == window_span]
    if not spans:
        return {}
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and lo <= float(e["ts"]) <= hi]
    ops: dict = defaultdict(lambda: [0.0, 0])
    for e in dev:
        ops[e["name"]][0] += float(e["dur"]) * 1e-6
        ops[e["name"]][1] += 1
    busy = _merged([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                         hi)) for e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    host = [e for e in events if e.get("cat") in HOST_CATS]
    h_start = np.array([float(e["ts"]) for e in host])
    h_end = h_start + np.array([float(e["dur"]) for e in host])
    h_dur = h_end - h_start
    gaps: dict = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        inside = (h_start <= mid) & (h_end >= mid)
        if inside.any():
            idx = np.flatnonzero(inside)
            label = host[idx[np.argmin(h_dur[idx])]]["name"]
        else:
            label = "(no host span)"
        gaps[label] += (e - s) * 1e-6
    return {"busy_s": busy_s, "trace_window_s": (hi - lo) * 1e-6,
            "ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "gaps": dict(gaps)}


def kernel_seconds(summary: dict, fragment: str) -> "tuple[float, int]":
    """Device seconds and launches of the ops whose name holds
    ``fragment``."""
    s, n = 0.0, 0
    for name, (sec, cnt) in summary.get("ops", {}).items():
        if fragment in name:
            s += sec
            n += cnt
    return s, n


def breakdown(summary: dict) -> dict:
    """The ten device ops that took most time and the ten longest idle
    gaps by what the host was doing, each ``[name, seconds]``."""
    ops = sorted(((k, v[0]) for k, v in summary.get("ops", {}).items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.get("gaps", {}).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
