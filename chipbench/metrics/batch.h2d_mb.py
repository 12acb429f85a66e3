"""``batch.h2d_mb``: the MB a sweep copies to the card: the program's
counter ``batch.h2d_bytes`` (the bytes of the arrays ``lane_outputs``
moves to the device: descriptor rows, per-word NTX tables, the trace's
views) over its count of sweeps ``dse.sweeps`` (``repro_torch.
tracing``).  Every sweep of a run, the warm one included, copies the
same arrays, so the ratio is each sweep's.  Read from runs whose window
the profiler traced on the card; nothing where the program keeps no
such counter."""


def read(r):
    if not r.device:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    counts = tracing.counts()
    if not counts.get("dse.sweeps") or "batch.h2d_bytes" not in counts:
        return None
    return counts["batch.h2d_bytes"] / 1e6 / counts["dse.sweeps"]
