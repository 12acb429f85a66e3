"""``batch.tables_ms``: the host ms a sweep spends allocating and
filling the lanes' per-word NTX tables (the program's span
``batch.tables``): its counter ``batch.tables_ns`` over its count of
sweeps ``dse.sweeps`` (``repro_torch.tracing``), the mean over every
sweep of the run, the warm one included.  Read from runs whose window
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
    if not counts.get("dse.sweeps") or "batch.tables_ns" not in counts:
        return None
    return counts["batch.tables_ns"] / 1e6 / counts["dse.sweeps"]
