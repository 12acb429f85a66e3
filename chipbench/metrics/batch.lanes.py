"""``batch.lanes``: the lanes a sweep hands to ``cycle_lanes``: the
program's counter ``batch.lanes`` over its count of sweeps
``dse.sweeps`` (``repro_torch.tracing``).  Every sweep of a run, the
warm one included, runs the cell's grid or band, so the ratio is each
sweep's count.  Read from runs whose window the profiler traced on the
card; nothing where the program keeps no counters."""


def read(r):
    if not r.device:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    counts = tracing.counts()
    if not counts.get("dse.sweeps"):
        return None
    return counts.get("batch.lanes", 0) / counts["dse.sweeps"]
