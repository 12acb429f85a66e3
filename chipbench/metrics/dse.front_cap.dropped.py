"""``dse.front_cap.dropped``: the band lanes a pruned sweep runs to
completion and its front cap then drops, the pruned path's wasted work:
the program's counter ``dse.front_cap.dropped`` over its count of
sweeps ``dse.sweeps`` (``repro_torch.tracing``), every sweep of a run
being the same.  Pruned cells; read from runs whose window the profiler
traced on the card; nothing where the program keeps no counters."""


def read(r):
    if not r.device or r.traffic.get("prune") != "surrogate":
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    counts = tracing.counts()
    if not counts.get("dse.sweeps"):
        return None
    return counts.get("dse.front_cap.dropped", 0) / counts["dse.sweeps"]
