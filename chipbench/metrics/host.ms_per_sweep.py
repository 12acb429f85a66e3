"""``host.ms_per_sweep``: the host's share of a sweep, in ms: the
window's wall time less the ``cycle_lanes`` kernel's device time, over
the sweeps.  It holds the runner, the surrogate, the batch layer
(descriptors, layouts, copies, the fold) and the costing and Pareto
reduction."""

KERNEL = "cycle_lanes_kernel"


def read(r):
    ops = r.device.get("ops", {})
    kernel_s = sum(s for name, (s, _) in ops.items() if KERNEL in name)
    if not kernel_s:
        return None
    return (r.window_s - kernel_s) / r.sweeps * 1e3
