"""``cycle_lanes.ns_per_cycle``: the ``cycle_lanes`` kernel's device ns
a sweep over the most cycles any returned point of the sweep simulated:
the time a simulated cycle of the slowest lane costs (a launch lasts as
long as its slowest lane)."""

KERNEL = "cycle_lanes_kernel"


def read(r):
    ops = r.device.get("ops", {})
    kernel_s = sum(s for name, (s, _) in ops.items() if KERNEL in name)
    most = max((p["cycles"] for p in r.points), default=0)
    if not kernel_s or not most:
        return None
    return kernel_s * 1e9 / r.sweeps / most
