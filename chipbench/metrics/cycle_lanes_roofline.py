"""``cycle_lanes_roofline``: the ``cycle_lanes`` kernel's share of its
memory roofline, in %: the least time the card's memory needs for the
bytes a sweep's schedule must move (``chipbench/work.py``: the trace
read once, each lane's design read and result written once), over the
kernel's device time a sweep."""

from chipbench import work

KERNEL = "cycle_lanes_kernel"


def read(r):
    ops = r.device.get("ops", {})
    kernel_s = sum(s for name, (s, _) in ops.items() if KERNEL in name)
    if not kernel_s:
        return None
    need = work.schedule_bytes(r.n_nodes, r.n_edges, r.lanes) * r.sweeps
    return 100.0 * work.least_seconds(need) / kernel_s
