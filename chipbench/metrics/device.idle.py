"""``device.idle``: the share of the traced window, in %, in which the
card ran no kernel, copy or fill (the profiler's device events,
merged)."""


def read(r):
    span = r.device.get("trace_window_s", 0.0)
    if span <= 0:
        return None
    return 100.0 * (1.0 - r.device["busy_s"] / span)
