"""``surrogate.rank_ms``: host ms of one surrogate ranking of the
cell's grid (``grid_predictions`` and ``select_band``), timed outside
the window over at least 250 ms of repeated calls.  Pruned cells only."""


def read(r):
    return None if r.rank_s is None else r.rank_s * 1e3
