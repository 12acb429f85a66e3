"""``surrogate.lanes``: the lanes the card schedules in a pruned sweep,
the surrogate band's size (no cache serves any).  Pruned cells only."""


def read(r):
    if r.traffic.get("prune") != "surrogate":
        return None
    return r.lanes
