"""The deferral scan's look-ahead window, on the CPU.

Between two issues an array's port state does not change, so every pop
up to the next issue can be judged against the same state.
``cycle_lanes_plain`` does so ``_WINDOW`` candidates at a time, and the
``cycle_lanes`` kernel in rounds of 32, one candidate a thread of the
array's warp.  The result must be the one-pop loop's, pop for pop,
whatever the window: here the plain version at window 1 (the one-pop
loop) and 32 (the kernel's) is held to its default window, exactly, on
every raw output (cycles, the eight counters, per-array accesses, error
codes, the remap maps and the event log), on golden configurations and
on lanes whose cycles pop more than one window of 32.
"""
import numpy as np
import pytest

from _torch_sched_util import (golden_configs, hub_trace, many_arrays_trace,
                              one_thread, wide_configs)  # noqa: F401
from repro_torch.core.sim import prepare_trace
from repro_torch.core.sim.arbiter import F_MAXFAIL
from repro_torch.core.sim.batched_cycle import _lane_inputs, lane_outputs
from repro_torch.kernels import cycle_lanes

pytestmark = pytest.mark.usefixtures("one_thread")
DEFAULT = cycle_lanes._WINDOW
_CASES: dict = {}


def _case(name):
    """The prepared trace, the lane configurations and the raw outputs
    at the default window of a case."""
    if name not in _CASES:
        if name == "hub":
            pt = prepare_trace(hub_trace(256))
            cfgs = wide_configs(pt, ("hb_ntx-4R2W-b4", "h_ntx_rd-4R1W-b4",
                                     "remap-4R2W"))
        elif name == "many":
            pt = prepare_trace(many_arrays_trace())
            cfgs = wide_configs(pt)
        else:
            pt, _, cfgs = golden_configs(name)
        assert cycle_lanes._WINDOW == DEFAULT
        _CASES[name] = pt, cfgs, _raw(pt, cfgs)
    return _CASES[name]


def _raw(pt, cfgs):
    sc, ins = _lane_inputs(pt, cfgs)
    return [o.numpy() for o in lane_outputs(pt, sc, ins, "cpu",
                                            record=True)]


@pytest.mark.parametrize("name,window", [
    ("kmp", 1), ("kmp", 32), ("md_knn", 32), ("hub", 1), ("hub", 32),
    ("many", 1), ("many", 32)])
def test_plain_scan_is_the_same_at_every_window(name, window, monkeypatch):
    pt, cfgs, want = _case(name)
    monkeypatch.setattr(cycle_lanes, "_WINDOW", window)
    got = _raw(pt, cfgs)
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and (g == w).all(), i
    if name in ("hub", "many"):
        # wider than a round: more than 32 memory ops of an array ready
        # in the first cycle, and NTX lanes that may pop past 32
        arr = pt.trace.array_ids[pt.indegree == 0]
        assert np.bincount(arr[arr >= 0]).max() > 32
        _, ins = _lane_inputs(pt, cfgs)
        assert ins["desc"][:, :, F_MAXFAIL].max() > 32
