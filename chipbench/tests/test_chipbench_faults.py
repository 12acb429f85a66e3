"""The benchmark's comparison fails what it must: the control and the
planted faults, in whole runs on the CPU at small sizes.

The faults break the timed path underneath the sweep runner, in
``repro_torch.kernels.ops.cycle_lanes``: one lane's answer altered
where it is produced, half of the lanes left out (the other half's
answers in their place), and the kernel's counters returned as they
were before it ran.  A sweep exchanges nothing between chips, so that
fault has no place here.  The control is the reference with its
deferral-scan cap halved (``chipbench/control.py``), at the bench
generators' TINY sizes.
"""
import pytest

from chipbench import catalog
from chipbench.control import control_numbers
from chipbench.tests._small import ROOT, TINY, few
from chipbench.tests.test_chipbench_cell import CELLS, run_small


def _break_kernel(monkeypatch, fault):
    from repro_torch.kernels import ops

    real = ops.cycle_lanes

    def broken(*args, **kw):
        out = [o.clone() for o in real(*args, **kw)]
        cycles, cnt = out[0], out[1]
        lanes = cycles.shape[0]
        if fault == "answer_altered":
            cycles[lanes // 2] += 1
        elif fault == "half_left_out":
            h = lanes // 2
            for o in out[:3]:
                o[lanes - h:] = o[:h].clone()
        elif fault == "state_unchanged":
            cnt.zero_()
        return tuple(out)

    monkeypatch.setattr(ops, "cycle_lanes", broken)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "state_unchanged"])
@pytest.mark.parametrize("name", ["sort_merge.grid", "md_knn.pruned"])
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    _break_kernel(monkeypatch, fault)
    out = run_small(name, traffic=few)
    assert out["correct"] is False
    assert out["checks"]["mismatches"]["value"] > 0
    assert out["failed"] == out["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    c = catalog.find(name, ROOT)
    got = control_numbers(c, 4, 0, params=TINY[c.config_name])
    assert got["numbers"]["mismatches"] > 0
