"""The pruned sweep's front cap in the port
(``batched_cycle.front_capped``, ``scheduler.schedule_batch``,
``sweep.evaluate_points(front_cap=True)``) against the JAX package's
compiled C batch loop, on the CPU.

The reference's cap exists only in that loop (``_cycle_loop.c:599-650``,
``run_schedule_batch``); without a C compiler its ``schedule_batch``
falls back to a Python loop that caps nothing.  So every comparison
here first asserts that the loop is built.

* ``evaluate_points`` position for position, ``None`` included, with and
  without the cap, on ``fft_strided`` x the surrogate's calibration
  designs x unrolls (1, 4) (the inputs of
  ``tests/test_surrogate.py::test_front_cap_suppresses_only_off_front_points``);
* ``schedule_batch`` on configs in ascending-area order and in the
  reverse of the grid's order (where the reference, walking the given
  order, caps fewer);
* ``front_capped`` against a transcription of ``run_schedule_batch``'s
  loop on random areas (with ties), cycle times, cycles and eligibility,
  the budget's boundary, and that the rule reads a capped point's cycles
  only as "past its budget": a lower bound in their place (what a run
  abandoned early would know) never changes the kept set;
* a capped ``evaluate_points`` compiles each config's descriptors once
  (the eligibility reads the launches' descriptor rows).

Every lane runs to completion, and the host's rule trims afterwards
(``tests/test_torch_cuda.py`` holds the card's lanes to the same set).
"""
import dataclasses
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.bench import get_trace as ref_get_trace
from repro.core.dse.sweep import _point_static_cost as ref_static_cost
from repro.core.dse.sweep import evaluate_points as ref_evaluate_points
from repro.core.dse.sweep import schedule_config_for as ref_config_for
from repro.core.dse.surrogate import CALIBRATION_DESIGNS as REF_CAL
from repro.core.sim import _cycle_ext
from repro.core.sim import prepare_trace as ref_prepare
from repro.core.sim.scheduler import schedule_batch as ref_schedule_batch
from repro_torch.core.bench import get_trace
from repro_torch.core.dse.surrogate import CALIBRATION_DESIGNS
from repro_torch.core.dse.sweep import (_point_static_cost, evaluate_points,
                                        schedule_config_for)
from repro_torch.core.sim import arbiter, batched_cycle, prepare_trace
from repro_torch.core.sim.batched_cycle import (_lane_inputs, front_capped,
                                                front_eligible)
from repro_torch.core.sim.scheduler import schedule_batch

from _torch_sched_util import one_thread  # noqa: F401  (fixture)

UNROLLS = (1, 4)


def _needs_the_c_batch_loop():
    assert _cycle_ext.load_batch() is not None, \
        "the reference's front cap lives in its compiled C batch loop"


def _points(bench):
    pt, rpt = prepare_trace(get_trace(bench)), ref_prepare(
        ref_get_trace(bench))
    pts = [(dp, u) for dp in CALIBRATION_DESIGNS.values() for u in UNROLLS]
    rpts = [(dp, u) for dp in REF_CAL.values() for u in UNROLLS]
    assert [(dp.label, u) for dp, u in pts] == \
        [(dp.label, u) for dp, u in rpts]
    return pt, rpt, pts, rpts


def _row(p):
    return None if p is None else p.row()


def _desc(pt, cfgs):
    """The descriptor rows of ``cfgs`` as a launch takes them."""
    return _lane_inputs(pt, cfgs)[1]["desc"]


@pytest.mark.parametrize("front_cap", [True, False])
def test_evaluate_points_matches_the_reference(front_cap, one_thread,
                                               monkeypatch):
    _needs_the_c_batch_loop()
    pt, rpt, pts, rpts = _points("fft_strided")
    monkeypatch.setattr(batched_cycle, "BATCH_LANES", 10)
    got = evaluate_points(pt, pts, front_cap=front_cap, device="cpu")
    want = ref_evaluate_points(rpt, rpts, front_cap=front_cap)
    assert [_row(p) for p in got] == [_row(p) for p in want]
    assert sum(p is None for p in want) == (9 if front_cap else 0)


@pytest.mark.parametrize("order", ["ascending", "reversed grid"])
def test_schedule_batch_matches_the_reference(order, one_thread):
    _needs_the_c_batch_loop()
    pt, rpt, pts, rpts = _points("bfs_queue")
    cfgs = [schedule_config_for(pt, dp, u) for dp, u in pts]
    rcfgs = [ref_config_for(rpt, dp, u) for dp, u in rpts]
    costs = [_point_static_cost(c, u) for c, (_, u) in zip(cfgs, pts)]
    assert costs == [ref_static_cost(c, u)
                     for c, (_, u) in zip(rcfgs, rpts)]
    idx = (sorted(range(len(pts)), key=lambda i: costs[i][0])
           if order == "ascending" else list(range(len(pts)))[::-1])
    areas = [costs[i][0] for i in idx]
    ns = [costs[i][1] for i in idx]
    got = schedule_batch(pt, [cfgs[i] for i in idx], areas=areas,
                         cycle_ns=ns, front_cap=True, device="cpu")
    want = ref_schedule_batch(rpt, [rcfgs[i] for i in idx], areas=areas,
                              cycle_ns=ns, front_cap=True)
    assert [r is None for r in got] == [r is None for r in want]
    assert sum(r is None for r in want) == \
        (17 if order == "ascending" else 5)
    for g, w in zip(got, want):
        if w is not None:
            assert g.summary() == w.summary()
    with pytest.raises(ValueError, match="requires areas and cycle_ns"):
        schedule_batch(pt, cfgs[:1], front_cap=True, device="cpu")


def test_every_default_config_takes_part_in_the_cap():
    """No config of the default grid has more than 128 parity paths, so
    each one runs in the reference's C loop, under its cap."""
    from repro_torch.core.dse.sweep import DEFAULT_DESIGNS, DEFAULT_UNROLLS
    for bench in ("md_knn", "kmp", "gemm_ncubed"):
        pt = prepare_trace(get_trace(bench))
        cfgs = [schedule_config_for(pt, dp, u) for dp in DEFAULT_DESIGNS
                for u in DEFAULT_UNROLLS]
        assert front_eligible(cfgs, _desc(pt, cfgs)).all(), bench
        mixed = [cfgs[0], dataclasses.replace(cfgs[1], max_cycles=7)]
        assert not front_eligible(mixed, _desc(pt, mixed)).any()


def test_a_capped_evaluate_points_compiles_each_config_once(
        monkeypatch, one_thread):
    """Under the cap, in one launch and in three, every config's
    descriptors are compiled once: the eligibility reads the rows the
    launches were given."""
    real = arbiter.compile_descriptors
    compiled = []

    def counted(*args, **kwargs):
        compiled.append(args[0])
        return real(*args, **kwargs)

    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("repro_torch") and \
                getattr(mod, "compile_descriptors", None) is real:
            monkeypatch.setattr(mod, "compile_descriptors", counted)
    pt = prepare_trace(get_trace("paged_kv"))
    pts = [(dp, u) for dp in CALIBRATION_DESIGNS.values() for u in UNROLLS]
    once = evaluate_points(pt, pts, front_cap=True, device="cpu")
    assert len(compiled) == len(pts)
    compiled.clear()
    monkeypatch.setattr(batched_cycle, "BATCH_LANES", -(-len(pts) // 3))
    assert evaluate_points(pt, pts, front_cap=True, device="cpu") == once
    assert len(compiled) == len(pts)


# ----------------------------------------------------------------------
# the rule
# ----------------------------------------------------------------------
def _c_loop(areas, ns, cycles, max_cycles, eligible):
    """``run_schedule_batch``'s cap, transcribed: the configs that reach
    the C loop (the eligible ones) in the given order; a run fails at
    the top of the first cycle past its budget, so it completes iff
    ``cycles - 1 <= budget``; ``status`` 1 is front-capped."""
    batch = [i for i in range(len(areas)) if eligible[i]]
    status = {}
    for k, c in enumerate(batch):
        budget = max_cycles
        tmin = -1.0
        for q in batch[:k]:
            if status[q] != 0:
                continue
            if areas[q] > areas[c] - 1e-12:
                continue
            t = float(cycles[q]) * ns[q]
            if tmin < 0.0 or t < tmin:
                tmin = t
        if tmin >= 0.0:
            cap = tmin / ns[c]
            if cap < float(max_cycles):
                icap = int(cap) + 1
                if icap < budget:
                    budget = icap
        rc = -1 if cycles[c] - 1 > budget else 0
        status[c] = 1 if rc == -1 and budget < max_cycles else rc
    return [not eligible[i] or status[i] == 0 for i in range(len(areas))]


@st.composite
def _batches(draw):
    n = draw(st.integers(1, 24))
    max_cycles = draw(st.integers(4, 400))
    levels = draw(st.lists(st.integers(0, 5), min_size=n, max_size=n))
    areas = [0.25 * a + 1.0 for a in levels]            # ties are common
    ns = draw(st.lists(st.sampled_from([0.9, 1.0, 1.3, 2.1, 0.95]),
                       min_size=n, max_size=n))
    cycles = draw(st.lists(st.integers(1, max_cycles + 1), min_size=n,
                           max_size=n))
    eligible = draw(st.lists(st.sampled_from([True, True, True, False]),
                             min_size=n, max_size=n))
    order = draw(st.permutations(range(n)))
    if draw(st.booleans()):
        order = sorted(range(n), key=lambda i: areas[i])
    pick = (lambda xs: [xs[i] for i in order])
    return (pick(areas), pick(ns), pick(cycles), max_cycles,
            pick(eligible), draw(st.randoms(use_true_random=False)))


@settings(max_examples=300, deadline=None)
@given(_batches())
def test_front_capped_is_the_c_loop_and_abandoning_never_changes_it(batch):
    areas, ns, cycles, max_cycles, eligible, rnd = batch
    kept = front_capped(areas, ns, cycles, max_cycles, eligible)
    assert kept == _c_loop(areas, ns, cycles, max_cycles, eligible)
    assert all(kept[i] for i in range(len(areas)) if not eligible[i])

    # some lanes complete (exact cycles); an eligible lane may stop
    # against completed, strictly cheaper, earlier lanes once its clock
    # passes their budget, and then carries only a lower bound of its
    # cycles
    done = [rnd.random() < 0.5 for _ in areas]
    seen = list(cycles)
    abandoned = []
    for c in range(len(areas)):
        if done[c] or not eligible[c]:
            continue
        qs = [q for q in range(c) if done[q] and eligible[q]
              and areas[q] <= areas[c] - 1e-12 and rnd.random() < 0.7]
        if not qs:
            continue
        tmin = min(float(cycles[q]) * ns[q] for q in qs)
        cap = tmin / ns[c]
        if cap >= float(max_cycles):
            continue
        budget = int(cap) + 1
        if budget < max_cycles and cycles[c] - 1 > budget:
            seen[c] = rnd.randint(budget + 2, cycles[c])
            abandoned.append(c)
    again = front_capped(areas, ns, seen, max_cycles, eligible)
    assert again == kept
    assert not any(kept[c] for c in abandoned)


def test_front_capped_budget_boundary():
    """A cheaper point of time 10 x 1.0 ns gives a point of 1.0 ns the
    budget int(10 / 1) + 1 = 11: 12 cycles (last cycle 11) are kept, 13
    are capped; an ineligible point is never capped; equal areas never
    cap each other; nothing is capped when the budget reaches
    ``max_cycles``."""
    areas, ns = [1.0, 2.0], [1.0, 1.0]
    assert front_capped(areas, ns, [10, 12], 100, [True, True]) == \
        [True, True]
    assert front_capped(areas, ns, [10, 13], 100, [True, True]) == \
        [True, False]
    assert front_capped(areas, ns, [10, 13], 100, [True, False]) == \
        [True, True]
    assert front_capped(areas, ns, [10, 13], 100, [False, True]) == \
        [True, True]
    assert front_capped([1.0, 1.0 + 1e-13], ns, [10, 13], 100,
                        [True, True]) == [True, True]
    assert front_capped(areas, ns, [10, 13], 11, [True, True]) == \
        [True, True]
    assert front_capped(areas, ns, [10, 13], 12, [True, True]) == \
        [True, False]
