"""The port's legality checker (``repro_torch.core.verify``, a copy of
the JAX package's ``core/verify``) against the reference, on the CPU.

* each copy is held equal to the module it copies: the rule and bound
  vocabularies, the NTX leaf paths, the per-array rules of every kind,
  and the static bounds of every TINY golden configuration;
* the reference's seeded mutations (``tests/test_verify.py``, one
  corrupted event log or result per rule class), applied to event logs
  from ``cycle_lanes_plain``, give the same violations through the
  port's checker as through the reference's, and the expected class;
* the plain version's event logs for every TINY golden row check clean
  (no violation, every static bound met), and ``check_schedule`` runs
  the backend itself on the CPU.

Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest

from _torch_sched_util import (golden_configs, one_thread,  # noqa: F401
                              ref_config)
from repro.core.amm.spec import AMMSpec as RefSpec
from repro.core.bench import get_trace as ref_get_trace
from repro.core.sim import prepare_trace as ref_prepare
from repro.core.sim import trace as RT
from repro.core.sim.events import EventLog as RefEventLog
from repro.core.sim.scheduler import ScheduleResult as RefResult
from repro.core import verify as ref_verify
from repro.core.verify import geometry as ref_geometry
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.bench import BENCHMARKS
from repro_torch.core.sim import ScheduleConfig, prepare_trace
from repro_torch.core.sim import trace as T
from repro_torch.core.sim.batched_cycle import schedule_batched
from repro_torch.core.sim.events import (PATH_BROADCAST, PATH_DIRECT,
                                         PATH_PAIR_RMW, PATH_STEERED)
from repro_torch.core.sim.prepared import FU_ORDER
from repro_torch.core import verify
from repro_torch.core.verify import geometry

pytestmark = pytest.mark.usefixtures("one_thread")

# tests/test_verify.py's designs, on both packages' spec types
_SPECS = {
    "ideal": ("ideal", 4, 2, 64, 1), "banked": ("banked", 4, 2, 64, 4),
    "multipump": ("multipump", 2, 2, 64, 1), "lvt": ("lvt", 2, 2, 64, 1),
    "h_ntx_rd": ("h_ntx_rd", 4, 1, 64, 1),
    "b_ntx_wr": ("b_ntx_wr", 1, 2, 64, 1), "hb_ntx": ("hb_ntx", 4, 2, 64, 1),
    "remap": ("remap", 2, 2, 64, 1)}
SPECS = {k: AMMSpec(kind, r, w, d, n_banks=b)
         for k, (kind, r, w, d, b) in _SPECS.items()}
_FU = {k: 2 for k in FU_ORDER}


def test_vocabularies_match_the_reference():
    assert verify.RULE_CLASSES == ref_verify.RULE_CLASSES
    assert verify.BOUND_KINDS == ref_verify.BOUND_KINDS
    assert verify.__all__ == ref_verify.__all__


@pytest.mark.parametrize("k", range(5))
def test_leaf_paths_match_the_reference(k):
    for depth in (1 << k, 1 << (k + 1), 48, 256):
        if depth >> k == 0:
            continue
        assert geometry.leaf_paths(depth, k) == \
            ref_geometry.leaf_paths(depth, k)


@pytest.mark.parametrize("kind", sorted(_SPECS))
def test_array_rules_match_the_reference(kind):
    name, r, w, d, b = _SPECS[kind]
    for depth, banks in ((d, b), (128, 4), (32, 2), (16, 1)):
        for ppb in (1, 2, 4):
            got = verify.compile_rules(
                AMMSpec(name, r, w, depth, n_banks=banks), ppb)
            want = ref_verify.compile_rules(
                RefSpec(name, r, w, depth, n_banks=banks), ppb)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bench", BENCHMARKS)
def test_static_bounds_match_the_reference(bench):
    pt, _, cfgs = golden_configs(bench)
    rpt = ref_prepare(ref_get_trace(bench))
    for cfg in cfgs:
        assert verify.static_bounds(pt, cfg) == \
            ref_verify.static_bounds(rpt, ref_config(rpt, cfg))


# ----------------------------------------------------------------------
# seeded mutations (tests/test_verify.py:124-251) on the plain logs
# ----------------------------------------------------------------------
def _build_trace(T):
    """tests/test_verify.py::_build_trace, on either package's types."""
    tb = T.TraceBuilder("verify")
    a = tb.declare_array("a", 4)
    b = tb.declare_array("b", 4)
    rng = np.random.default_rng(7)
    prev = ()
    for i in range(48):
        x = tb.load(a, int(rng.integers(0, 64)), prev)
        y = tb.load(a, int(rng.integers(0, 64)), ())
        z = tb.op(T.FADD, x, y)
        w = tb.op(T.FMUL, z, z)
        tb.store(b, int(rng.integers(0, 64)), (w,))
        tb.store(a, int(rng.integers(0, 64)), (w,))
        prev = (w,) if i % 7 == 0 else ()
    return tb.build()


@pytest.fixture(scope="module")
def traces():
    return prepare_trace(_build_trace(T)), ref_prepare(_build_trace(RT))


@pytest.fixture(scope="module")
def clean(traces):
    """Per kind: the config and the plain version's result and log,
    checked clean by both checkers."""
    pt, rpt = traces
    cfgs = {k: ScheduleConfig(mem={0: SPECS[k], 1: SPECS["ideal"]},
                              fu_counts=dict(_FU)) for k in SPECS}
    results, logs = schedule_batched(pt, list(cfgs.values()), device="cpu",
                                     collect_events=True)
    out = {}
    for (kind, cfg), res, ev in zip(cfgs.items(), results, logs):
        assert verify.verify_events(pt, cfg, res, ev) == []
        assert _ref_violations(rpt, cfg, res, ev) == []
        out[kind] = (cfg, res, ev)
    return out


def _ref_violations(rpt, cfg, res, ev):
    """The reference checker's violations of the same log."""
    rres = RefResult(**dataclasses.asdict(res))
    rev = RefEventLog(*(getattr(ev, f).copy()
                        for f in ("cycle", "path", "resource", "slot")))
    return ref_verify.verify_result(rpt, ref_config(rpt, cfg), rres, rev,
                                    backend="ref").violations


def _mutate_dropped(pt, res, ev):
    ev.cycle[5] = -1


def _mutate_beyond_horizon(pt, res, ev):
    ev.cycle[5] = res.cycles + 7


def _mutate_dependence(pt, res, ev):
    counts = np.diff(pt.succ_ptr)
    src = int(np.flatnonzero(counts)[0])
    dst = int(pt.succ_idx[pt.succ_ptr[src]])
    ev.cycle[dst] = ev.cycle[src]


def _mutate_fu_overissue(pt, res, ev):
    fadd = np.flatnonzero(pt.klass_np == pt.n_arrays
                          + FU_ORDER.index("fadd"))[:3]
    ev.cycle[fadd] = int(ev.cycle[fadd].max())
    ev.slot[fadd] = [0, 1, 2]


def _mutate_duplicate_slot(pt, res, ev):
    mem = np.flatnonzero((pt.klass_np == 0) & (ev.slot >= 1))
    ev.slot[int(mem[0])] = 0


def _mutate_wrong_bank(pt, res, ev):
    node = int(np.flatnonzero((pt.klass_np == 0)
                              & pt.is_load_np.astype(bool))[0])
    ev.resource[node] = (ev.resource[node] + 1) % SPECS["banked"].n_banks


def _mutate_slot_overflow(pt, res, ev):
    acc = np.flatnonzero(pt.klass_np == 0)[:5]
    ev.cycle[acc] = int(ev.cycle[acc].max())
    ev.slot[acc] = np.arange(5)


def _direct_reads(pt, ev):
    return np.flatnonzero((pt.klass_np == 0) & pt.is_load_np.astype(bool)
                          & (ev.path == PATH_DIRECT))


def _mutate_wrong_leaf(pt, res, ev):
    ev.resource[int(_direct_reads(pt, ev)[0])] += 1


def _mutate_duplicate_leaf(pt, res, ev):
    direct = _direct_reads(pt, ev)
    words = pt.word_index_np[direct] % 64
    _, inv, cnt = np.unique(words, return_inverse=True, return_counts=True)
    grp = int(np.flatnonzero(cnt[inv] > 1)[0])
    pair = direct[inv == inv[grp]][:2]
    ev.cycle[pair[1]] = ev.cycle[pair[0]]


def _mutate_double_pair(pt, res, ev):
    pairs = np.flatnonzero(ev.path == PATH_PAIR_RMW)
    assert pairs.size, "trace exercises the write-pair path"
    other = np.flatnonzero((pt.klass_np == 0) & ~pt.is_load_np.astype(bool)
                           & (ev.path != PATH_PAIR_RMW))
    node = int(other[0])
    ev.path[node] = PATH_PAIR_RMW
    ev.cycle[node] = ev.cycle[int(pairs[0])]


def _mutate_lvt_plain_write(pt, res, ev):
    ev.path[int(np.flatnonzero(ev.path == PATH_BROADCAST)[0])] = PATH_DIRECT


def _mutate_missteered(pt, res, ev):
    node = int(np.flatnonzero(ev.path == PATH_STEERED)[0])
    ev.resource[node] = (ev.resource[node] + 1) % (SPECS["remap"].n_write
                                                   + 1)


def _mutate_remap_read_bank(pt, res, ev):
    node = int(np.flatnonzero((pt.klass_np == 0)
                              & pt.is_load_np.astype(bool))[0])
    ev.resource[node] = (ev.resource[node] + 1) % (SPECS["remap"].n_write
                                                   + 1)


MUTATIONS = {
    "dropped_event": ("ideal", _mutate_dropped, "completeness"),
    "beyond_horizon": ("ideal", _mutate_beyond_horizon, "completeness"),
    "dependence": ("ideal", _mutate_dependence, "dependence"),
    "fu_overissue": ("ideal", _mutate_fu_overissue, "fu_budget"),
    "duplicate_slot": ("ideal", _mutate_duplicate_slot, "slot_collision"),
    "banked_wrong_bank": ("banked", _mutate_wrong_bank, "bank_conflict"),
    "multipump_overflow": ("multipump", _mutate_slot_overflow,
                           "slot_budget"),
    "ntx_wrong_leaf": ("h_ntx_rd", _mutate_wrong_leaf, "parity_fanout"),
    "ntx_duplicate_leaf": ("h_ntx_rd", _mutate_duplicate_leaf,
                           "parity_fanout"),
    "double_pair_rmw": ("hb_ntx", _mutate_double_pair, "write_pair"),
    "lvt_plain_write": ("lvt", _mutate_lvt_plain_write, "path_kind"),
    "remap_missteered": ("remap", _mutate_missteered, "steering"),
    "remap_read_bank": ("remap", _mutate_remap_read_bank, "bank_conflict"),
}


def _copy_log(ev):
    return dataclasses.replace(ev, **{f: getattr(ev, f).copy() for f in
                                      ("cycle", "path", "resource",
                                       "slot")})


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_gives_the_reference_violations(traces, clean, name):
    pt, rpt = traces
    kind, mutate, rule = MUTATIONS[name]
    cfg, res, ev = clean[kind]
    ev = _copy_log(ev)
    mutate(pt, res, ev)
    got = verify.verify_result(pt, cfg, res, ev).violations
    want = _ref_violations(rpt, cfg, res, ev)
    assert rule in {v.rule for v in got}
    assert [str(v) for v in got] == [str(v) for v in want]


@pytest.mark.parametrize("field,rule", [("issued", "counter"),
                                        ("cycles", "static_bound")])
def test_result_mutation_gives_the_reference_violations(traces, clean,
                                                        field, rule):
    pt, rpt = traces
    cfg, res, ev = clean["ideal"]
    bad = dataclasses.replace(
        res, **{field: res.issued + 1 if field == "issued" else 1})
    rep = verify.verify_result(pt, cfg, bad, ev, backend="cpu")
    assert rule in {v.rule for v in rep.violations}
    assert [str(v) for v in rep.violations] == \
        [str(v) for v in _ref_violations(rpt, cfg, bad, ev)]
    with pytest.raises(verify.LegalityError):
        rep.raise_if_failed()


# ----------------------------------------------------------------------
# clean: the plain version's logs of the TINY golden rows
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bench", BENCHMARKS)
def test_plain_logs_of_the_golden_rows_check_clean(bench):
    pt, rows, cfgs = golden_configs(bench)
    results, logs = schedule_batched(pt, cfgs, device="cpu",
                                     collect_events=True)
    for g, cfg, res, ev in zip(rows, cfgs, results, logs):
        rep = verify.verify_result(pt, cfg, res, ev, backend="cpu")
        assert rep.ok, (g["design"], g["unroll"], rep.violations)
        assert res.cycles == g["cycles"]
        assert all(res.cycles >= b for b in rep.bounds.values())


def test_check_schedule_runs_the_backend(traces, clean):
    pt, _ = traces
    cfg, res, ev = clean["hb_ntx"]
    rep = verify.check_schedule(pt.trace, cfg, device="cpu")
    assert rep.ok and rep.backend == "cpu"
    assert rep.result == res and rep.events == ev
