"""The benchmark's reference against the program's pinned goldens and
the program's own generators, costs and Pareto reduction, on the CPU.

The reference decides ``correct`` on the card; these tests hold it to
``tests/golden_schedule.json`` (the TINY schedules every backend of the
reproduction is pinned to) and show that its trace, costs and fronts
are the program's, bit for bit, where the program is sound.
"""
import json
import re

import numpy as np
import pytest

from chipbench.reference import model as M
from chipbench.reference import schedule as S
from chipbench.reference import sweep as W
from chipbench.tests._small import ROOT, TINY, TINY_SEED

CONFIGS = ("machsuite-sort_merge", "machsuite-md_knn")
BENCH = {"machsuite-sort_merge": "sort_merge", "machsuite-md_knn": "md_knn"}


def _gen(cfg):
    return str(ROOT / "chipbench" / "configs" / f"{cfg}.py")


def _design(label: str):
    m = re.fullmatch(r"banked(\d+)", label)
    if m:
        return ("banked", 1, 1, int(m.group(1)))
    m = re.fullmatch(r"(\w+)-(\d+)R(\d+)W(?:-b(\d+))?", label)
    return (m.group(1), int(m.group(2)), int(m.group(3)),
            int(m.group(4) or 1))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_reference_matches_golden_schedules(cfg):
    rows = [r for r in json.loads(
        (ROOT / "tests" / "golden_schedule.json").read_text())
        if r["bench"] == BENCH[cfg]]
    assert len(rows) == 26
    pp = S.prepare(W.make_trace(_gen(cfg), TINY[cfg], TINY_SEED[cfg]))
    for r in rows:
        got = W.point(pp, _design(r["design"]), r["unroll"], 2)
        assert got["design"] == r["design"]
        for k in ("cycles", "issued", "mem_issued", "bank_conflict_stalls",
                  "parity_fanout_stalls", "write_pair_stalls",
                  "parity_path_reads", "write_pair_rmws"):
            assert got[k] == r[k], (r["design"], r["unroll"], k)
        assert got["avg_mem_parallelism"] == pytest.approx(
            r["avg_mem_parallelism"], abs=1e-8)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_reference_trace_is_the_programs(cfg, seed):
    from repro_torch.core.bench import BENCHMARKS

    mod = BENCHMARKS[BENCH[cfg]]
    prog = mod.gen_trace(mod.Params(**TINY[cfg], seed=seed))
    ref = W.make_trace(_gen(cfg), TINY[cfg], seed)
    for f in ("kinds", "array_ids", "addrs", "pred_ptr", "pred_idx"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(prog, f))
    assert (ref.array_names, ref.word_bytes, ref.name) == \
        (prog.array_names, prog.word_bytes, prog.name)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_reference_costs_are_the_programs_bit_for_bit(cfg):
    from repro_torch.core.bench import BENCHMARKS
    from repro_torch.core.dse.pareto import pareto_front
    from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS,
                                            point_from_schedule,
                                            schedule_config_for)
    from repro_torch.core.sim.prepared import prepare_trace
    from repro_torch.core.sim.scheduler import ScheduleResult

    mod = BENCHMARKS[BENCH[cfg]]
    pt = prepare_trace(mod.gen_trace(mod.Params(**TINY[cfg], seed=5)))
    pp = S.prepare(W.make_trace(_gen(cfg), TINY[cfg], 5))
    ref_pts, prog_pts = [], []
    for dp in DEFAULT_DESIGNS:
        for u in (1, 2, 4, 8):
            r = W.point(pp, (dp.kind, dp.n_read, dp.n_write, dp.n_banks),
                        u, 2)
            res = ScheduleResult(
                cycles=r["cycles"], issued=r["issued"],
                mem_issued=r["mem_issued"],
                bank_conflict_stalls=r["bank_conflict_stalls"],
                parity_fanout_stalls=r["parity_fanout_stalls"],
                write_pair_stalls=r["write_pair_stalls"],
                parity_path_reads=0, write_pair_rmws=0,
                per_array_accesses={},
                avg_mem_parallelism=r["avg_mem_parallelism"])
            p = point_from_schedule(pt, dp, u,
                                    schedule_config_for(pt, dp, u, 2), res)
            assert r["design"] == p.design
            for f in ("cycle_ns", "time_us", "area_mm2", "power_mw"):
                assert r[f] == getattr(p, f), (p.design, u, f)
            ref_pts.append(r)
            prog_pts.append(p)
    for cost in ("area_mm2", "power_mw"):
        prog_front = [(p.design, p.unroll) for p in pareto_front(
            prog_pts, cost=lambda p, c=cost: getattr(p, c))]
        assert M.pareto(ref_pts, cost) == prog_front


def test_reference_sweep_in_workers_equals_in_process():
    cfg = "machsuite-md_knn"
    designs = [("banked", 1, 1, 4), ("hb_ntx", 4, 2, 4), ("remap", 4, 2, 1)]
    one = W.sweep(_gen(cfg), TINY[cfg], 9, designs, (1, 4), 2, workers=0)
    two = W.sweep(_gen(cfg), TINY[cfg], 9, designs, (1, 4), 2, workers=2)
    assert one == two

