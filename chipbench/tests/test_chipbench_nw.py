"""The configuration ``machsuite-nw`` (MachSuite nw/needwun) on the CPU:
its reference generator against the program's generator and the pinned
golden schedules, a whole run of the cell ``nw.grid`` at a small size,
the control on it, and the readers of the program's batch counters
(``batch.h2d_mb``, ``batch.tables_ms``)."""
import json
import sys
import time
from collections import Counter

import numpy as np
import pytest
import torch

import repro_torch
from chipbench import catalog, cell
from chipbench.control import control_numbers
from chipbench.reference import schedule as S
from chipbench.reference import sweep as W
from chipbench.tests._small import ROOT, few
from chipbench.tests.test_chipbench_reference import _design
from repro_torch import tracing

CFG = "machsuite-nw"
GEN = str(ROOT / "chipbench" / "configs" / f"{CFG}.py")
TINY = {"alen": 12, "blen": 12}         # nw.TINY, the golden rows' size
SMALL = {"alen": 6, "blen": 5}          # a CPU sweep of the few-point grid


@pytest.mark.parametrize("size", [TINY, {"alen": 20, "blen": 16}],
                         ids=["12x12", "20x16"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_reference_trace_is_the_programs(size, seed):
    from repro_torch.core.bench import BENCHMARKS

    mod = BENCHMARKS["nw"]
    prog = mod.gen_trace(mod.Params(**size, seed=seed))
    ref = W.make_trace(GEN, size, seed)
    for f in ("kinds", "array_ids", "addrs", "pred_ptr", "pred_idx"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(prog, f))
    assert (ref.array_names, ref.word_bytes, ref.name) == \
        (prog.array_names, prog.word_bytes, prog.name)


def test_configuration_states_the_published_size():
    c = catalog.find("nw.grid", ROOT)
    assert c.config["params"] == {"alen": 128, "blen": 128}
    # the count of nodes follows from the loop alone: the boundary
    # stores, then 13 nodes a cell of the 128 x 128 fill
    assert c.config["nodes"] == 129 + 128 + 13 * 128 * 128


def test_reference_matches_golden_schedules():
    rows = [r for r in json.loads(
        (ROOT / "tests" / "golden_schedule.json").read_text())
        if r["bench"] == "nw"]
    assert len(rows) == 26
    pp = S.prepare(W.make_trace(GEN, TINY, 29))
    for r in rows:
        got = W.point(pp, _design(r["design"]), r["unroll"], 2)
        assert got["design"] == r["design"]
        for k in ("cycles", "issued", "mem_issued", "bank_conflict_stalls",
                  "parity_fanout_stalls", "write_pair_stalls",
                  "parity_path_reads", "write_pair_rmws"):
            assert got[k] == r[k], (r["design"], r["unroll"], k)
        assert got["avg_mem_parallelism"] == pytest.approx(
            r["avg_mem_parallelism"], abs=1e-8)


def test_cell_is_correct_on_the_cpu():
    c = catalog.find("nw.grid", ROOT)
    out = cell.run(c, 2**31 + 11, 0.0, False, device=torch.device("cpu"),
                   process_start=time.time(), workers=0, params=SMALL,
                   traffic=few(c.traffic))
    assert out["correct"] is True
    assert out["checks"] == {"mismatches": {"value": 0, "limit": 0}}
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"sweep_s", "setup_s"}


def test_control_is_not_correct():
    c = catalog.find("nw.grid", ROOT)
    got = control_numbers(c, 4, 0, params=TINY)
    assert got["numbers"]["mismatches"] > 0


def _reading(device):
    return cell.Reading(workload="nw.grid", traffic={"prune": None},
                        sweeps=3, window_s=1.0, points=[{"cycles": 10}],
                        lanes=80, n_nodes=100, n_edges=100, device=device,
                        rank_s=None)


TRACED = {"busy_s": 0.8, "trace_window_s": 1.0, "ops": {}, "gaps": {}}


@pytest.mark.parametrize("name, counter, want", [
    ("batch.h2d_mb", "batch.h2d_bytes", 262.0),
    ("batch.tables_ms", "batch.tables_ns", 120.5)])
def test_batch_readers_read_a_sweeps_share(name, counter, want,
                                           monkeypatch):
    reader = catalog.load_reader(ROOT / "chipbench" / "metrics"
                                 / f"{name}.py")
    monkeypatch.setattr(tracing, "_COUNTS", Counter(
        {"dse.sweeps": 4, counter: int(4 * want * 1e6)}))
    assert reader.read(_reading(TRACED)) == pytest.approx(want)
    assert reader.read(_reading({})) is None
    # a program that counts sweeps but not this counter
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"dse.sweeps": 4}))
    assert reader.read(_reading(TRACED)) is None
    # a program without the counters (no ``repro_torch.tracing``)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert reader.read(_reading(TRACED)) is None
