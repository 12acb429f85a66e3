"""Whole runs of the benchmark's cells on the CPU, at small sizes, on
the program's plain lanes: each comes out correct, with the result
line the driver reads.

``chipbench.cell.run`` is what ``chipbench/run.py`` calls once it has
found a CUDA device; here it is called with the CPU instead, over the
few-point grid of ``_small.few`` (one cell also over the whole grid).
"""
import json
import time

import pytest
import torch

from chipbench import catalog, cell
from chipbench.tests._small import ROOT, SMALL, few

CELLS = ("sort_merge.grid", "md_knn.grid", "md_knn.pruned",
         "sort_merge.pruned")


def run_small(name, *, traffic=None, seed=2**31 + 11, trace=False):
    c = catalog.find(name, ROOT)
    return cell.run(c, seed, 0.0, trace, device=torch.device("cpu"),
                    process_start=time.time(), workers=0,
                    params=SMALL[c.config_name],
                    traffic=None if traffic is None else traffic(c.traffic))


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(name):
    out = run_small(name, traffic=few)
    assert out["correct"] is True
    assert out["checks"] == {"mismatches": {"value": 0, "limit": 0}}
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"sweep_s", "setup_s"}
    assert out["device"]["platform"] == "cpu"


def test_whole_grid_is_correct_on_the_cpu():
    out = run_small("sort_merge.grid", seed=5)
    assert out["correct"] is True
    assert out["check_parts"]["worst_rel_err"] == 0.0


def test_result_line_keys_and_checks_last():
    out = run_small("md_knn.pruned", traffic=few, trace=True)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s", "memory_peak_bytes", "kind", "count",
            "platform"} <= set(line["device"])
    # the profiler sees no device here: only the host-side readers read
    assert set(line["metrics"]) == {"surrogate.rank_ms", "surrogate.lanes"}
    assert line["metrics"]["surrogate.lanes"]["unit"] == "lanes"

