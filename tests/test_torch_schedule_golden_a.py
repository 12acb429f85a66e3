"""Golden rows of ``tests/golden_schedule.json`` through the port's
batched timing backend on the CPU (``cycle_lanes_plain``), first group
of benchmarks (the file is split so that no xdist worker holds them
all).  One lane-batched call per benchmark schedules its 26 rows; each
must equal its row: cycles, issued, mem_issued, the stall and path
counters exactly, ``avg_mem_parallelism`` within the file's 1e-9."""
import pytest

from _torch_sched_util import (check_row, golden_configs,  # noqa: F401
                               one_thread)
from repro_torch.core.sim.batched_cycle import schedule_batched
from repro_torch.kernels.cycle_lanes import cycle_lanes

pytestmark = pytest.mark.usefixtures("one_thread")
BENCHES = ("aes", "bfs_queue", "gemm_ncubed", "kv_decode", "paged_kv")


@pytest.mark.parametrize("bench", BENCHES)
def test_golden_rows_through_plain_lanes(bench):
    pt, rows, cfgs = golden_configs(bench)
    launches = cycle_lanes.launches
    results = schedule_batched(pt, cfgs, device="cpu")
    assert cycle_lanes.launches == launches     # the CPU takes the plain
    assert len(results) == len(rows) == 26
    for g, res in zip(rows, results):
        check_row(res, g)
        assert sum(res.per_array_accesses.values()) == res.mem_issued
