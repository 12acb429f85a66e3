"""Shared helpers of the port's batched-timing tests: the golden matrix's
designs and rows, their configurations on the port and on the reference,
and the row check (the golden file's own tolerance: 1e-9 on
``avg_mem_parallelism``, exact everywhere else)."""
import json
import pathlib

import pytest
import torch

from repro_torch.core.bench import get_trace
from repro_torch.core.dse.sweep import _BASE_FU, DesignPoint, _spec_for
from repro_torch.core.sim import ScheduleConfig, prepare_trace

HERE = pathlib.Path(__file__).parent
GOLDEN = json.loads((HERE / "golden_schedule.json").read_text())
# tests/test_golden_schedule.py::_DESIGNS, as port design points
DESIGNS = {
    "banked4": DesignPoint("banked", 1, 1, 4),
    "banked32": DesignPoint("banked", 1, 1, 32),
    "multipump-2R2W": DesignPoint("multipump", 2, 2, 1),
    "hb_ntx-2R2W": DesignPoint("hb_ntx", 2, 2, 1),
    "lvt-4R2W": DesignPoint("lvt", 4, 2, 1),
    "ideal-2R2W": DesignPoint("ideal", 2, 2, 1),
    "h_ntx_rd-4R1W": DesignPoint("h_ntx_rd", 4, 1, 1),
    "b_ntx_wr-1R2W": DesignPoint("b_ntx_wr", 1, 2, 1),
    "remap-2R2W": DesignPoint("remap", 2, 2, 1),
    "h_ntx_rd-4R1W-b4": DesignPoint("h_ntx_rd", 4, 1, n_banks=4),
    "hb_ntx-4R2W-b4": DesignPoint("hb_ntx", 4, 2, n_banks=4),
    "lvt-4R2W-b4": DesignPoint("lvt", 4, 2, n_banks=4),
    "remap-4R2W-b4": DesignPoint("remap", 4, 2, n_banks=4),
}
STALL_FIELDS = ("bank_conflict_stalls", "parity_fanout_stalls",
                "write_pair_stalls", "parity_path_reads", "write_pair_rmws")


def bench_rows(bench: str) -> list:
    return [g for g in GOLDEN if g["bench"] == bench]


def config(pt, design: str, unroll: int) -> ScheduleConfig:
    """The golden row's configuration on the port (as the reference's
    ``test_golden_schedule._config`` builds it)."""
    dp = DESIGNS[design]
    specs = {aid: _spec_for(dp, pt.array_depths[aid],
                            pt.trace.word_bytes[aid] * 8)
             for aid in pt.trace.array_names}
    return ScheduleConfig(mem=specs,
                          fu_counts={k: v * unroll
                                     for k, v in _BASE_FU.items()})


def ref_config(rpt, cfg: ScheduleConfig):
    """The same configuration on the reference's types."""
    from repro.core.amm.spec import AMMSpec as RefSpec
    from repro.core.sim.scheduler import ScheduleConfig as RefConfig
    return RefConfig(
        mem={a: RefSpec(s.kind, s.n_read, s.n_write, s.depth, s.width,
                        n_banks=s.n_banks) for a, s in cfg.mem.items()},
        fu_counts=dict(cfg.fu_counts), mem_latency=cfg.mem_latency,
        ports_per_bank=cfg.ports_per_bank, max_cycles=cfg.max_cycles)


def golden_configs(bench: str):
    pt = prepare_trace(get_trace(bench))
    rows = bench_rows(bench)
    return pt, rows, [config(pt, g["design"], g["unroll"]) for g in rows]


def check_row(res, g) -> None:
    assert res.cycles == g["cycles"], (g, res.cycles)
    assert res.issued == g["issued"], g
    assert res.mem_issued == g["mem_issued"], g
    assert abs(res.avg_mem_parallelism - g["avg_mem_parallelism"]) < 1e-9
    for f in STALL_FIELDS:
        assert getattr(res, f) == g[f], (f, g, getattr(res, f))


@pytest.fixture
def one_thread():
    """Run a test's plain lanes on one intra-op thread.  Their tensors
    are small and their loop long, so extra threads buy nothing, and
    under several test workers their spinning threads would contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
