"""Shared helpers of the port's batched-timing tests: the golden matrix's
designs and rows, their configurations on the port and on the reference,
and the row check (the golden file's own tolerance: 1e-9 on
``avg_mem_parallelism``, exact everywhere else)."""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.bench import get_trace
from repro_torch.core.dse.sweep import _BASE_FU, DesignPoint, _spec_for
from repro_torch.core.sim import ScheduleConfig, TraceBuilder, prepare_trace
from repro_torch.core.sim.arbiter import F_KIND, F_TREE_DEPTH, _NTX_KINDS
from repro_torch.core.sim.trace import FADD, FDIV

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


# lanes whose cycles may pop more than one round (32 candidates) of the
# kernel's deferral scan: scan caps of 872, 296, 32 and 16 deferrals a
# cycle
WIDE_DESIGNS = {
    "hb_ntx-4R2W-b4": DesignPoint("hb_ntx", 4, 2, n_banks=4),
    "h_ntx_rd-4R1W-b4": DesignPoint("h_ntx_rd", 4, 1, n_banks=4),
    "remap-4R2W": DesignPoint("remap", 4, 2, 1),
    "banked1": DesignPoint("banked", 1, 1, 1),
}


def wide_configs(pt, designs=tuple(WIDE_DESIGNS)) -> list:
    """``designs`` of :data:`WIDE_DESIGNS` over every array of ``pt``,
    at the golden matrix's unroll 1."""
    out = []
    for name in designs:
        dp = WIDE_DESIGNS[name]
        out.append(ScheduleConfig(
            mem={aid: _spec_for(dp, pt.array_depths[aid],
                                pt.trace.word_bytes[aid] * 8)
                 for aid in pt.trace.array_names},
            fu_counts=dict(_BASE_FU)))
    return out


def hub_trace(fan_in: int):
    """One FADD fed by ``fan_in`` loads of one array (all ready at once,
    ``fan_in`` candidates in the first cycle), then a store."""
    tb = TraceBuilder("hub")
    a = tb.declare_array("a", 4)
    loads = [tb.load(a, i % 64) for i in range(fan_in)]
    hub = tb.op(FADD, *loads)
    tb.store(a, 0, (tb.op(FDIV, hub, hub),))
    return tb.build()


def many_arrays_trace(n_arrays: int = 20, per_array: int = 48):
    """``n_arrays`` arrays (more than a CTA's 16 warps), each read
    ``per_array`` times at once over 16 words and each read copied to
    another word: every array scans many candidates in the same
    cycles."""
    tb = TraceBuilder("many")
    for k in range(n_arrays):
        a = tb.declare_array(f"a{k}", 4)
        for i in range(per_array):
            x = tb.load(a, (5 * i + k) % 16)
            tb.store(a, (3 * i + k) % 16, (x,))
    return tb.build()


# NTX designs (kind, reads, writes, depth) at array depths that are not
# powers of two: trees of 100 (h_ntx_rd), 51 (b_ntx_wr) and 52 (hb_ntx)
# words in a batch whose per-word depth D is 128
ODD_DEPTH_SPECS = (("hb_ntx", 4, 2, 104), ("b_ntx_wr", 1, 2, 102),
                   ("h_ntx_rd", 4, 1, 100))


def odd_depth_trace(builder=TraceBuilder):
    """Six rounds over one array of 104 words: 40 loads ready at once
    (parity paths), then 8 stores fed by them (write pairs), each round
    after the last store of the one before.  ``builder`` is the
    ``TraceBuilder`` of the port or of the reference."""
    tb = builder("odd_depth")
    a = tb.declare_array("a", 4)
    prev = ()
    for r in range(6):
        loads = [tb.load(a, (13 * i + 5 * r) % 104, prev)
                 for i in range(40)]
        stores = [tb.store(a, (29 * j + 3 * r) % 104, (loads[j],))
                  for j in range(8)]
        prev = (stores[-1],)
    return tb.build()


def odd_depth_configs(config=ScheduleConfig, spec=AMMSpec) -> list:
    """:data:`ODD_DEPTH_SPECS` at leaf sub-banking 1 and 4 over the
    array of :func:`odd_depth_trace` (``config`` and ``spec``: the
    port's types or the reference's)."""
    return [config(mem={0: spec(kind, rd, wr, depth, 32, n_banks=sub)},
                   fu_counts={}, mem_latency=2)
            for kind, rd, wr, depth in ODD_DEPTH_SPECS for sub in (1, 4)]


def past_the_tree(desc: np.ndarray) -> np.ndarray:
    """Descriptor rows whose NTX trees are cut to an odd depth below the
    one the spec gives, so that some in-tree addresses lie past the
    tree: rows that the zero-padded leaf tables held as zeros, which no
    valid spec reaches (``AMMSpec`` keeps every address inside)."""
    out = desc.copy()
    td = out[..., F_TREE_DEPTH]
    ntx = np.isin(out[..., F_KIND], _NTX_KINDS)
    out[..., F_TREE_DEPTH] = np.where(ntx, td - 1 - (td & 1), td)
    return out


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
