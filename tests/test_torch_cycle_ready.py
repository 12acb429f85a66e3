"""The ``cycle_lanes`` kernel's incremental ready set, on the CPU.

The kernel keeps its ready set from one simulated cycle to the next: a
pending-predecessor count per priority position, seeded from the
in-degree, and a finish wheel of in-flight positions whose drain at the
start of a cycle retires what has finished and decrements its
successors' counts.  It reads the trace in the position space that
``core/sim/batched_cycle.py::_kernel_layout`` builds on the host.  This
file holds that layout to the ``PreparedTrace`` it comes from, and
rehearses the bookkeeping in numpy over the reference C loop's event
logs: at every cycle the lane loop visits, the incremental ready set,
the retired count and the next finish must equal those of the full scan
the plain version does (every node tested against its predecessors'
finishes), and the lane must end at the cycle and with the error code of
``cycle_lanes_plain``.  The cases cover latency-0 loads (``mem_latency``
0), a long load latency (7), idle-cycle jumps and a lane that passes
its ``max_cycles`` during a jump.  Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest

from _torch_sched_util import (golden_configs, hub_trace,
                              one_thread, ref_config)  # noqa: F401
from repro.core.bench import get_trace as ref_get_trace
from repro.core.sim import prepare_trace as ref_prepare
from repro.core.sim.scheduler import schedule_events as ref_schedule_events
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.sim import ScheduleConfig, prepare_trace
from repro_torch.core.sim.batched_cycle import (_lane_inputs, _pack_pending,
                                                lane_outputs)
from repro_torch.kernels.cycle_lanes import (ERR_DEADLOCK, ERR_MAX_CYCLES,
                                             ERR_NONE, INT32_INF)

pytestmark = pytest.mark.usefixtures("one_thread")


def _unpack(ins, sc, n):
    return np.ascontiguousarray(ins["pend0"]).view(
        f"<u{sc.pend_bits // 8}")[:n].astype(np.int64)


def _check_layout(pt, cfgs):
    sc, ins = _lane_inputs(pt, cfgs)
    dv = pt.device_views()
    n = dv.n_real
    perm = dv.perm[:n].astype(np.int64)
    assert np.array_equal(np.sort(perm), np.arange(n))
    # the successor CSR by position is PreparedTrace's, relabelled
    ptr = ins["succ_ptr"].astype(np.int64)
    assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
    assert np.array_equal(np.diff(ptr), np.diff(pt.succ_ptr)[perm])
    dst = ins["succ_pos"][:ptr[-1]].astype(np.int64)
    for i in range(n):
        node = perm[i]
        assert np.array_equal(
            perm[dst[ptr[i]:ptr[i + 1]]],
            pt.succ_idx[pt.succ_ptr[node]:pt.succ_ptr[node + 1]])
    # pending seeds: the in-degree by position, in the narrowest width
    assert np.array_equal(_unpack(ins, sc, n), pt.indegree[perm])
    top = int(pt.indegree.max())
    assert sc.pend_bits == min(b for b in (8, 16, 32) if top < 2**b)
    assert ins["pend0"].dtype == np.int32
    assert ins["pend0"].size * 32 >= n * sc.pend_bits
    # per-position latency, load flag and memory word
    assert np.array_equal(ins["x_pos"] >> 1, dv.lat[perm])
    assert np.array_equal((ins["x_pos"] & 1).astype(bool), dv.is_load[perm])
    assert np.array_equal(ins["word_pos"], dv.word_idx[perm])
    # the wheel: the least power of two above the largest latency
    ld = dv.is_load[perm]
    top_lat = max(int(dv.lat[perm][~ld].max(initial=0)),
                  max(c.mem_latency for c in cfgs) if ld.any() else 0)
    w = sc.wheel_slots
    assert w & (w - 1) == 0 and w > top_lat and w // 2 <= top_lat
    assert 1 <= sc.wheel_depth <= max(n, 1)
    return sc, ins


@pytest.mark.parametrize("bench", ["bfs_queue", "md_knn", "stencil2d",
                                   "kv_decode"])
def test_kernel_layout_matches_prepared_trace(bench):
    pt, _, cfgs = golden_configs(bench)
    _check_layout(pt, cfgs)


def test_kernel_layout_of_a_wide_node_and_the_pending_widths():
    """A node with 300 predecessors needs 16-bit counts; the packing
    is little-endian, two counts a word (four at 8 bits, one at 32)."""
    pt = prepare_trace(hub_trace(300))
    cfg = ScheduleConfig(mem={0: AMMSpec("ideal", 2, 2, 64)}, fu_counts={})
    sc, _ = _check_layout(pt, [cfg])
    assert sc.pend_bits == 16
    for top, bits in ((0, 8), (255, 8), (256, 16), (65535, 16),
                      (65536, 32), (2**31 - 1, 32)):
        deg = np.array([top, 1, 0, 3, 2], np.int64)
        got_bits, words = _pack_pending(deg)
        assert got_bits == bits and words.dtype == np.int32
        per = 32 // bits
        assert words.size == -(-deg.size // per)
        u = words.view(np.uint32).astype(np.int64)
        mask = (1 << bits) - 1
        unpacked = [(u[i // per] >> (bits * (i % per))) & mask
                    for i in range(deg.size)]
        assert unpacked == list(deg)
    assert _pack_pending(np.zeros(0, np.int64))[1].size == 1


def _plain_raw(pt, cfgs, record=False):
    """``cycle_lanes`` on CPU tensors (``cycle_lanes_plain``): its raw
    outputs for every lane, as numpy arrays."""
    sc, ins = _lane_inputs(pt, cfgs)
    return [o.numpy() for o in lane_outputs(pt, sc, ins, "cpu",
                                            record=record)]


def _plain_lanes(pt, cfgs):
    """``cycle_lanes_plain``'s cycles and error code of every lane."""
    out = _plain_raw(pt, cfgs)
    return out[0], out[3]


@dataclasses.dataclass
class Rehearsal:
    err: int
    cycle: int            # the lane's cycles output
    visited: "list[int]"  # the cycles the loop visited
    jumps: "list[tuple[int, int]]"   # idle-cycle jumps (from, to)
    zero_latency: int     # positions retired the cycle after they issued
    deepest: int          # most positions a wheel bucket held


def rehearse(pt, sc, ins, ev_cycle, mem_latency, max_cycles):
    """Replay the kernel's pending counts and finish wheel over one
    lane's event log (node ``i`` issued at ``ev_cycle[i]``) and hold
    every visited cycle to the full scan; returns the lane's end."""
    n = pt.device_views().n_real
    perm = ins["perm"][:n].astype(np.int64)
    x = ins["x_pos"].astype(np.int64)
    ld = (x & 1) == 1
    iss = ev_cycle[perm].astype(np.int64)
    never = iss < 0                       # not issued before the end
    iss = np.where(never, np.iinfo(np.int64).max // 2, iss)
    fin = iss + np.where(ld, mem_latency, x >> 1)
    ptr = ins["succ_ptr"].astype(np.int64)
    succ = ins["succ_pos"].astype(np.int64)
    src = np.repeat(np.arange(n), np.diff(ptr))
    dst = succ[:ptr[-1]]
    W, depth = sc.wheel_slots, sc.wheel_depth
    pending = _unpack(ins, sc, n)
    ready = pending == 0
    bucket = [[] for _ in range(W)]
    bucket_fin = [0] * W
    cycle, remaining, err = 0, n, ERR_NONE
    out = Rehearsal(ERR_NONE, 0, [], [], 0, 0)
    while remaining > 0 and err == ERR_NONE:
        if cycle > max_cycles:
            err = ERR_MAX_CYCLES
        out.visited.append(cycle)
        # retire: drain every bucket due by this cycle
        for b in range(W):
            if bucket[b] and bucket_fin[b] <= cycle:
                for i in bucket[b]:
                    out.zero_latency += fin[i] == cycle - 1 == iss[i]
                    for q in succ[ptr[i]:ptr[i + 1]]:
                        pending[q] -= 1
                        ready[q] = ready[q] or pending[q] == 0
                remaining -= len(bucket[b])
                bucket[b] = []
        # the full scan: not issued, every predecessor retired
        retired = (iss < cycle) & (fin <= cycle)
        blocked = np.bincount(dst, weights=~retired[src], minlength=n)
        full = (iss >= cycle) & (blocked == 0)
        assert np.array_equal(ready, full), cycle
        assert remaining == n - int(retired.sum()), cycle
        # issue what the log issues this cycle
        now = np.flatnonzero(iss == cycle)
        assert ready[now].all(), cycle
        ready[now] = False
        for i in now:
            b = fin[i] % W
            assert not bucket[b] or bucket_fin[b] == fin[i], "two finishes"
            bucket[b].append(i)
            bucket_fin[b] = fin[i]
            out.deepest = max(out.deepest, len(bucket[b]))
        # the clock: the next finish from the wheel, as from the scan
        live = [bucket_fin[b] for b in range(W)
                if bucket[b] and bucket_fin[b] > cycle]
        next_fin = min(live, default=INT32_INF)
        flying = (iss <= cycle) & (fin > cycle)
        assert next_fin == int(fin[flying].min(initial=INT32_INF)), cycle
        still_ready = bool(ready.any())
        ncycle = cycle + 1
        if not still_ready and next_fin != INT32_INF and next_fin > ncycle:
            out.jumps.append((cycle, next_fin))
            ncycle = next_fin
        if (err == ERR_NONE and not still_ready and next_fin == INT32_INF
                and remaining > 0):
            err = ERR_DEADLOCK
        cycle = ncycle
    assert out.deepest <= depth
    out.err, out.cycle = err, cycle
    return out


def _reference_logs(bench, pt, cfgs, source="c"):
    """The reference's (result, event log) of each config: its C loop,
    or its JAX batched backend (``jax_cycle``), whose rules the kernel
    ports; they part at ``mem_latency`` 0 (ROADMAP.md, section C)."""
    rpt = ref_prepare(ref_get_trace(bench))
    rcfgs = [ref_config(rpt, c) for c in cfgs]
    if source == "jax":
        from repro.core.sim import jax_cycle
        return list(zip(*jax_cycle.schedule_batched(rpt, rcfgs,
                                                    collect_events=True)))
    return [ref_schedule_events(rpt, c, backend="c") for c in rcfgs]


@pytest.mark.parametrize("bench,mem_latency,source,expect", [
    ("kmp", 2, "c", "jumps"), ("radix_sort", 2, "c", "jumps"),
    ("md_knn", 2, "c", "done"), ("bfs_queue", 7, "c", "jumps"),
    ("viterbi", 7, "c", "jumps"), ("gemm_ncubed", 0, "jax", "zero"),
    ("spmv_crs", 0, "jax", "zero"), ("kmp", 0, "c", "deadlock")])
def test_incremental_ready_set_equals_the_full_scan(bench, mem_latency,
                                                   source, expect):
    """``expect`` names what the case must exercise: idle-cycle jumps,
    latency-0 loads retired the cycle after they issue, or the deadlock
    the JAX rules report at ``mem_latency`` 0 when a cycle's last issue
    is a latency-0 load with nothing else in flight (the C loop goes
    on; its log up to there is the JAX rules' too)."""
    pt, _, cfgs = golden_configs(bench)
    cfgs = [dataclasses.replace(c, mem_latency=mem_latency)
            for c in cfgs[::4]]
    sc, ins = _lane_inputs(pt, cfgs)
    cycles, errs = _plain_lanes(pt, cfgs)
    runs = []
    for lane, (cfg, (res, ev)) in enumerate(
            zip(cfgs, _reference_logs(bench, pt, cfgs, source))):
        got = rehearse(pt, sc, ins, np.asarray(ev.cycle), mem_latency,
                       cfg.max_cycles)
        assert (got.err, got.cycle) == (errs[lane], cycles[lane])
        if got.err == ERR_NONE:
            assert got.cycle == res.cycles
        runs.append(got)
    if expect == "jumps":
        assert all(r.jumps for r in runs)
    elif expect == "zero":
        assert all(r.zero_latency > 0 for r in runs)
    elif expect == "deadlock":
        assert all(r.err == ERR_DEADLOCK for r in runs)
    assert expect == "deadlock" or all(r.err == ERR_NONE for r in runs)


def test_a_lane_passing_max_cycles_during_a_jump():
    """Take a lane's first idle-cycle jump ``c -> c'`` and set its
    ``max_cycles`` to ``c + 1``: the loop visits no cycle in between, so
    the error fires at ``c'``, in the rehearsal as in the plain version,
    which ends the lane one cycle step later."""
    pt, _, cfgs = golden_configs("kmp")
    cfg = cfgs[0]
    (res, ev), = _reference_logs("kmp", pt, [cfg])
    sc, ins = _lane_inputs(pt, [cfg])
    clean = rehearse(pt, sc, ins, ev.cycle, cfg.mem_latency,
                     cfg.max_cycles)
    assert clean.err == ERR_NONE and clean.cycle == res.cycles
    start, end = clean.jumps[len(clean.jumps) // 2]
    capped = dataclasses.replace(cfg, max_cycles=start + 1)
    got = rehearse(pt, sc, ins, ev.cycle, cfg.mem_latency, start + 1)
    assert got.err == ERR_MAX_CYCLES
    assert got.visited[-1] == end and start + 1 not in got.visited
    cycles, errs = _plain_lanes(pt, [capped])
    assert (errs[0], cycles[0]) == (got.err, got.cycle)


def test_a_lane_stopped_in_error_freezes_as_the_jax_lane_does():
    """At ``mem_latency`` 0 viterbi's lanes end in deadlock at different
    cycles (101 to 224).  JAX's batched ``while_loop`` keeps a stopped
    lane's state; so must the plain version, whose raw outputs (event
    log and final maps included) equal the JAX lane loop's."""
    from unittest import mock

    from repro.core.sim import jax_cycle

    pt, _, cfgs = golden_configs("viterbi")
    cfgs = [dataclasses.replace(c, mem_latency=0) for c in cfgs[::2]]
    rpt = ref_prepare(ref_get_trace("viterbi"))
    raw = {}
    compiled = jax_cycle._compiled

    def keep_outputs(sc, collect):
        fn = compiled(sc, collect)

        def run(*args):
            raw["jax"] = [np.asarray(o) for o in fn(*args)]
            return raw["jax"]
        return run

    with mock.patch.object(jax_cycle, "_compiled", keep_outputs):
        with pytest.raises(RuntimeError, match="deadlock"):
            jax_cycle.schedule_batched(
                rpt, [ref_config(rpt, c) for c in cfgs], collect_events=True)
    got = _plain_raw(pt, cfgs, record=True)
    assert (got[3] == ERR_DEADLOCK).all()
    assert len(set(got[0].tolist())) > 1      # they stop at other cycles
    for g, want in zip(got, raw["jax"]):
        np.testing.assert_array_equal(g, want)
