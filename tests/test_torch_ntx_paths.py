"""The NTX leaf paths that ``cycle_lanes`` computes from an array's
descriptor row, on the CPU.

The lane loop reads no per-word table: a word's direct leaf, offset and
parity leaves come from its in-tree address ``ta`` (clamped to
``D - 1``), the tree depth and the levels.  ``ntx_leaf_paths``, the
plain version's helper, is held to ``arbiter.ntx_tables`` zero-padded to
``D`` rows as the batch layer once built it, at every address below
``D``, the rows past the tree included.  The plain lanes are held to the
JAX package's ``jax_cycle`` (which reads such padded tables) and to the
reference's C loop (which walks the tree at each access) on NTX designs
whose depths are not powers of two.  No valid spec reaches a row past
its tree, so descriptor rows cut below the spec's tree depth reach them,
and there the plain lanes are held to ``jax_cycle``'s lane alone: the C
loop walks such an address as if it lay inside.
"""
import numpy as np
import pytest
import torch

from _torch_sched_util import (ODD_DEPTH_SPECS, odd_depth_configs,
                               odd_depth_trace, one_thread,  # noqa: F401
                               past_the_tree)
from repro.core.amm.spec import AMMSpec as RefSpec
from repro.core.sim import TraceBuilder as RefTraceBuilder
from repro.core.sim import jax_cycle
from repro.core.sim import prepare_trace as ref_prepare
from repro.core.sim.arbiter import ntx_tables as ref_ntx_tables
from repro.core.sim.scheduler import ScheduleConfig as RefConfig
from repro.core.sim.scheduler import schedule_events as ref_schedule_events
from repro_torch.core.sim import prepare_trace
from repro_torch.core.sim.arbiter import (F_DEPTH, F_HALF, F_KIND,
                                          F_LEVELS, F_TREE_DEPTH, KIND_H_NTX,
                                          _NTX_KINDS, ntx_tables)
from repro_torch.core.sim.batched_cycle import (_lane_inputs, lane_outputs,
                                                schedule_batched)
from repro_torch.core.sim.prepared import _next_pow2
from repro_torch.kernels.cycle_lanes import ntx_leaf_paths

I32 = torch.int32
PP = 8                                    # the widest fan-out, 2**3


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("tree_depth", [1, 2, 3, 7, 8, 129, 8320, 16384])
def test_leaf_paths_match_the_padded_tables(tree_depth, levels):
    D = _next_pow2(tree_depth + 1)        # rows past the tree exist
    direct, offset, parity = ntx_tables(tree_depth, levels)
    want = (np.zeros(D, np.int64), np.zeros(D, np.int64),
            np.zeros((D, PP), np.int64))
    want[0][:tree_depth] = direct
    want[1][:tree_depth] = offset
    want[2][:tree_depth, :parity.shape[1]] = parity
    # every address below D, and past it clamped to D - 1 as the lanes do
    ta = torch.arange(D + 3, dtype=I32).clamp(max=D - 1)
    got = ntx_leaf_paths(ta, torch.tensor(tree_depth, dtype=I32),
                         torch.tensor(levels, dtype=I32), PP)
    for g, w in zip(got, want):
        assert g.dtype == I32
        np.testing.assert_array_equal(g.numpy(), w[ta.numpy()])
    assert bool((ta >= tree_depth).any())


def _reference_side():
    rpt = ref_prepare(odd_depth_trace(RefTraceBuilder))
    return rpt, odd_depth_configs(RefConfig, RefSpec)


def _of_kind(cfgs, kind):
    return [c for c in cfgs if c.mem[0].kind == kind]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("kind", [k for k, *_ in ODD_DEPTH_SPECS])
def test_odd_depth_lanes_match_jax_and_the_c_loop(kind):
    pt = prepare_trace(odd_depth_trace())
    cfgs = _of_kind(odd_depth_configs(), kind)
    rpt, rcfgs = _reference_side()
    rcfgs = _of_kind(rcfgs, kind)
    res, maps, logs = schedule_batched(pt, cfgs, device="cpu",
                                       return_maps=True, collect_events=True)
    jres, jmaps, jlogs = jax_cycle.schedule_batched(
        rpt, rcfgs, return_maps=True, collect_events=True)
    np.testing.assert_array_equal(maps, np.asarray(jmaps))
    for r, log, jr, jlog, rcfg in zip(res, logs, jres, jlogs, rcfgs):
        crs, clog = ref_schedule_events(rpt, rcfg, backend="c")
        assert r.__dict__ == jr.__dict__ == crs.__dict__
        for f in ("cycle", "path", "resource", "slot"):
            np.testing.assert_array_equal(getattr(log, f), getattr(jlog, f))
            np.testing.assert_array_equal(getattr(log, f), getattr(clog, f))
    # the lanes take parity paths (reads) or write pairs (b and hb)
    assert any(r.parity_path_reads for r in res) or \
        any(r.write_pair_rmws for r in res)


def _jax_lanes(rpt, sc, ins, record):
    """``jax_cycle``'s lane over the port's per-lane inputs ``ins``, with
    the zero-padded leaf tables built from its descriptor rows by the
    reference's ``ntx_tables``."""
    desc = ins["desc"]
    L, A = desc.shape[:2]
    D = sc.table_depth
    pp = 1 << int(desc[..., F_LEVELS].max())
    direct = np.zeros((L, A, D), np.int32)
    offset = np.zeros((L, A, D), np.int32)
    parity = np.zeros((L, A, D, pp), np.int32)
    for b in range(L):
        for a in range(A):
            if desc[b, a, F_KIND] not in _NTX_KINDS:
                continue
            td = int(desc[b, a, F_TREE_DEPTH])
            dr, off, par = ref_ntx_tables(td, int(desc[b, a, F_LEVELS]))
            direct[b, a, :td], offset[b, a, :td] = dr, off
            parity[b, a, :td, :par.shape[1]] = par
    dv = rpt.device_views()
    rsc = jax_cycle.StaticCfg(
        n_pad=sc.n_pad, n_preds_max=sc.n_preds_max, a_pad=sc.a_pad,
        scan_slots=sc.scan_slots, key_space=sc.key_space,
        bank_slots=sc.bank_slots, table_depth=D, parity_paths=pp)
    out = jax_cycle._compiled(rsc, record)(
        desc, ins["fu_budgets"], ins["mem_latency"], ins["ppb"],
        ins["max_cycles"], direct, offset, parity, np.int32(dv.n_real),
        dv.preds_pad, dv.lat, dv.is_load, dv.word_idx, dv.perm,
        dv.gid_perm, dv.seg_start)
    return [np.asarray(o) for o in out]


def _past_the_tree_share(pt, desc) -> np.ndarray:
    """For each lane, how many of the trace's memory accesses fall on an
    in-tree address at or past its array's (cut) tree depth."""
    w = pt.device_views().word_idx[:pt.device_views().n_real]
    w = w[np.asarray(pt.trace.array_ids) >= 0].astype(np.int64)
    out = []
    for row in desc[:, 0]:
        a = w % row[F_DEPTH]
        tree = 0 if row[F_KIND] == KIND_H_NTX else (a >= row[F_HALF])
        out.append(int((a - tree * row[F_HALF] >= row[F_TREE_DEPTH]).sum()))
    return np.array(out)


@pytest.mark.usefixtures("one_thread")
def test_lanes_past_the_tree_match_jax():
    """Descriptor rows cut to odd tree depths (:func:`past_the_tree`):
    addresses past the tree take leaf 0, offset 0 and parity leaves 0 as
    the padded tables gave them, in every output of the lanes, event
    logs and maps included."""
    pt = prepare_trace(odd_depth_trace())
    sc, ins = _lane_inputs(pt, odd_depth_configs())
    ins = dict(ins, desc=past_the_tree(ins["desc"]))
    assert (_past_the_tree_share(pt, ins["desc"]) > 0).all()
    rpt, _ = _reference_side()
    got = [o.numpy() for o in lane_outputs(pt, sc, ins, "cpu", record=True)]
    want = _jax_lanes(rpt, sc, ins, True)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # and the cut rows schedule otherwise than the spec's own
    _, whole = _lane_inputs(pt, odd_depth_configs())
    plain = lane_outputs(pt, sc, whole, "cpu", record=True)
    assert not torch.equal(plain[5], torch.from_numpy(got[5]))
