"""The port's fault layer against the JAX reference, on the CPU.

Fault populations and their masks must equal JAX's; the fault-injected
replay must equal JAX's on the same masks, bit for bit; the campaigns
must reproduce every row of ``tests/golden_faults.json`` exactly (the
port reads the file and never writes it); and ``attach_resilience`` must
fill JAX ``run_sweep`` points with the same ``res_*`` fields as JAX's own
``run_sweep(faults=...)``.  The port's copies of ``fault/metrics.py``
and of the three names of ``dse/sweep.py`` are held equal to the
reference.
"""
import dataclasses
import importlib
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core.amm import replay as jrp
from repro.core.fault import FaultConfig as JaxFaultConfig
from repro.core.fault import build_masks as jax_build_masks
from repro.core.fault import metrics as jax_metrics
from repro.core.fault import sample_faults as jax_sample_faults
from repro.core.fault import state_geometry as jax_state_geometry
from repro.core.fault import tile_states as jax_tile_states
from repro_torch.convert import (fault_mask_from_numpy, flat_state_to_numpy,
                                 words_to_numpy)
from repro_torch.core.amm import replay as rp
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.fault import (COVER, RES_FIELDS, FaultConfig,
                                    FaultSpec, Resilience, attach_resilience,
                                    build_masks, design_resilience,
                                    resilience_fields, run_campaign,
                                    sample_faults, state_geometry,
                                    tile_states)
from repro_torch.core.fault import campaign as campaign_mod
from test_fault import SPECS as FAULT_SPECS
from test_torch_replay import port_spec

# the modules: ``repro.core.dse`` and ``repro_torch.core.dse`` export a
# function of the same name
jax_sweep = importlib.import_module("repro.core.dse.sweep")
sweep = importlib.import_module("repro_torch.core.dse.sweep")
GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden_faults.json").read_text())
IDS = [s.describe() for s in FAULT_SPECS]


def _trace_and_init(spec, n_cycles, seed=11, write_prob=0.5):
    rng = np.random.default_rng(seed)
    ops = jrp.make_trace(spec, n_cycles, rng=rng, write_prob=write_prob)
    return ops, rng.integers(0, 1 << 32, spec.depth, dtype=np.uint32)


# ------------------------------------------------------ copied modules
def test_metrics_copy_matches_reference():
    assert COVER == jax_metrics.COVER
    assert RES_FIELDS == jax_metrics.RES_FIELDS
    assert [f.name for f in dataclasses.fields(Resilience)] == \
        [f.name for f in dataclasses.fields(jax_metrics.Resilience)]
    for rec in ((("parity", 32, 287, 7205, 1959, 16, 0, 12.96)),
                ("none", 32, 75, 2120, 0, 0, 266, -1.0),
                ("replica", 0, 0, 0, 0, 0, 0, -1.0)):
        got, want = Resilience(*rec), jax_metrics.Resilience(*rec)
        assert got.summary() == want.summary()
        assert resilience_fields(got) == jax_metrics.resilience_fields(want)


def test_sweep_copy_matches_reference():
    assert [dataclasses.astuple(d) for d in sweep.DEFAULT_DESIGNS] == \
        [dataclasses.astuple(d) for d in jax_sweep.DEFAULT_DESIGNS]
    for got, want in zip(sweep.DEFAULT_DESIGNS, jax_sweep.DEFAULT_DESIGNS):
        assert (got.label, got.is_amm) == (want.label, want.is_amm)
        for depth, width in ((256, 32), (8, 16), (1024, 64), (4, 8)):
            a = sweep._spec_for(got, depth, width)
            b = jax_sweep._spec_for(want, depth, width)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            assert a.describe() == b.describe()


# --------------------------------------------------- fault populations
@pytest.mark.parametrize("spec", FAULT_SPECS, ids=IDS)
def test_sample_faults_and_masks_match_jax(spec):
    ts = port_spec(spec)
    assert state_geometry(ts) == jax_state_geometry(spec)
    got = sample_faults(ts, 24, seed=3, n_cycles=40)
    want = jax_sample_faults(spec, 24, seed=3, n_cycles=40)
    assert [dataclasses.astuple(f) for f in got] == \
        [dataclasses.astuple(f) for f in want]
    masks = build_masks(ts, got, "cpu")
    j_masks = jax_build_masks(spec, want)
    assert masks.cycle.dtype == torch.int32
    np.testing.assert_array_equal(masks.cycle.numpy(),
                                  np.asarray(j_masks.cycle))
    for got_d, want_d in zip(masks[1:], j_masks[1:]):
        assert set(got_d) == set(want_d)
        for k, v in want_d.items():
            assert got_d[k].dtype == torch.int32
            np.testing.assert_array_equal(words_to_numpy(got_d[k]),
                                          np.asarray(v), err_msg=k)


def test_sample_faults_rejects_unknown_kind():
    with pytest.raises(ValueError):
        sample_faults(port_spec(FAULT_SPECS[0]), 4, 0, 8, ("melt",))


def test_build_masks_full_word_bank_loss():
    """A bank loss masks every bit of the bank: 0xFFFFFFFF, -1 as int32."""
    spec = port_spec(FAULT_SPECS[3])                     # h_ntx_rd 4R1W
    masks = build_masks(spec, [FaultSpec("bank_loss", "banks", 2, 0, 0, 0,
                                         5)], "cpu")
    sm = masks.stuck_mask["banks"][0]
    assert torch.all(sm[2] == -1) and torch.all(sm[:2] == 0)
    assert torch.all(masks.stuck_val["banks"] == 0)


# ------------------------------------------------------- fault replay
@pytest.mark.parametrize("spec", FAULT_SPECS, ids=IDS)
def test_zero_fault_replay_equals_clean(spec):
    ts = port_spec(spec)
    ops, vals = _trace_and_init(spec, 48)
    st_c, clean = rp.replay(ts, rp.init_flat(ts, vals, "cpu"), *ops,
                            device="cpu")
    st_f, faulty = rp.replay_faulty(ts, rp.init_flat(ts, vals, "cpu"),
                                    rp.zero_fault(ts, "cpu"), *ops,
                                    device="cpu")
    assert torch.equal(clean.read_vals, faulty.read_vals)
    assert torch.equal(clean.parity_vals, faulty.parity_vals)
    for k in st_c:
        assert torch.equal(st_c[k], st_f[k]), k


@pytest.mark.parametrize("spec", FAULT_SPECS, ids=IDS)
def test_replay_faulty_batched_matches_jax(spec):
    ops, vals = _trace_and_init(spec, 40)
    faults = jax_sample_faults(spec, 12, seed=5, n_cycles=40)
    j_masks = jax_build_masks(spec, faults)
    j_state, j_res = jrp.replay_faulty_batched(
        spec, jax_tile_states(spec, vals, len(faults)), j_masks, *ops,
        share_trace=True)
    ts = port_spec(spec)
    masks = fault_mask_from_numpy(jax.tree.map(np.asarray, j_masks), "cpu")
    t_state, t_res = rp.replay_faulty_batched(
        ts, tile_states(ts, vals, len(faults), "cpu"), masks, *ops,
        share_trace=True, device="cpu")
    np.testing.assert_array_equal(words_to_numpy(t_res.read_vals),
                                  np.asarray(j_res.read_vals))
    np.testing.assert_array_equal(words_to_numpy(t_res.parity_vals),
                                  np.asarray(j_res.parity_vals))
    got = flat_state_to_numpy(t_state)
    for k, v in j_state.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("spec", FAULT_SPECS[3:6], ids=IDS[3:6])
def test_replay_faulty_single_matches_jax(spec):
    ops, vals = _trace_and_init(spec, 32)
    faults = jax_sample_faults(spec, 4, seed=2, n_cycles=32)
    j_masks = jax_build_masks(spec, faults)
    ts = port_spec(spec)
    masks = fault_mask_from_numpy(jax.tree.map(np.asarray, j_masks), "cpu")
    for i in range(len(faults)):
        one = jax.tree.map(lambda a: a[i], j_masks)
        _, j_res = jrp.replay_faulty(spec, jrp.init_flat(spec, vals), one,
                                     *ops)
        t_one = rp.FaultMask(masks.cycle[i], *({k: v[i] for k, v in d.items()}
                                               for d in masks[1:]))
        _, t_res = rp.replay_faulty(ts, rp.init_flat(ts, vals, "cpu"), t_one,
                                    *ops, device="cpu")
        np.testing.assert_array_equal(words_to_numpy(t_res.read_vals),
                                      np.asarray(j_res.read_vals))
        np.testing.assert_array_equal(words_to_numpy(t_res.parity_vals),
                                      np.asarray(j_res.parity_vals))


def test_transient_flip_heals_on_overwrite():
    spec = AMMSpec("ideal", 1, 1, 8, 32)
    T = 6
    ra = np.zeros((T, 1), np.int32)
    wa = np.zeros((T, 1), np.int32)
    wv = np.full((T, 1), 0xABCD, np.uint32)
    wm = np.zeros((T, 1), bool)
    wm[3, 0] = True
    masks = build_masks(spec, [FaultSpec("bit_flip", "mem", 0, 0, 4, 0, 1)],
                        "cpu")
    _, res = rp.replay_faulty_batched(
        spec, tile_states(spec, np.arange(8, dtype=np.uint32) + 100, 1,
                          "cpu"), masks, ra, wa, wv, wm, device="cpu")
    got = words_to_numpy(res.read_vals)[0, :, 0]
    assert got[0] == 100
    assert got[1] == got[2] == 100 ^ (1 << 4)
    assert (got[4:] == 0xABCD).all()


def test_stuck_at_defeats_writes():
    spec = AMMSpec("ideal", 1, 1, 8, 32)
    T = 4
    wm = np.zeros((T, 1), bool)
    wm[1, 0] = True
    masks = build_masks(spec, [FaultSpec("stuck_at", "mem", 0, 0, 0, 0, 0)],
                        "cpu")
    _, res = rp.replay_faulty_batched(
        spec, tile_states(spec, np.full(8, 0xFFFF, np.uint32), 1, "cpu"),
        masks, np.zeros((T, 1), np.int32), np.zeros((T, 1), np.int32),
        np.full((T, 1), 0xFFFF, np.uint32), wm, device="cpu")
    assert (words_to_numpy(res.read_vals)[0, :, 0] == 0xFFFE).all()


@pytest.mark.parametrize("spec", FAULT_SPECS[:3], ids=IDS[:3])
def test_tile_states_lanes_own_their_storage(spec):
    ts = port_spec(spec)
    vals = np.arange(spec.depth, dtype=np.uint32)
    states = tile_states(ts, vals, 3, "cpu")
    for v in states.values():
        assert v.is_contiguous() and v.stride(0) == v[0].numel()
        v[0].fill_(7)
        assert not torch.equal(v[1], v[0])
        assert torch.equal(v[1], v[2])


# ----------------------------------------------------------- campaigns
@pytest.mark.parametrize("row", GOLDEN, ids=lambda r: r["design"])
def test_golden_campaigns_reproduced(row):
    by_label = {d.label: d for d in sweep.DEFAULT_DESIGNS}
    spec = sweep._spec_for(by_label[row["design"]], 256, 32)
    res = run_campaign(spec, FaultConfig(n_faults=32, n_cycles=96, seed=7),
                       device="cpu")
    r = res.resilience
    assert res.spec_label == row["spec"]
    assert r.cover == row["cover"]
    assert (r.n_faults, r.n_reads) == (row["n_faults"], row["n_reads"])
    assert (r.benign, r.corrected, r.detected, r.sdc) == (
        row["benign"], row["corrected"], row["detected"], row["sdc"])
    # the file holds each rate rounded to 9 places
    assert round(r.sdc_rate, 9) == row["sdc_rate"]
    assert round(r.corrected_frac, 9) == row["corrected_frac"]
    assert round(r.detected_frac, 9) == row["detected_frac"]
    assert round(r.det_latency, 9) == row["det_latency"]
    assert list(res.outcomes) == row["outcomes"]


def test_campaign_is_deterministic():
    spec = port_spec(FAULT_SPECS[3])
    cfg = FaultConfig(n_faults=8, n_cycles=48, seed=5)
    assert run_campaign(spec, cfg, "cpu") == run_campaign(spec, cfg, "cpu")
    assert run_campaign(spec, FaultConfig(8, 48, 6), "cpu") \
        != run_campaign(spec, cfg, "cpu")


def test_design_resilience_is_memoised_per_device(monkeypatch):
    dp = sweep.DEFAULT_DESIGNS[8]                         # h_ntx_rd-4R1W
    cfg = FaultConfig(n_faults=4, n_cycles=16, seed=1)
    calls = []
    real = campaign_mod.run_campaign
    monkeypatch.setattr(campaign_mod, "run_campaign",
                        lambda *a: calls.append(a[2]) or real(*a))
    first = design_resilience(dp, 64, 32, cfg, "cpu")
    assert design_resilience(dp, 64, 32, cfg, torch.device("cpu")) is first
    assert calls == ["cpu"]
    key = (dp, 64, 32, cfg, "cpu")
    assert campaign_mod._design_resilience.__wrapped__(*key) == first


def test_attach_resilience_matches_jax_run_sweep():
    from repro.core.bench import get_trace
    from repro.core.dse import run_sweep

    labels = {row["design"] for row in GOLDEN}
    designs = [d for d in jax_sweep.DEFAULT_DESIGNS if d.label in labels]
    trace = get_trace("gemm_ncubed")
    want = run_sweep(trace, designs, (1,),
                     faults=JaxFaultConfig(n_faults=8, n_cycles=48, seed=3))
    clean = run_sweep(trace, designs, (1,))
    got = attach_resilience(clean, designs,
                            cfg=FaultConfig(n_faults=8, n_cycles=48, seed=3),
                            device="cpu")
    assert len(got) == len(want) == len(designs)
    for g, w in zip(got, want):
        assert g.design == w.design
        for f in RES_FIELDS:
            assert getattr(g, f) == getattr(w, f), (g.design, f)
        assert g == w
