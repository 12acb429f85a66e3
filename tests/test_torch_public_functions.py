"""Three public functions of the port against the JAX package's, on the
CPU, with the same numpy inputs:

* ``core/amm/banked.py``: ``bank_of``, ``conflict_cycles`` and
  ``conflict_cycles_grouped`` (the banking timing model), exact;
* ``core/sim/scheduler.py::schedule_events`` (``device="cpu"``: the
  plain lanes) against the reference's C loop
  (``schedule_events(pt, cfg, backend="c")``): result and event log
  equal;
* ``kernels/ref.py::ssd_chunk_ref`` within the reference's SSD
  tolerance, 1e-4;
* the packages ``repro_torch.core``, ``.core.sim`` and ``.core.dse``
  export the reference packages' public names (``__all__``), but for a
  named set that is not ported, and name their own additions: a later
  gap, or an addition left unnamed, fails by name;
* the sweep path's entry points (``run_sweep``, ``evaluate_points``,
  ``schedule_batch``) take the reference's parameters, but for those of
  its process pool and CPU backends, and ``device``.
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sched_util import (golden_configs, one_thread,  # noqa: F401
                              ref_config)
from repro.core.amm import banked as ref_banked
from repro.core.bench import get_trace as ref_get_trace
from repro.core.sim import prepare_trace as ref_prepare
from repro.core.sim.scheduler import schedule_events as ref_schedule_events
from repro.kernels import ref as jax_ref
from repro_torch.core.amm import banked
from repro_torch.core.sim import schedule_events
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.ssd_scan import ssd_chunk_step_plain


def _mask(kind, rng, shape):
    if kind == "all":
        return np.ones(shape, bool)
    if kind == "none":
        return np.zeros(shape, bool)
    return rng.random(shape) < 0.5


@pytest.mark.parametrize("mask", ["all", "none", "random"])
@pytest.mark.parametrize("ports", [1, 2])
@pytest.mark.parametrize("n_banks", [1, 3, 8])
def test_conflict_cycles_match_jax(n_banks, ports, mask):
    rng = np.random.default_rng(n_banks * 10 + ports)
    addrs = rng.integers(0, 1 << 20, (24, 16)).astype(np.int32)
    addrs[0] = 7                                  # every access one bank
    addrs[1] = np.arange(16) * n_banks + 1        # one bank, strided
    addrs[2] = np.arange(16)                      # cyclic, spread
    masks = _mask(mask, rng, addrs.shape)
    want = np.asarray(ref_banked.conflict_cycles_grouped(
        jnp.asarray(addrs), jnp.asarray(masks), n_banks, ports))
    got = banked.conflict_cycles_grouped(torch.from_numpy(addrs),
                                         torch.from_numpy(masks), n_banks,
                                         ports)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for a, m in zip(addrs[:4], masks[:4]):
        one = banked.conflict_cycles(torch.from_numpy(a),
                                     torch.from_numpy(m), n_banks, ports)
        assert int(one) == int(ref_banked.conflict_cycles(
            jnp.asarray(a), jnp.asarray(m), n_banks, ports))
    np.testing.assert_array_equal(
        banked.bank_of(torch.from_numpy(addrs), n_banks).numpy(),
        np.asarray(ref_banked.bank_of(jnp.asarray(addrs), n_banks)))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("design", ["banked4", "hb_ntx-4R2W-b4",
                                    "remap-2R2W"])
def test_schedule_events_matches_reference_c_loop(design):
    pt, rows, cfgs = golden_configs("paged_kv")
    row, cfg = next((g, c) for g, c in zip(rows, cfgs)
                    if g["design"] == design and g["unroll"] == 4)
    res, log = schedule_events(pt, cfg, device="cpu")
    rpt = ref_prepare(ref_get_trace("paged_kv"))
    rres, rlog = ref_schedule_events(rpt, ref_config(rpt, cfg),
                                     backend="c")
    assert res.__dict__ == rres.__dict__
    assert res.cycles == row["cycles"]
    for f in ("cycle", "path", "resource", "slot"):
        np.testing.assert_array_equal(getattr(log, f), getattr(rlog, f),
                                      err_msg=f)
    assert (log.cycle >= 0).all()


@pytest.mark.parametrize("bt,h,q,p,n", [(1, 2, 8, 4, 4), (2, 3, 12, 8, 6),
                                        (2, 4, 64, 16, 32)])
def test_ssd_chunk_ref_matches_jax(bt, h, q, p, n):
    rng = np.random.default_rng(q)
    x = rng.standard_normal((bt, h, q, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (bt, h, q)).astype(np.float32)
    cum = np.cumsum(-dt * np.linspace(1, 4, h, dtype=np.float32)[None, :,
                                                                  None],
                    axis=-1).astype(np.float32)
    B = rng.standard_normal((bt, q, n)).astype(np.float32)
    C = rng.standard_normal((bt, q, n)).astype(np.float32)
    h0 = rng.standard_normal((bt, h, p, n)).astype(np.float32)
    ins = (x, dt, cum, B, C, h0)
    want_y, want_h = (np.asarray(a) for a in jax_ref.ssd_chunk_ref(
        *(jnp.asarray(a) for a in ins)))
    got_y, got_h = torch_ref.ssd_chunk_ref(*(torch.from_numpy(a)
                                             for a in ins))
    assert got_y.dtype == got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), want_y, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-4, rtol=1e-4)
    plain_y, plain_h = ssd_chunk_step_plain(*(torch.from_numpy(a)
                                              for a in ins))
    torch.testing.assert_close(got_y, plain_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_h, plain_h, atol=1e-4, rtol=1e-4)


# the reference's exports that the port does not carry (ROADMAP's
# not-to-port list: the JAX-only locality, the C loop's arbiter, the
# process pool and the CPU backends) and the port's own additions
NOT_PORTED = {
    "core": {"spatial_locality_jax"},
    "core.sim": {"PortArbiter"},
    "core.dse": {"BACKENDS", "kill_pool", "shutdown_pool"},
}
PORT_ONLY = {
    "core": set(),
    "core.sim": set(),
    "core.dse": {"grid_predictions", "select_band", "predict",
                 "DEFAULT_MARGIN"},
}


@pytest.mark.parametrize("package", sorted(NOT_PORTED))
def test_packages_export_the_reference_s_public_names(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    assert NOT_PORTED[package] <= set(ref.__all__)
    missing = set(ref.__all__) - NOT_PORTED[package] - set(port.__all__)
    assert not missing, f"repro_torch.{package} lacks {sorted(missing)}"
    extra = set(port.__all__) - set(ref.__all__) - PORT_ONLY[package]
    assert not extra, f"repro_torch.{package} adds {sorted(extra)}"
    assert len(port.__all__) == len(set(port.__all__))
    for name in set(ref.__all__) - NOT_PORTED[package]:
        want = getattr(ref, name)
        if isinstance(want, (int, str, tuple, dict)):   # constants: equal
            assert repr(getattr(port, name)) == repr(want), name
        else:
            assert getattr(port, name).__name__ == want.__name__, name


# the reference runner's parameters of its process pool and CPU backends
NOT_PORTED_PARAMS = {"jobs", "backend", "chunk_timeout", "chunk_retries"}


def _params(fn) -> dict:
    """Each parameter's kind and default (by repr: the packages' design
    points are equal dataclasses of two classes)."""
    return {p.name: (p.kind, repr(p.default))
            for p in inspect.signature(fn).parameters.values()}


@pytest.mark.parametrize("module, name", [
    ("core.dse.runner", "run_sweep"), ("core.dse.sweep", "evaluate_points"),
    ("core.sim.scheduler", "schedule_batch")])
def test_sweep_path_takes_the_reference_s_parameters(module, name):
    ref = _params(getattr(importlib.import_module(f"repro.{module}"), name))
    port = _params(getattr(importlib.import_module(f"repro_torch.{module}"),
                           name))
    want = {k: v for k, v in ref.items() if k not in NOT_PORTED_PARAMS}
    want["device"] = (inspect.Parameter.KEYWORD_ONLY, "None")
    assert port == want
