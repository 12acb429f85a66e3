"""The port's per-step AMM models (``make_amm``) and the replay-backed
gather oracle against the JAX reference, on the CPU, bit for bit.

As ``tests/test_replay.py`` pins them for JAX: for every spec of
``tests/test_amm.py`` the step path, the port's replay and JAX's step
path give the same reads every cycle, the same final flat state and the
same decoded content.  ``amm_gather_replay_ref`` must equal JAX's on the
``tests/test_kernel_parity.py`` gather grid, odd request counts
included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.amm import make_amm as jax_make_amm
from repro.core.amm import ntx as jax_ntx
from repro.core.amm import replay as jrp
from repro.kernels import ref as jax_ref
from repro_torch.convert import (flat_state_to_numpy, tensor_from_numpy,
                                 words_to_numpy)
from repro_torch.core.amm import AMMSpec, make_amm
from repro_torch.core.amm import ntx
from repro_torch.core.amm import replay as rp
from repro_torch.kernels import ref
from test_amm import DEPTH, SPECS, ram_oracle, random_trace
from test_torch_replay import port_spec

T = 12
IDS = [s.describe() for s in SPECS]


def _step_inputs(ra, wa, wv, wm, t):
    return (torch.from_numpy(ra[t]).long(), torch.from_numpy(wa[t]).long(),
            rp.words(wv[t], "cpu"), torch.from_numpy(wm[t]))


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_step_equals_replay_equals_jax(spec):
    rng = np.random.default_rng(rp.spec_seed(port_spec(spec), "step"))
    init = rng.integers(0, 2**32, DEPTH, dtype=np.uint32)
    ra, wa, wv, wm = random_trace(spec, T, rng)
    want_reads, want_mem = ram_oracle(init, ra, wa, wv, wm)

    jsim = jax_make_amm(spec, jnp.asarray(init))
    sim = make_amm(port_spec(spec), init, device="cpu")
    j_state, state = jsim.state, sim.state
    for t in range(T):
        j_state, j_vals = jsim.step(j_state, jnp.asarray(ra[t]),
                                    jnp.asarray(wa[t]), jnp.asarray(wv[t]),
                                    jnp.asarray(wm[t]))
        state, vals = sim.step(state, *_step_inputs(ra, wa, wv, wm, t))
        np.testing.assert_array_equal(words_to_numpy(vals),
                                      np.asarray(j_vals), err_msg=f"cycle {t}")
        np.testing.assert_array_equal(words_to_numpy(vals), want_reads[t])

    # the step state, flattened, equals JAX's and the port's replay's
    ts = port_spec(spec)
    flat = flat_state_to_numpy(rp.flatten_state(ts, state))
    j_flat = jrp.flatten_state(spec, j_state)
    r_state, result = sim.replay(sim.state, ra, wa, wv, wm)
    r_flat = flat_state_to_numpy(rp.flatten_state(ts, r_state))
    assert set(flat) == set(j_flat) == set(r_flat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], np.asarray(j_flat[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(r_flat[k], flat[k], err_msg=k)
    np.testing.assert_array_equal(words_to_numpy(result.read_vals),
                                  want_reads)
    np.testing.assert_array_equal(words_to_numpy(result.parity_vals),
                                  want_reads)
    np.testing.assert_array_equal(words_to_numpy(sim.peek(state)), want_mem)
    np.testing.assert_array_equal(words_to_numpy(sim.peek(r_state)), want_mem)
    # single reads, both paths, against JAX's on the final state
    addrs = torch.arange(DEPTH)
    np.testing.assert_array_equal(words_to_numpy(sim.read(state, addrs)),
                                  want_mem)
    for a in (0, DEPTH // 2 - 1, DEPTH // 2, DEPTH - 1):
        got = sim.read_parity(state, torch.tensor(a))
        want = jsim.read_parity(j_state, jnp.int32(a))
        assert int(words_to_numpy(got.reshape(1))[0]) == int(want)


@pytest.mark.parametrize("spec", SPECS[1:6], ids=IDS[1:6])
def test_step_leaves_its_input_state_alone(spec):
    sim = make_amm(port_spec(spec), np.arange(DEPTH, dtype=np.uint32),
                   device="cpu")
    before = rp.flatten_state(sim.spec, sim.state)
    before = {k: v.clone() for k, v in before.items()}
    ra, wa, wv, wm = random_trace(spec, 1, np.random.default_rng(0))
    wm[:] = True
    new, _ = sim.step(sim.state, *_step_inputs(ra, wa, wv, wm, 0))
    after = rp.flatten_state(sim.spec, sim.state)
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert not all(torch.equal(rp.flatten_state(sim.spec, new)[k], before[k])
                   for k in before)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_make_amm_replay_faulty_zero_fault_is_clean(spec):
    ts = port_spec(spec)
    sim = make_amm(ts, np.arange(DEPTH, dtype=np.uint32) * 77, device="cpu")
    ops = random_trace(spec, 20, np.random.default_rng(4))
    st_c, clean = sim.replay(sim.state, *ops)
    st_f, faulty = sim.replay_faulty(sim.state, rp.zero_fault(ts, "cpu"),
                                     *ops)
    assert torch.equal(clean.read_vals, faulty.read_vals)
    assert torch.equal(sim.peek(st_c), sim.peek(st_f))


def test_h_step_rejects_multi_write():
    sim = make_amm(AMMSpec("h_ntx_rd", 2, 1, DEPTH), device="cpu")
    with pytest.raises(ValueError):
        ntx.h_step(sim.state, torch.zeros(2, dtype=torch.long),
                   torch.zeros(2, dtype=torch.long),
                   torch.zeros(2, dtype=torch.int32),
                   torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        make_amm(AMMSpec("ideal", 2, 2, DEPTH), np.zeros(3, np.uint32),
                 device="cpu")


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_h_write_single_port_matches_jax(levels):
    """The where-over-both-branches write against JAX's lax.cond write,
    leaf for leaf, then both read paths."""
    init = np.random.default_rng(levels).integers(0, 2**32, 64,
                                                  dtype=np.uint32)
    j_tree = jax_ntx.h_init(jnp.asarray(init), levels)
    tree = ntx.h_init(rp.words(init, "cpu"), levels)
    for a, v in ((3, 0xDEADBEEF), (40, 7), (63, 0xFFFFFFFF), (3, 1)):
        j_tree = jax_ntx.h_write(j_tree, jnp.int32(a), jnp.uint32(v))
        tree = ntx.h_write(tree, torch.tensor(a),
                           rp.words(np.uint32(v), "cpu"))
    j_flat = jrp._h_flatten(j_tree)
    np.testing.assert_array_equal(words_to_numpy(rp._h_flatten(tree)),
                                  np.asarray(j_flat))
    addrs = np.arange(64)
    np.testing.assert_array_equal(
        words_to_numpy(ntx.h_read_parity(tree, torch.from_numpy(addrs))),
        np.asarray(jax_ntx.h_read_parity(j_tree, jnp.asarray(addrs))))


# ------------------------------------------------ replay-backed gather
_JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
RNG = np.random.default_rng(42)


def _gather_case(dtype, v, d, n):
    table = jnp.asarray(RNG.standard_normal((v, d)), _JAX_DTYPE[dtype])
    idx = RNG.integers(0, v, n).astype(np.int32)
    want = np.asarray(jax_ref.amm_gather_replay_ref(table, jnp.asarray(idx)))
    t_table = tensor_from_numpy(np.asarray(table), "cpu")
    got = ref.amm_gather_replay_ref(t_table, torch.from_numpy(idx))
    assert got.dtype == t_table.dtype and got.shape == (n, d)
    word = torch.int16 if got.element_size() == 2 else torch.int32
    np.testing.assert_array_equal(
        got.view(word).numpy(),
        want.view(np.int16 if want.dtype.itemsize == 2 else np.int32))
    assert torch.equal(got.view(word),
                       t_table[torch.from_numpy(idx).long()].view(word))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,d,n", [
    (64, 8, 16), (128, 16, 64), (256, 32, 128), (96, 8, 48), (250, 8, 50),
    (64, 8, 32),
])
def test_amm_gather_replay_ref_matches_jax(dtype, v, d, n):
    _gather_case(dtype, v, d, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 7, 63, 97, 128])
def test_amm_gather_replay_ref_request_counts(dtype, n):
    _gather_case(dtype, 64, 8, n)


def test_amm_gather_replay_ref_rejects_bytes():
    with pytest.raises(ValueError):
        ref.amm_gather_replay_ref(torch.zeros((4, 2), dtype=torch.uint8),
                                  torch.zeros(2, dtype=torch.int64))
