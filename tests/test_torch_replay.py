"""The port's whole-trace replay engine against the JAX reference, on the
CPU, bit for bit.

The same numpy inputs (``make_trace`` traces, ``uint32`` initial words)
go through ``repro.core.amm.replay`` and ``repro_torch.core.amm.replay``
for every spec of ``tests/test_amm.py`` and ``tests/test_fault.py``
(together all 8 design kinds) plus sub-banked ``-b4`` geometries; the
reads of both paths, ``write_banks`` and the final flat state must be
equal.  Every comparison carries state across with
``repro_torch.convert`` (``uint32`` words as int32 bits and back).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.amm import replay as jrp
from repro.core.amm.spec import AMMSpec as JaxAMMSpec
from repro_torch.convert import (flat_state_from_numpy, flat_state_to_numpy,
                                 words_to_numpy)
from repro_torch.core.amm import replay as rp
from repro_torch.core.amm.spec import AMM_KINDS, AMMSpec
from test_amm import SPECS as AMM_SPECS
from test_amm import ram_oracle
from test_fault import SPECS as FAULT_SPECS

T = 16
# each spec once (a few are in both lists), then the -b4 geometries
SPECS = list({s.describe(): s for s in AMM_SPECS + FAULT_SPECS + [
    JaxAMMSpec("hb_ntx", 4, 2, 64, 32, n_banks=4),
    JaxAMMSpec("h_ntx_rd", 4, 1, 64, 32, n_banks=4),
    JaxAMMSpec("lvt", 4, 2, 32, 32, n_banks=4),
    JaxAMMSpec("remap", 4, 2, 32, 32, n_banks=4),
]}.values())
IDS = [s.describe() for s in SPECS]


def port_spec(spec: JaxAMMSpec) -> AMMSpec:
    return AMMSpec(**dataclasses.asdict(spec))


def _inputs(spec, seed, lanes=None, n_cycles=T):
    """Initial words and a make_trace trace ([lanes, ...] if lanes)."""
    rng = np.random.default_rng(seed)
    shape = (spec.depth,) if lanes is None else (lanes, spec.depth)
    init = rng.integers(0, 2**32, shape, dtype=np.uint32)
    if lanes is None:
        return init, jrp.make_trace(spec, n_cycles, rng=rng)
    traces = [jrp.make_trace(spec, n_cycles, rng=rng) for _ in range(lanes)]
    return init, tuple(np.stack([tr[i] for tr in traces]) for i in range(4))


def _assert_same(spec, j_state, j_res, t_state, t_res):
    np.testing.assert_array_equal(words_to_numpy(t_res.read_vals),
                                  np.asarray(j_res.read_vals))
    np.testing.assert_array_equal(words_to_numpy(t_res.parity_vals),
                                  np.asarray(j_res.parity_vals))
    if j_res.write_banks is None:
        assert t_res.write_banks is None
    else:
        assert t_res.write_banks.dtype == torch.int32
        np.testing.assert_array_equal(t_res.write_banks.numpy(),
                                      np.asarray(j_res.write_banks))
    got = flat_state_to_numpy(t_state)
    assert set(got) == set(j_state)
    for k, v in j_state.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_every_kind_is_covered():
    kinds = {s.kind for s in SPECS}
    assert kinds >= set(AMM_KINDS) | {"ideal", "banked", "multipump"}


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_replay_matches_jax(spec):
    init, ops = _inputs(spec, rp.spec_seed(port_spec(spec), "replay"))
    j_state, j_res = jrp.replay(spec, jrp.init_flat(spec, init), *ops)
    ts = port_spec(spec)
    t_state, t_res = rp.replay(ts, rp.init_flat(ts, init, "cpu"), *ops,
                               device="cpu")
    _assert_same(spec, j_state, j_res, t_state, t_res)
    np.testing.assert_array_equal(words_to_numpy(rp.peek_flat(ts, t_state)),
                                  np.asarray(jrp.peek_flat(spec, j_state)))


@pytest.mark.parametrize("share_trace", [True, False],
                         ids=["shared", "per_lane"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_replay_batched_matches_jax(spec, share_trace):
    lanes = 3
    seed = rp.spec_seed(port_spec(spec), "batched")
    init, ops = _inputs(spec, seed, None if share_trace else lanes)
    if share_trace:
        init = np.random.default_rng(seed + 1).integers(
            0, 2**32, (lanes, spec.depth), dtype=np.uint32)
    j_states = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[jrp.init_flat(spec, v) for v in init])
    j_state, j_res = jrp.replay_batched(spec, j_states, *ops,
                                        share_trace=share_trace)
    ts = port_spec(spec)
    t_states = flat_state_from_numpy(jax.tree.map(np.asarray, j_states),
                                     "cpu")
    t_state, t_res = rp.replay_batched(ts, t_states, *ops,
                                       share_trace=share_trace, device="cpu")
    _assert_same(spec, j_state, j_res, t_state, t_res)


@pytest.mark.parametrize("spec", SPECS[:10], ids=IDS[:10])
def test_replay_matches_ram_oracle(spec):
    """The port alone against the plain-RAM oracle of tests/test_amm.py,
    over a longer trace than the JAX comparisons."""
    init, ops = _inputs(spec, 5, n_cycles=64)
    ts = port_spec(spec)
    state, res = rp.replay(ts, rp.init_flat(ts, init, "cpu"), *ops,
                           device="cpu")
    want_reads, want_mem = ram_oracle(init, *ops)
    np.testing.assert_array_equal(words_to_numpy(res.read_vals), want_reads)
    np.testing.assert_array_equal(words_to_numpy(res.parity_vals),
                                  want_reads)
    np.testing.assert_array_equal(words_to_numpy(rp.peek_flat(ts, state)),
                                  want_mem)


@pytest.mark.parametrize("depth,levels", [(32, 0), (32, 1), (32, 2),
                                          (64, 2), (256, 3), (96, 1)])
def test_h_tables_match_jax(depth, levels):
    want, got = jrp.h_tables(depth, levels), rp.h_tables(depth, levels)
    assert (got.depth, got.levels, got.leaf_depth) == (
        want.depth, want.levels, want.leaf_depth)
    for name in ("direct", "write_paths", "parity_paths", "offset"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_make_trace_and_spec_seed_match_jax(spec):
    ts = port_spec(spec)
    for salt in ("", "campaign", "fault", "replay"):
        assert rp.spec_seed(ts, salt) == jrp.spec_seed(spec, salt)
    for kw in ({"seed": 3}, {"seed": 0, "write_prob": 0.35},
               {"rng": None}):
        want = jrp.make_trace(spec, 20, **kw)
        got = rp.make_trace(ts, 20, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # drawing from a shared generator leaves it where JAX's leaves it
    g1, g2 = np.random.default_rng(9), np.random.default_rng(9)
    rp.make_trace(ts, 7, rng=g1)
    jrp.make_trace(spec, 7, rng=g2)
    assert g1.integers(1 << 30) == g2.integers(1 << 30)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_flatten_unflatten_peek_round_trip(spec):
    ts = port_spec(spec)
    init = np.random.default_rng(1).integers(0, 2**32, spec.depth,
                                             dtype=np.uint32)
    flat = rp.init_flat(ts, init, "cpu")
    want = jrp.init_flat(spec, init)
    got = flat_state_to_numpy(flat)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(words_to_numpy(rp.peek_flat(ts, flat)),
                                  init)
    tree = rp.unflatten_state(ts, flat)
    back = rp.flatten_state(ts, tree)
    assert list(back) == list(flat)
    for k in flat:
        assert torch.equal(back[k], flat[k]), k
    # the pytree has the reference's structure, leaf for leaf
    j_tree = jrp.unflatten_state(spec, want)
    t_leaves = jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.numpy(), tree))
    assert jax.tree_util.tree_structure(j_tree) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda t: t.numpy(), tree))
    for a, b in zip(t_leaves, jax.tree_util.tree_leaves(j_tree)):
        np.testing.assert_array_equal(a.view(np.asarray(b).dtype),
                                      np.asarray(b))


def test_replay_leaves_its_input_state_alone():
    spec = AMMSpec("hb_ntx", 4, 2, 64, 32)
    init, ops = _inputs(spec, 2)
    flat = rp.init_flat(spec, init, "cpu")
    before = {k: v.clone() for k, v in flat.items()}
    rp.replay(spec, flat, *ops, device="cpu")
    rp.replay_faulty(spec, flat, rp.zero_fault(spec, "cpu"), *ops,
                     device="cpu")
    for k in flat:
        assert torch.equal(flat[k], before[k]), k


def test_replay_of_no_cycles():
    spec = AMMSpec("remap", 2, 2, 32, 32)
    init, ops = _inputs(spec, 4, n_cycles=0)
    state, res = rp.replay(spec, rp.init_flat(spec, init, "cpu"), *ops,
                           device="cpu")
    assert res.read_vals.shape == (0, 2)
    assert res.write_banks.shape == (0, 2)
    np.testing.assert_array_equal(words_to_numpy(rp.peek_flat(spec, state)),
                                  init)


def test_replay_takes_tensor_traces():
    """A trace given as tensors (int32 word bits) replays as its numpy
    form does."""
    spec = AMMSpec("lvt", 4, 3, 32, 32)
    init, (ra, wa, wv, wm) = _inputs(spec, 6)
    flat = rp.init_flat(spec, init, "cpu")
    _, want = rp.replay(spec, flat, ra, wa, wv, wm, device="cpu")
    _, got = rp.replay(spec, flat, torch.from_numpy(ra), torch.from_numpy(wa),
                       rp.words(wv, "cpu"), torch.from_numpy(wm),
                       device="cpu")
    assert torch.equal(got.read_vals, want.read_vals)


def test_words_are_uint32_bits():
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = rp.words(w, "cpu")
    assert t.dtype == torch.int32
    assert t.tolist() == [0, 1, 2**31 - 1, -2**31, -1]
    np.testing.assert_array_equal(words_to_numpy(t), w)
    assert rp.words(t, "cpu") is t
    with pytest.raises(TypeError):
        rp.words(torch.zeros(3, dtype=torch.int64), "cpu")


def test_init_flat_rejects_wrong_shape():
    with pytest.raises(ValueError):
        rp.init_flat(AMMSpec("ideal", 2, 2, 32), np.zeros(31, np.uint32),
                     "cpu")


@pytest.mark.parametrize("n_write", [2, 3, 4])
def test_remap_no_bank_sharing_invariant(n_write):
    """Within a cycle no two live writes are steered to one bank, and
    idle ports claim none (tests/test_replay.py's invariant)."""
    spec = AMMSpec("remap", 2, n_write, 32)
    for seed in range(3):
        ops = rp.make_trace(spec, 40, seed=seed)
        _, res = rp.replay(spec, rp.init_flat(spec, device="cpu"), *ops,
                           device="cpu")
        banks, wm = res.write_banks.numpy(), ops[3]
        for t in range(banks.shape[0]):
            live = banks[t][wm[t]]
            assert np.all((live >= 0) & (live < n_write + 1))
            assert len(set(live.tolist())) == len(live)
            assert np.all(banks[t][~wm[t]] == -1)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = AMMSpec("ideal", 2, 2, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rp.init_flat(spec)
    flat = rp.init_flat(spec, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rp.replay(spec, flat, *rp.make_trace(spec, 2))
