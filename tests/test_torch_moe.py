"""The port's MLP and MoE layers against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
function and its counterpart in ``repro_torch.models``; JAX params are
carried across with ``convert.params_from_numpy``.  Tolerances: f32
1e-5 (sums in another order; the combine's scatter-add too), and under
bf16 inputs 2e-2 (atol and rtol), the reference's bf16 limit.  Routing
must agree exactly: the same top-k experts, ties broken to the lower
index, the same dropped choices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe

KEY = jax.random.PRNGKey(0)


def _cpu(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _params(jp) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


# ----------------------------------------------------------------- MLP
@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "relu2"),
                                       (False, "gelu"), (True, "relu")])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_mlp_apply_matches_jax(gated, act, dtype, tol):
    jp = jmlp.mlp_init(KEY, 24, 40, gated)
    x = _x(1, (2, 7, 24), dtype)
    want = jmlp.mlp_apply(jp, jnp.asarray(x), act)
    got = tmlp.mlp_apply(_params(jp), _cpu(x), act)
    assert got.dtype == _cpu(x).dtype
    np.testing.assert_allclose(_np(got), _f32(want), atol=tol, rtol=tol)


def test_mlp_init_layout_matches_jax():
    for gated in (True, False):
        want = jax.tree.map(lambda a: a.shape,
                            jmlp.mlp_init(KEY, 24, 40, gated))
        got = tmlp.mlp_init(torch.Generator().manual_seed(0), 24, 40, gated)
        assert {k: tuple(v.shape) for k, v in got.items()} == want


# ----------------------------------------------------------------- MoE
def _moe_setup(zero_router=False, **over):
    cfg = dict(d_model=16, d_ff_expert=24, n_experts=4, top_k=2)
    cfg.update(over)
    jcfg, tcfg = jmoe.MoEConfig(**cfg), tmoe.MoEConfig(**cfg)
    jp = jmoe.moe_init(KEY, jcfg)
    if zero_router:
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    return jcfg, tcfg, jp, _params(jp)


def _dropped(cfg, x: np.ndarray, router: np.ndarray) -> int:
    """How many (token, choice) pairs the capacity drops, counted in
    numpy from the routing the layer computes."""
    b, s, _ = x.shape
    cap = max(int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts), 1)
    logits = x.astype(np.float32) @ router
    g = np.exp(logits - logits.max(-1, keepdims=True))
    order = np.argsort(-g, axis=-1, kind="stable")[..., :cfg.top_k]
    drops = 0
    for row in order.reshape(b, -1):
        counts = np.zeros(cfg.n_experts, int)
        for e in row:
            counts[e] += 1
            drops += counts[e] > cap
    return drops


@pytest.mark.parametrize("case", ["roomy", "overflow", "ties", "decode",
                                  "plain_relu2", "topk_1"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_moe_apply_matches_jax(case, dtype, tol):
    """roomy: nothing dropped; overflow: capacity factor 0.5 drops
    choices (counted); ties: a zero router, so every gate ties and the
    lower experts win; decode: S 1, capacity 1; plain_relu2: an ungated
    expert FFN; topk_1: one choice a token."""
    over, zero, shape = {}, False, (2, 12, 16)
    if case == "roomy":
        over = dict(capacity_factor=4.0)
    elif case == "overflow":
        over = dict(capacity_factor=0.5)
    elif case == "ties":
        zero = True
    elif case == "decode":
        shape = (3, 1, 16)
    elif case == "plain_relu2":
        over = dict(gated=False, act="relu2")
    elif case == "topk_1":
        over = dict(top_k=1, n_experts=3)
    jcfg, tcfg, jp, tp = _moe_setup(zero, **over)
    x = _x(5, shape, dtype)
    want = jax.jit(lambda p, xx: jmoe.moe_apply(p, jcfg, xx))(
        jp, jnp.asarray(x))
    got = tmoe.moe_apply(tp, tcfg, _cpu(x))
    assert got.shape == shape and got.dtype == _cpu(x).dtype
    np.testing.assert_allclose(_np(got), _f32(want), atol=tol, rtol=tol)
    drops = _dropped(tcfg, _f32(x), np.asarray(jp["router"]))
    if case == "overflow":
        assert drops > 0
    if case in ("roomy", "decode"):
        assert drops == 0
    if case == "ties":
        # every token chose experts 0 and 1; capacity 7 of 12 drops 5 a
        # row at each, and the dropped tokens get nothing
        assert drops == 2 * 2 * 5
        assert torch.all(got[:, 7:] == 0) and torch.any(got[:, :7] != 0)


def test_moe_top_k_breaks_ties_to_the_lower_index():
    gates = torch.tensor([[0.2, 0.3, 0.3, 0.1, 0.3]])
    vals, idx = tmoe._top_k(gates, 3)
    assert idx.tolist() == [[1, 2, 4]]
    jv, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 3)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (jnp.bfloat16, 2e-2)])
def test_aux_load_balance_loss_matches_jax(zero_router, dtype, tol):
    jcfg, tcfg, jp, tp = _moe_setup(zero_router, n_experts=6)
    x = _x(8, (3, 10, 16), dtype)
    want = jmoe.aux_load_balance_loss(jp, jcfg, jnp.asarray(x))
    got = tmoe.aux_load_balance_loss(tp, tcfg, _cpu(x))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), atol=tol, rtol=tol)
    if zero_router:       # argmax picks expert 0 for all: E * 1 * 1/E
        assert got.item() == pytest.approx(1.0)


def test_moe_init_layout_matches_jax():
    for gated in (True, False):
        jcfg, tcfg, _, _ = _moe_setup(gated=gated)
        want = jax.tree.map(lambda a: a.shape, jax.eval_shape(
            lambda: jmoe.moe_init(KEY, jcfg)))
        got = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
        assert {k: tuple(v.shape) for k, v in got.items()} == want


def test_moe_init_scales_each_expert_by_its_fan_in():
    """Each expert's matrix is a dense init of its own [d_in, d_out]
    (JAX vmaps ``dense_init`` over the experts), so the spread follows
    d_in, not the expert count."""
    cfg = tmoe.MoEConfig(d_model=64, d_ff_expert=256, n_experts=8, top_k=2)
    p = tmoe.moe_init(torch.Generator().manual_seed(1), cfg)
    # a normal truncated at 2 sigma has std 0.8796 sigma
    assert p["w_up"].std().item() == pytest.approx(0.8796 / 8, rel=0.05)
    assert p["w_down"].std().item() == pytest.approx(0.8796 / 16, rel=0.05)
    assert not torch.equal(p["w_up"][0], p["w_up"][1])


def test_moe_apply_gradients_are_finite():
    _, tcfg, _, tp = _moe_setup(capacity_factor=0.5)
    for v in tp.values():
        v.requires_grad_(True)
    x = _cpu(_x(9, (2, 12, 16))).requires_grad_(True)
    tmoe.moe_apply(tp, tcfg, x).square().sum().backward()
    for g in [x.grad] + [v.grad for v in tp.values()]:
        assert g is not None and bool(torch.isfinite(g).all())
