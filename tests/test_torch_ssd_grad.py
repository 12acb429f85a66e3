"""The SSD chunk's autograd rule against ``jax.grad``, on the CPU, and
the no-backward guards of the gather and the decode.

``ops.ssd_chunk`` goes through ``ssd_scan.SSDChunk`` on both devices:
its forward is the kernel on the card and the plain version on the
CPU, and its backward re-runs the plain version under autograd.  Here
the gradients of all six inputs (x, dt, cum, B, C, h_in) are held
against ``jax.grad`` of the reference's ``ssd_chunk_ref``, and the
gradients through ``ssd_chunked`` over three chunks (the state carries
the gradient from chunk to chunk through ``h_in``) against ``jax.grad``
of the reference's ``ssd_chunked``.  Tolerance 1e-5 relative to each
gradient's largest magnitude (atol) and to each element (rtol): f32
sums taken in another order.  The card's leg is in
``tests/test_torch_cuda.py``.

``amm_gather`` and ``kv_decode`` have no backward: on CUDA, an input
that requires grad raises under grad mode and runs as before under
``torch.no_grad()``.  There is no card here, so the guard is driven by
routing the dispatch to "cuda" and stubbing the kernel wrapper.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import ssm as jax_ssm
from repro_torch.kernels import _build, ops
from repro_torch.kernels.amm_gather import amm_gather_u32_plain
from repro_torch.kernels.banked_kv_decode import banked_kv_decode_plain
from repro_torch.models import ssm

TOL = 1e-5


def _hold(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def _chunk_inputs(seed, bt, h, q, p, n):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.5, (bt, h, q)).astype(np.float32)
    la = -dt * rng.uniform(0.5, 2.0, (1, h, 1)).astype(np.float32)
    return (rng.standard_normal((bt, h, q, p)).astype(np.float32), dt,
            np.cumsum(la, axis=-1).astype(np.float32),
            rng.standard_normal((bt, q, n)).astype(np.float32),
            rng.standard_normal((bt, q, n)).astype(np.float32),
            rng.standard_normal((bt, h, p, n)).astype(np.float32))


@pytest.mark.parametrize("bt,h,q,p,n", [
    (1, 2, 8, 4, 4), (2, 3, 12, 8, 6), (1, 2, 64, 16, 32)])
def test_ssd_chunk_grads_match_jax(bt, h, q, p, n):
    ins = _chunk_inputs(q + n, bt, h, q, p, n)
    rng = np.random.default_rng(1)
    wy = rng.standard_normal((bt, h, q, p)).astype(np.float32)
    wh = rng.standard_normal((bt, h, p, n)).astype(np.float32)

    def jloss(*a):
        y, h_out = jax_ref.ssd_chunk_ref(*a)
        return jnp.sum(y * wy) + jnp.sum(h_out * wh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *map(jnp.asarray, ins))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h_out = ops.ssd_chunk(*tins)
    assert type(y.grad_fn).__name__ == "SSDChunkBackward"
    loss = (y * torch.from_numpy(wy)).sum() + (h_out * torch.from_numpy(
        wh)).sum()
    got = torch.autograd.grad(loss, tins)
    for name, g, w in zip(("x", "dt", "cum", "B", "C", "h_in"), got, want):
        _hold(g, w, name)


def test_ssd_chunk_grads_of_some_inputs():
    """Only the inputs that require grad get one; the others are None."""
    ins = [torch.from_numpy(a) for a in _chunk_inputs(3, 1, 2, 8, 4, 4)]
    ins[0].requires_grad_()
    ins[5].requires_grad_()
    y, h_out = ops.ssd_chunk(*ins)
    gx, gh = torch.autograd.grad(y.sum() + h_out.sum(), (ins[0], ins[5]))
    assert gx.shape == ins[0].shape and gh.shape == ins[5].shape
    with torch.no_grad():
        y2, _ = ops.ssd_chunk(*ins)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_ssd_chunked_grads_match_jax():
    """Three chunks of 8 with a ragged tail (s 22), an inbound state:
    gradients of x, dt, A, B, C and h0."""
    b, s, h, p, n, q = 2, 22, 3, 4, 6, 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    wy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    wh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    ins = (x, dt, A, B, C, h0)

    def jloss(x, dt, A, B, C, h0):
        y, hf = jax_ssm.ssd_chunked(x, dt, A, B, C, h0, chunk=q)
        return jnp.sum(y * wy) + jnp.sum(hf * wh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *map(jnp.asarray, ins))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, hf = ssm.ssd_chunked(*tins, chunk=q)
    loss = (y * torch.from_numpy(wy)).sum() + (hf * torch.from_numpy(
        wh)).sum()
    got = torch.autograd.grad(loss, tins)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "h0"), got, want):
        _hold(g, w, name)


# ----------------------------------------------------------- the guards
def _gather_call(table):
    idx = torch.tensor([0, 5, 9, 3, 7], dtype=torch.int32)
    return lambda: ops.amm_gather(table, idx, n_banks=2)


def _decode_call(q):
    g = torch.Generator().manual_seed(0)
    k = torch.randn((1, 2, 8, 4), generator=g)
    v = torch.randn((1, 2, 8, 4), generator=g)
    lengths = torch.tensor([5], dtype=torch.int32)
    return lambda: ops.kv_decode(q, k, v, lengths, n_banks=2)


CASES = {
    "amm_gather": ("amm_gather_u32", amm_gather_u32_plain,
                   lambda: torch.randn((10, 4)), _gather_call),
    "kv_decode": ("banked_kv_decode", banked_kv_decode_plain,
                  lambda: torch.randn((1, 4, 4)), _decode_call),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_backward_guard_on_cuda(name, monkeypatch):
    """Routed as a CUDA call: an input that requires grad raises under
    grad mode, naming the missing backward; under no_grad, or with no
    input requiring grad, the kernel wrapper runs as before."""
    wrapper, plain, make, call = CASES[name]
    launched = []

    def fake_kernel(*args):
        launched.append(1)
        return plain(*args)

    monkeypatch.setattr(_build, "dispatch", lambda *t: "cuda")
    monkeypatch.setattr(ops, wrapper, fake_kernel)
    x = make().requires_grad_()
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call(x)()
    assert not launched
    with torch.no_grad():
        under_no_grad = call(x)()
    plain_input = call(x.detach())()
    assert len(launched) == 2
    assert torch.equal(under_no_grad, plain_input)


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_backward_guard_leaves_the_cpu_alone(name):
    """On CPU tensors the guard does nothing: the plain version runs,
    grad mode or not."""
    _, _, make, call = CASES[name]
    x = make().requires_grad_()
    with torch.no_grad():
        want = call(x)()
    assert torch.equal(call(x)().detach(), want)
