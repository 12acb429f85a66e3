"""Mamba2 SSD chunk step — one chunk of the state-space dual form.

For a chunk of Q tokens, per (batch row, head):
  inputs : x [Bt, H, Q, P], dt [Bt, H, Q], cum [Bt, H, Q] (cumulative
           log-decay), B [Bt, Q, N], C [Bt, Q, N], h_in [Bt, H, P, N]
  outputs: y [Bt, H, Q, P], h_out [Bt, H, P, N], both f32

  L[i,j]  = exp(cum_i - cum_j)        for j <= i, else 0
  y       = ((C B^T) * L) @ (dt * x)  +  (C * exp(cum)) @ h_in^T
  h_out   = exp(cum_Q) h_in + (exp(cum_Q - cum) * dt * x)^T @ B

Inputs are read as f32.  As in the JAX package, whose block body casts
y to x's dtype and h_out to h_in's before they are stored as f32, y is
rounded through x's dtype and h_out through h_in's wherever those are
not f32.  ``ssd_chunk_step`` launches ``csrc/ssd_scan.cu`` on CUDA
tensors and runs ``ssd_chunk_step_plain`` on CPU tensors.  The kernel
computes C B^T once a batch row into an f32 workspace of
``workspace_shape`` that the wrapper allocates, then y and h_out over
square tiles of the edge the library reports (``ssd_chunk_tile``);
``tile_counts`` gives the CTAs of each of its three launches.  It stages
its tiles in 16-byte copies (``vec`` 1, legal where ``_vec_copies``
holds) or 4-byte ones (``vec`` 0), as the autotuner's table says unless
given (``autotune.resolve``).

``SSDChunk`` is the autograd rule, on both devices: its forward is
``ssd_chunk_step`` (the kernel on the card, counted; the plain version
on the CPU), and its backward re-runs ``ssd_chunk_step_plain`` on the
saved inputs under autograd and returns the gradients of all six.  The
backward is the plain version's, not a kernel: the JAX package has no
backward kernel either (``jax.grad`` differentiates its plain
``ssd_chunked``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, autotune

FLOAT_DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_YZ = 65535      # CUDA's limit on gridDim.y (heads), .z (batch)


def workspace_shape(bt: int, q: int, tile: int) -> "tuple[int, int, int]":
    """The C B^T workspace, [Bt, Qp, Qp] f32 with Qp = Q rounded up to a
    multiple of the tile (only its causal tiles are written and read)."""
    qp = -(-q // tile) * tile
    return bt, qp, qp


def tile_counts(bt: int, h: int, q: int, p: int, n: int, tile: int
                ) -> "dict[str, int]":
    """CTAs of the kernel's three launches: one per causal C B^T tile of
    each batch row; one per (row tile, head-dim tile, head, batch row)
    for y; one per (head-dim tile, state tile, head, batch row) for
    h_out (none when N is 0)."""
    qt, pt, nt = (-(-d // tile) for d in (q, p, n))
    return {"cb": bt * qt * (qt + 1) // 2, "y": bt * h * qt * pt,
            "state": bt * h * pt * nt}


def _vec_copies(p: int, n: int, *tensors: torch.Tensor) -> bool:
    """True when the kernel may stage its tiles in 16-byte copies: P and
    N are multiples of 4 floats and every base is 16-byte aligned."""
    return p % 4 == 0 and n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                             for t in tensors)


def _round_through(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).float()


def ssd_chunk_step_plain(x: torch.Tensor, dt: torch.Tensor,
                         cum: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, h_in: torch.Tensor
                         ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Plain PyTorch version: the per-head einsums of the Pallas block
    body, in f32, with the same mask and output rounding."""
    q = x.shape[2]
    xf, dtf, cumf = x.float(), dt.float(), cum.float()
    Bf, Cf, hf = B.float(), C.float(), h_in.float()
    ii = torch.arange(q, device=x.device)
    causal = ii[None, :] <= ii[:, None]                        # [i, j]
    diff = torch.where(causal, cumf[..., :, None] - cumf[..., None, :],
                       -1e30)
    decay = torch.exp(diff)                                    # [b,h,i,j]
    cb = torch.einsum("bin,bjn->bij", Cf, Bf)                  # [b,i,j]
    scores = cb[:, None] * decay
    y = torch.einsum("bhij,bhjp->bhip", scores, dtf[..., None] * xf)
    y = y + torch.einsum("bhin,bhpn->bhip",
                         Cf[:, None] * torch.exp(cumf)[..., None], hf)
    tail = torch.exp(cumf[..., -1:] - cumf) * dtf              # [b,h,q]
    h_out = torch.exp(cumf[..., -1])[..., None, None] * hf + torch.einsum(
        "bhjp,bjn->bhpn", tail[..., None] * xf, Bf)
    return _round_through(y, x.dtype), _round_through(h_out, h_in.dtype)


@functools.cache
def _launcher() -> tuple:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_chunk_tile.restype = ctypes.c_int
    return lib, fn


@functools.cache
def kernel_tile() -> int:
    """The tile edge of the CUDA kernel, as its library reports it."""
    return _launcher()[0].ssd_chunk_tile()


def launch_dims(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, h_in: torch.Tensor
                ) -> "dict[str, int]":
    """The autotuner's dims of a launch on the f32 inputs: the shape and
    ``vec``, whether 16-byte staging is legal (``_vec_copies``)."""
    bt, h, q, p = x.shape
    n = B.shape[-1]
    return dict(bt=bt, h=h, q=q, p=p, n=n,
                vec=int(_vec_copies(p, n, x, dt, cum, B, C, h_in)))


def ssd_chunk_step(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, h_in: torch.Tensor, *,
                   vec: "int | None" = None
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """x: [Bt, H, Q, P]; dt/cum: [Bt, H, Q]; B/C: [Bt, Q, N];
    h_in: [Bt, H, P, N] -> (y [Bt, H, Q, P], h_out [Bt, H, P, N]), f32.

    A CUDA tensor launches the kernel (``ssd_chunk_step.launches`` counts
    the launches, ``ssd_chunk_step.config`` holds the last launch's
    configuration) with 16-byte staging when ``vec`` is 1; None takes the
    autotuner's table, and a ``vec`` the kernel does not take raises.  A
    CPU tensor takes the plain version."""
    if _build.dispatch(x, dt, cum, B, C, h_in) == "cpu":
        return ssd_chunk_step_plain(x, dt, cum, B, C, h_in)
    bt, h, q, p = x.shape
    n = B.shape[-1]
    if q == 0:
        raise ValueError("an SSD chunk needs at least one position")
    if h > MAX_GRID_YZ or bt > MAX_GRID_YZ:
        raise ValueError(f"the CUDA kernel serves up to {MAX_GRID_YZ} heads "
                         f"and batch rows, got {h} and {bt}")
    dev = x.device
    _build.check_tensor("x", x, dev, FLOAT_DTYPES, (bt, h, q, p))
    _build.check_tensor("dt", dt, dev, FLOAT_DTYPES, (bt, h, q))
    _build.check_tensor("cum", cum, dev, FLOAT_DTYPES, (bt, h, q))
    _build.check_tensor("B", B, dev, FLOAT_DTYPES, (bt, q, n))
    _build.check_tensor("C", C, dev, FLOAT_DTYPES, (bt, q, n))
    _build.check_tensor("h_in", h_in, dev, FLOAT_DTYPES, (bt, h, p, n))
    ins = [t.float() for t in (x, dt, cum, B, C, h_in)]
    cfg = autotune.resolve("ssd_chunk", dev, launch_dims(*ins), vec=vec)
    y = torch.empty((bt, h, q, p), dtype=torch.float32, device=dev)
    h_out = torch.empty((bt, h, p, n), dtype=torch.float32, device=dev)
    lib, fn = _launcher()
    ws = torch.empty(workspace_shape(bt, q, kernel_tile()),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(*(t.data_ptr() for t in ins), y.data_ptr(),
                  h_out.data_ptr(), ws.data_ptr(), bt, h, q, p, n,
                  cfg["vec"], _build.stream_ptr(x))
    _build.check_status(lib, code, "ssd_chunk_step")
    ssd_chunk_step.launches += 1
    ssd_chunk_step.config = cfg
    return _round_through(y, x.dtype), _round_through(h_out, h_in.dtype)


ssd_chunk_step.launches = 0
ssd_chunk_step.config = None


class SSDChunk(torch.autograd.Function):
    """``ssd_chunk_step`` with a backward: the plain version re-run on
    the saved inputs under autograd.  The gradient of ``h_in`` carries
    the state's gradient from chunk to chunk in ``ssd_chunked``."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, h_in):
        ctx.save_for_backward(x, dt, cum, B, C, h_in)
        return ssd_chunk_step(x, dt, cum, B, C, h_in)

    @staticmethod
    def backward(ctx, g_y, g_h):
        need = ctx.needs_input_grad
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y, h_out = ssd_chunk_step_plain(*ins)
        wrt = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad((y, h_out), wrt, (g_y, g_h)))
        return tuple(next(grads) if n else None for n in need)
