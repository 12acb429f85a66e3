"""Mamba2 / SSD (state-space duality, arXiv:2405.21060).

The selective state space  h_t = a_t h_{t-1} + dt_t B_t x_t^T,
y_t = C_t h_t + D x_t  is evaluated with the chunked SSD algorithm:
within a chunk of Q tokens the quadratic dual form, across chunks the
linear state recurrence, carried by a Python loop over the chunks.
Each chunk goes through ``kernels.ops.ssd_chunk``: its contract is the
JAX ``ssd_chunked`` chunk step's, with the axes transposed to
[b, h, q, p] and the cumulative log-decay precomputed, so on the card
every chunk of every layer runs ``csrc/ssd_scan.cu``.  The chunk is
differentiable in all six inputs (``kernels.ssd_scan.SSDChunk``), so
the state carries the gradient from chunk to chunk.  The per-token
recurrence ``ssd_reference`` is the oracle.

Shapes: x [B,S,H,P] (H heads of headdim P), dt [B,S,H], B/C [B,S,N]
(single group shared across heads), state h [B,H,P,N].
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dtensor_ops import (cumsum, merge_heads, per_head,
                                     split_dim, zero_pad)
from repro_torch.kernels import ops
from repro_torch.models.common import Params, dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.d_state


# ----------------------------------------------------------------------
# Core SSD math
# ----------------------------------------------------------------------
def ssd_reference(x, dt, A, B, C, h0=None):
    """Naive per-token recurrence (oracle).  x:[b,s,h,p] dt:[b,s,h]
    A:[h] B,C:[b,s,n] -> y:[b,s,h,p] f32, h_final:[b,h,p,n] f32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        a = torch.exp(dtt * A)                                  # [b,h]
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtt, B[:, t].float(),
                           x[:, t].float())
        hprev = a[..., None, None] * hprev + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].float(), hprev))
    return torch.stack(ys, dim=1), hprev


def ssd_chunked(x, dt, A, B, C, h0=None, chunk: int = 256):
    """Chunked SSD (the paper's efficient dual form), one
    ``ops.ssd_chunk`` call per chunk, in order.  Returns y [b,s,h,p] f32
    and the final state [b,h,p,n] f32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:           # padded positions have dt 0: they add nothing
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // q
    if h0 is None:
        h0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)

    dtc = dt.reshape(b, nc, q, h).float()
    cum = cumsum(dtc * A, dim=2)                        # [b,nc,q,h] f32
    # the kernel's layout, once: chunk-major, so each chunk is contiguous
    xk = x.reshape(b, nc, q, h, p).float().permute(1, 0, 3, 2, 4) \
        .contiguous()                                   # [nc,b,h,q,p]
    dtk = dtc.permute(1, 0, 3, 2).contiguous()          # [nc,b,h,q]
    cumk = cum.permute(1, 0, 3, 2).contiguous()
    Bk = B.reshape(b, nc, q, n).float().transpose(0, 1).contiguous()
    Ck = C.reshape(b, nc, q, n).float().transpose(0, 1).contiguous()

    hprev = h0
    ys = []
    for c in range(nc):
        yc, hprev = ops.ssd_chunk(xk[c], dtk[c], cumk[c], Bk[c], Ck[c],
                                  hprev)
        ys.append(yc)                                   # [b,h,q,p]
    y = torch.stack(ys, dim=1).permute(0, 1, 3, 2, 4)   # [b,nc,q,h,p]
    return y.reshape(b, nc * q, h, p)[:, :s], hprev


# ----------------------------------------------------------------------
# Mamba2 block
# ----------------------------------------------------------------------
def mamba2_init(gen: torch.Generator, cfg: SSMConfig) -> Params:
    """Parameters on ``gen``'s device, drawn from ``gen`` with the JAX
    initializer's distributions."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    dev = gen.device
    proj_out = 2 * di + 2 * cfg.d_state + h
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, d, proj_out),
        "conv_w": torch.randn((cfg.conv_width, cfg.conv_channels),
                              generator=gen, **f32) * 0.1,
        "conv_b": torch.zeros((cfg.conv_channels,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": {"scale": torch.zeros((di,), **f32)},
        "out_proj": dense_init(gen, di, d),
    }


def _split_proj(cfg: SSMConfig, proj: torch.Tensor):
    di = cfg.d_inner
    z = proj[..., :di]
    xbc = proj[..., di:di + cfg.conv_channels]
    dt = proj[..., di + cfg.conv_channels:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv along S, summed in f32 with silu in f32,
    cast to xbc's dtype.  xbc: [B,S,C]; w: [W,C]."""
    width = w.shape[0]
    s = xbc.shape[1]
    pad = zero_pad(xbc, 1, width - 1, 0)
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i:i + s, :].float() * w[i]
    return F.silu(out + bias).to(xbc.dtype)


def mamba2_apply(params: Params, cfg: SSMConfig, x: torch.Tensor,
                 return_state: bool = False):
    """Full-sequence Mamba2 block.  x: [B,S,D].  With ``return_state``
    also (h_final f32, the last W-1 pre-conv projections)."""
    b, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = split_dim(xbc[..., :di], -1, h, p)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, hf = ssd_chunked(xs, dt, A, B, C, chunk=cfg.chunk)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = merge_heads(y).to(x.dtype)                      # [b, s, di]
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, params["norm"]["scale"])
    out = y @ params["out_proj"].to(x.dtype)
    if return_state:
        conv_tail = None
        if cfg.conv_width > 1:
            # last (W-1) pre-conv inputs for decode continuation
            _, conv_tail, _ = _split_proj(
                cfg, proj[:, -(cfg.conv_width - 1):, :])
        return out, (hf, conv_tail)
    return out


def _decode_core(dt, A, B, C, xt, hprev, D):
    """One token's state update and output, per batch row and head:
    (y [b,h,p], h_new [b,h,p,n]), f32."""
    a = torch.exp(dt * A)                                       # [b,h]
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B.float(), xt.float())
    hnew = a[..., None, None] * hprev + dBx
    y = torch.einsum("bn,bhpn->bhp", C.float(), hnew)
    return y + D[None, :, None] * xt.float(), hnew


def mamba2_decode(params: Params, cfg: SSMConfig, x: torch.Tensor,
                  state: "tuple[torch.Tensor, torch.Tensor]"):
    """Single-token decode, the per-token recurrence in plain PyTorch.
    x: [B,1,D]; state = (h [b,h,p,n] f32, conv_buf [b,W-1,C])."""
    b = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    hprev, conv_buf = state
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc_new, dt_raw = _split_proj(cfg, proj)
    window = torch.cat([conv_buf.to(x.dtype), xbc_new], dim=1)
    acc = torch.einsum("bwc,wc->bc", window.float(), params["conv_w"].float())
    xbc = F.silu(acc + params["conv_b"])[:, None, :].to(x.dtype)
    xt = split_dim(xbc[..., :di], -1, h, p)[:, 0]
    B = xbc[..., di:di + n][:, 0]
    C = xbc[..., di + n:][:, 0]
    dt = F.softplus(dt_raw.float()[:, 0] + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, hnew = per_head(_decode_core, xt, (dt, (0, 1)), (A, (None, 0)),
                       (B, (0, None)), (C, (0, None)), (xt, (0, 1)),
                       (hprev, (0, 1)), (params["D"], (None, 0)),
                       outputs=2)
    y = merge_heads(y)[:, None].to(x.dtype)             # [b, 1, di]
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, params["norm"]["scale"])
    out = y @ params["out_proj"].to(x.dtype)
    return out, (hnew, window[:, 1:, :])

