"""FFT-Strided (MachSuite fft/strided): iterative radix-2 DIF FFT, fp64.

Per-stage strides are N/2, N/4, ..., 1 *elements* (x8 bytes) — the
paper's example of a double-precision program with >=8-byte minimum
stride and hence low spatial locality.

The trace follows the DIF butterfly passes, whose output is in
bit-reversed order.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n: int = 1024


TINY = Params(n=32)


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = int(np.log2(n))
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def run_torch(x: torch.Tensor) -> torch.Tensor:
    """DIF butterflies on the device of ``x`` (complex); returns the
    spectrum in *bit-reversed* order.  The twiddles are complex64 from
    float32 angles, as the reference computes them without x64."""
    n = x.shape[0]
    span = n // 2
    while span >= 1:
        xr = x.reshape(-1, 2 * span)
        a, b = xr[:, :span], xr[:, span:]
        j = torch.arange(span, dtype=torch.float32, device=x.device)
        ang = -2.0 * math.pi * j * (n // (2 * span)) / n
        w = torch.polar(torch.ones_like(ang), ang)
        xr = torch.cat([a + b, (a - b) * w[None, :]], dim=1)
        x = xr.reshape(n)
        span //= 2
    return x


def spectrum(x: torch.Tensor) -> torch.Tensor:
    """Natural-order FFT via the strided kernel + bit-reversal."""
    perm = torch.from_numpy(_bit_reverse_perm(x.shape[0])).to(x.device)
    return run_torch(x)[perm]


def gen_trace(p: Params = Params()) -> T.Trace:
    n = p.n
    tb = T.TraceBuilder("fft_strided")
    RE = tb.declare_array("real", 8)
    IM = tb.declare_array("img", 8)
    TR = tb.declare_array("real_twid", 8)
    TI = tb.declare_array("img_twid", 8)
    span = n // 2
    while span >= 1:
        for start in range(0, n, 2 * span):
            for j in range(span):
                i0, i1 = start + j, start + j + span
                ar, ai = tb.load(RE, i0), tb.load(IM, i0)
                br, bi = tb.load(RE, i1), tb.load(IM, i1)
                # even = a + b
                er = tb.op(T.FADD, ar, br)
                ei = tb.op(T.FADD, ai, bi)
                # odd = (a - b) * w
                dr = tb.op(T.FADD, ar, br)
                di = tb.op(T.FADD, ai, bi)
                tw = j * (n // (2 * span))
                wr, wi = tb.load(TR, tw), tb.load(TI, tw)
                m0 = tb.op(T.FMUL, dr, wr)
                m1 = tb.op(T.FMUL, di, wi)
                m2 = tb.op(T.FMUL, dr, wi)
                m3 = tb.op(T.FMUL, di, wr)
                orr = tb.op(T.FADD, m0, m1)
                oii = tb.op(T.FADD, m2, m3)
                tb.store(RE, i0, (er,))
                tb.store(IM, i0, (ei,))
                tb.store(RE, i1, (orr,))
                tb.store(IM, i1, (oii,))
        span //= 2
    return tb.build()
