"""NW (MachSuite nw/needwun): Needleman-Wunsch global sequence alignment.

Dynamic-programming wavefront over an int32 score matrix: every cell
reads its diagonal/up/left neighbours (unit and row-pitch strides) plus
one byte of each sequence, then writes score + traceback pointer.  A
byte-oriented sequence scan keeps part of the stream stride-one, so NW
sits mid-spread on the Fig-5 locality axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T

MATCH, MISMATCH, GAP = 1, -1, -1
ALIGN, SKIP_UP, SKIP_LEFT = 0, 1, 2    # traceback pointer codes


@dataclasses.dataclass(frozen=True)
class Params:
    alen: int = 64           # MachSuite: ALEN = BLEN = 128
    blen: int = 64
    seed: int = 29


TINY = Params(alen=12, blen=12)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    return {
        "seq_a": rng.integers(0, 4, size=p.alen).astype(np.uint8),
        "seq_b": rng.integers(0, 4, size=p.blen).astype(np.uint8),
    }


def _cell(diag: int, up: int, left: int, match: bool) -> tuple[int, int]:
    """Score + pointer for one DP cell (diag > up > left tie order)."""
    d = diag + (MATCH if match else MISMATCH)
    u = up + GAP
    l = left + GAP
    if d >= u and d >= l:
        return d, ALIGN
    if u >= l:
        return u, SKIP_UP
    return l, SKIP_LEFT


def run_np(seq_a: np.ndarray, seq_b: np.ndarray) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Full DP fill; returns (score matrix, traceback pointers), both
    ``[blen+1, alen+1]``."""
    a_n, b_n = seq_a.shape[0], seq_b.shape[0]
    m = np.zeros((b_n + 1, a_n + 1), np.int32)
    ptr = np.zeros((b_n + 1, a_n + 1), np.int8)
    m[0, :] = GAP * np.arange(a_n + 1)
    m[:, 0] = GAP * np.arange(b_n + 1)
    for b in range(1, b_n + 1):
        for a in range(1, a_n + 1):
            s, d = _cell(int(m[b - 1, a - 1]), int(m[b - 1, a]),
                         int(m[b, a - 1]), seq_a[a - 1] == seq_b[b - 1])
            m[b, a] = s
            ptr[b, a] = d
    return m, ptr


def run_torch(seq_a: torch.Tensor, seq_b: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The DP fill as an anti-diagonal wavefront on the device of
    ``seq_a``: the cells of diagonal ``b + a = d`` read only diagonals
    ``d - 1`` and ``d - 2``, so ``alen + blen - 1`` steps fill the
    matrix.  Bit-identical to :func:`run_np` including the diag > up >
    left tie order."""
    dev = seq_a.device
    a_n, b_n = seq_a.shape[0], seq_b.shape[0]
    m = torch.zeros((b_n + 1, a_n + 1), dtype=torch.int32, device=dev)
    ptr = torch.zeros((b_n + 1, a_n + 1), dtype=torch.int8, device=dev)
    m[0, :] = GAP * torch.arange(a_n + 1, dtype=torch.int32, device=dev)
    m[:, 0] = GAP * torch.arange(b_n + 1, dtype=torch.int32, device=dev)
    sa, sb = seq_a.long(), seq_b.long()
    for d in range(2, a_n + b_n + 1):
        b = torch.arange(max(1, d - a_n), min(b_n, d - 1) + 1, device=dev)
        a = d - b
        dg = m[b - 1, a - 1] + torch.where(sa[a - 1] == sb[b - 1], MATCH,
                                           MISMATCH)
        u = m[b - 1, a] + GAP
        lf = m[b, a - 1] + GAP
        take_d = (dg >= u) & (dg >= lf)
        m[b, a] = torch.where(take_d, dg,
                              torch.where(u >= lf, u, lf)).to(torch.int32)
        ptr[b, a] = torch.where(take_d, ALIGN,
                                torch.where(u >= lf, SKIP_UP, SKIP_LEFT)
                                ).to(torch.int8)
    return m, ptr


def gen_trace(p: Params = Params()) -> T.Trace:
    inp = make_inputs(p)
    seq_a, seq_b = inp["seq_a"], inp["seq_b"]
    width = p.alen + 1
    tb = T.TraceBuilder("nw")
    SEQA = tb.declare_array("seqA", 1)
    SEQB = tb.declare_array("seqB", 1)
    M = tb.declare_array("M", 4)
    PTR = tb.declare_array("ptr", 1)    # char traceback codes (MachSuite)
    last_m: dict[int, int] = {}
    # boundary row/column initialisation
    for a in range(width):
        last_m[a] = tb.store(M, a)
    for b in range(1, p.blen + 1):
        last_m[b * width] = tb.store(M, b * width)
    for b in range(1, p.blen + 1):
        for a in range(1, p.alen + 1):
            la = tb.load(SEQA, a - 1)
            lb = tb.load(SEQB, b - 1)
            cmp = tb.op(T.ICMP, la, lb)
            ld = tb.load(M, (b - 1) * width + (a - 1),
                         (last_m[(b - 1) * width + a - 1],))
            lu = tb.load(M, (b - 1) * width + a,
                         (last_m[(b - 1) * width + a],))
            ll = tb.load(M, b * width + (a - 1),
                         (last_m[b * width + a - 1],))
            s0 = tb.op(T.IADD, ld, cmp)
            s1 = tb.op(T.IADD, lu)
            s2 = tb.op(T.IADD, ll)
            mx = tb.op(T.ICMP, s0, s1)
            mx = tb.op(T.ICMP, mx, s2)
            last_m[b * width + a] = tb.store(M, b * width + a, (mx,))
            tb.store(PTR, b * width + a, (mx,))
    return tb.build()
