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
