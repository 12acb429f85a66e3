"""KMP (MachSuite kmp/kmp): Knuth-Morris-Pratt string search.

Byte-oriented, stride-one text scan -> the paper's canonical
high-spatial-locality benchmark (L ~ 1), where array-partitioned
banking wins and true multiport is wasted area (Fig 4c/5).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T

PATTERN = b"bull"


@dataclasses.dataclass(frozen=True)
class Params:
    n: int = 8192        # text length (MachSuite: 32411)
    seed: int = 7


TINY = Params(n=256)


def make_text(p: Params) -> np.ndarray:
    rng = np.random.default_rng(p.seed)
    text = rng.integers(ord("a"), ord("e"), size=p.n, dtype=np.uint8)
    # plant a few patterns
    for pos in rng.integers(0, p.n - len(PATTERN), size=max(4, p.n // 512)):
        text[pos:pos + len(PATTERN)] = np.frombuffer(PATTERN, np.uint8)
    return text


def failure_table(pattern: bytes) -> np.ndarray:
    m = len(pattern)
    nxt = np.zeros(m, np.int64)
    k = 0
    for q in range(1, m):
        while k > 0 and pattern[k] != pattern[q]:
            k = int(nxt[k - 1])
        if pattern[k] == pattern[q]:
            k += 1
        nxt[q] = k
    return nxt


def run_np(text: np.ndarray, pattern: bytes = PATTERN) -> int:
    nxt = failure_table(pattern)
    q = matches = 0
    pat = np.frombuffer(pattern, np.uint8)
    m = len(pat)
    for c in text:
        while q > 0 and pat[q] != c:
            q = int(nxt[q - 1])
        if pat[q] == c:
            q += 1
        if q == m:
            matches += 1
            q = int(nxt[q - 1])
    return matches


def run_torch(text: torch.Tensor, pattern: bytes = PATTERN) -> torch.Tensor:
    """The number of matches :func:`run_np`'s DFA counts, on the device
    of ``text`` (uint8).  The DFA counts overlapping occurrences, so
    comparing every ``len(pattern)``-byte window of the text with the
    pattern gives the same count with no step per character."""
    m = len(pattern)
    if text.shape[0] < m:
        return torch.zeros((), dtype=torch.int64, device=text.device)
    pat = torch.tensor(list(pattern), dtype=torch.uint8, device=text.device)
    return (text.unfold(0, m, 1) == pat).all(dim=1).sum()


def gen_trace(p: Params = Params()) -> T.Trace:
    text = make_text(p)
    pat = np.frombuffer(PATTERN, np.uint8)
    nxt = failure_table(PATTERN)
    m = len(pat)
    tb = T.TraceBuilder("kmp")
    TXT = tb.declare_array("text", 1)
    PAT = tb.declare_array("pattern", 1)
    NXT = tb.declare_array("kmp_next", 4)
    MAT = tb.declare_array("n_matches", 4)
    q = 0
    carry = -1  # control/data dependence through q
    n_matches = 0
    for i, c in enumerate(text):
        deps = (carry,) if carry >= 0 else ()
        lt = tb.load(TXT, i, deps)
        while q > 0 and pat[q] != c:
            lp = tb.load(PAT, q, (lt,))
            cmp = tb.op(T.ICMP, lt, lp)
            ln = tb.load(NXT, q - 1, (cmp,))
            carry = ln
            q = int(nxt[q - 1])
        lp = tb.load(PAT, q, (lt,))
        cmp = tb.op(T.ICMP, lt, lp)
        carry = cmp
        if pat[q] == c:
            q += 1
        if q == m:
            n_matches += 1
            add = tb.op(T.IADD, cmp)
            carry = tb.store(MAT, 0, (add,))
            q = int(nxt[q - 1])
    return tb.build()
