"""SORT-MERGE (MachSuite sort/merge): bottom-up merge sort, int32.

Two stride-one read streams + one stride-one write stream per pass;
moderate spatial locality (4-byte words).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n: int = 2048
    seed: int = 3


TINY = Params(n=64)


def make_input(p: Params) -> np.ndarray:
    rng = np.random.default_rng(p.seed)
    return rng.integers(0, 1 << 20, size=p.n, dtype=np.int32)


def run_torch(x: torch.Tensor) -> torch.Tensor:
    """The sorted keys, on the device of ``x``."""
    return torch.sort(x).values


def gen_trace(p: Params = Params()) -> T.Trace:
    a = make_input(p).copy()
    n = p.n
    tb = T.TraceBuilder("sort_merge")
    A = tb.declare_array("a", 4)
    TMP = tb.declare_array("temp", 4)
    width = 1
    # last_write[arr][idx] -> node id, to carry RAW deps across passes
    last_a: dict[int, int] = {}
    last_t: dict[int, int] = {}
    while width < n:
        for lo in range(0, n, 2 * width):
            mid = min(lo + width, n)
            hi = min(lo + 2 * width, n)
            i, j, k = lo, mid, lo
            while i < mid or j < hi:
                if i < mid and (j >= hi or a[i] <= a[j]):
                    src = i; i += 1
                else:
                    src = j; j += 1
                deps = (last_a[src],) if src in last_a else ()
                ld = tb.load(A, src, deps)
                cmp = tb.op(T.ICMP, ld)
                st = tb.store(TMP, k, (cmp,))
                last_t[k] = st
                k += 1
            # copy-back temp -> a
            for t in range(lo, hi):
                ld = tb.load(TMP, t, (last_t[t],))
                st = tb.store(A, t, (ld,))
                last_a[t] = st
        # mirror the merge on the value array
        out = a.copy()
        for lo in range(0, n, 2 * width):
            mid = min(lo + width, n)
            hi = min(lo + 2 * width, n)
            merged = np.concatenate([a[lo:mid], a[mid:hi]])
            out[lo:hi] = np.sort(merged, kind="stable")
        a = out
        width *= 2
    return tb.build()
