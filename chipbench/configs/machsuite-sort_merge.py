"""The plain reference of ``machsuite-sort_merge``: MachSuite sort/merge
(bottom-up merge sort of int32 keys, SIZE 2048) traced as the
benchmark's own copy of the generator.

Two stride-one read streams and one stride-one write stream a pass; the
merge order, and so the address stream, follows the key values drawn
from the seed.
"""
import numpy as np

from chipbench.reference import trace as T


def make_input(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 20, size=n, dtype=np.int32)


def gen_trace(params: dict, seed: int) -> T.Trace:
    n = int(params["n"])
    a = make_input(n, seed).copy()
    tb = T.TraceBuilder("sort_merge")
    A = tb.declare_array("a", 4)
    TMP = tb.declare_array("temp", 4)
    width = 1
    last_a: dict = {}      # index -> the store that last wrote a[index]
    last_t: dict = {}
    while width < n:
        for lo in range(0, n, 2 * width):
            mid = min(lo + width, n)
            hi = min(lo + 2 * width, n)
            i, j, k = lo, mid, lo
            while i < mid or j < hi:
                if i < mid and (j >= hi or a[i] <= a[j]):
                    src = i
                    i += 1
                else:
                    src = j
                    j += 1
                deps = (last_a[src],) if src in last_a else ()
                ld = tb.load(A, src, deps)
                cmp = tb.op(T.ICMP, ld)
                last_t[k] = tb.store(TMP, k, (cmp,))
                k += 1
            for t in range(lo, hi):           # copy temp back into a
                ld = tb.load(TMP, t, (last_t[t],))
                last_a[t] = tb.store(A, t, (ld,))
        out = a.copy()                         # the merge on the values
        for lo in range(0, n, 2 * width):
            mid = min(lo + width, n)
            hi = min(lo + 2 * width, n)
            out[lo:hi] = np.sort(np.concatenate([a[lo:mid], a[mid:hi]]),
                                 kind="stable")
        a = out
        width *= 2
    return tb.build()
