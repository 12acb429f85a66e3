"""RADIX-SORT (MachSuite sort/radix): LSD radix sort, 2-bit digits,
ping-ponged int32 buffers.

Each pass histograms the keys, exclusive-scans the 4-entry bucket
array, then scatters every key to its counted position — the scatter
stores land at data-dependent addresses that interleave the four digit
regions, while the key reads stay stride-one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T

RADIX_BITS = 2
N_BUCKETS = 1 << RADIX_BITS


@dataclasses.dataclass(frozen=True)
class Params:
    n: int = 256             # MachSuite: 2048 keys
    value_bits: int = 16     # MachSuite: full 32-bit keys (16 passes)
    seed: int = 37


TINY = Params(n=48, value_bits=6)


def make_input(p: Params) -> np.ndarray:
    rng = np.random.default_rng(p.seed)
    return rng.integers(0, 1 << p.value_bits, size=p.n, dtype=np.int32)


def n_passes(p: Params) -> int:
    return (p.value_bits + RADIX_BITS - 1) // RADIX_BITS


def run_np(a: np.ndarray, value_bits: int) -> np.ndarray:
    a = a.copy()
    for shift in range(0, value_bits, RADIX_BITS):
        digit = (a >> shift) & (N_BUCKETS - 1)
        bucket = np.bincount(digit, minlength=N_BUCKETS)
        offset = np.zeros(N_BUCKETS, np.int64)
        np.cumsum(bucket[:-1], out=offset[1:])
        out = np.empty_like(a)
        for x, d in zip(a, digit):
            out[offset[d]] = x
            offset[d] += 1
        a = out
    return a


def run_torch(a: torch.Tensor, value_bits: int) -> torch.Tensor:
    """Counting sort per 2-bit digit on the device of ``a``: one-hot
    histogram + exclusive scan + rank-within-digit scatter (a stable LSD
    radix sort)."""
    rows = torch.arange(a.shape[0], device=a.device)
    buckets = torch.arange(N_BUCKETS, device=a.device)
    for shift in range(0, value_bits, RADIX_BITS):
        digit = ((a >> shift) & (N_BUCKETS - 1)).long()
        onehot = (digit[:, None] == buckets[None, :]).long()
        counts = onehot.sum(dim=0)
        offset = torch.cumsum(counts, dim=0) - counts   # exclusive scan
        rank = torch.cumsum(onehot, dim=0) - onehot     # stable in digit
        pos = offset[digit] + rank[rows, digit]
        out = torch.empty_like(a)
        out[pos] = a
        a = out
    return a


def gen_trace(p: Params = Params()) -> T.Trace:
    a = make_input(p).astype(np.int64)
    tb = T.TraceBuilder("radix_sort")
    # ping-pong key buffers + histogram/scan scratch (MachSuite a/b/bucket)
    BUF = [tb.declare_array("a", 4), tb.declare_array("b", 4)]
    BUCKET = tb.declare_array("bucket", 4)
    SUM = tb.declare_array("sum", 4)
    last_buf: list[dict[int, int]] = [{}, {}]
    src = 0
    for shift in range(0, p.value_bits, RADIX_BITS):
        digit = (a >> shift) & (N_BUCKETS - 1)
        # histogram
        last_bucket: dict[int, int] = {}
        for i in range(p.n):
            deps = (last_buf[src][i],) if i in last_buf[src] else ()
            lk = tb.load(BUF[src], i, deps)
            dig = tb.op(T.LOGIC, lk)
            d = int(digit[i])
            bdeps = (dig,) + ((last_bucket[d],) if d in last_bucket else ())
            lb = tb.load(BUCKET, d, bdeps)
            inc = tb.op(T.IADD, lb)
            last_bucket[d] = tb.store(BUCKET, d, (inc,))
        # exclusive scan of the 4 buckets into sum
        last_sum: dict[int, int] = {}
        carry = -1
        for k in range(N_BUCKETS):
            lb = tb.load(BUCKET, k, (last_bucket[k],)
                         if k in last_bucket else ())
            acc = tb.op(T.IADD, lb, carry) if carry >= 0 else tb.op(T.IADD, lb)
            last_sum[k] = tb.store(SUM, k, (acc,))
            carry = acc
        # scatter
        offset = np.zeros(N_BUCKETS, np.int64)
        np.cumsum(np.bincount(digit, minlength=N_BUCKETS)[:-1],
                  out=offset[1:])
        out = np.empty_like(a)
        for i in range(p.n):
            deps = (last_buf[src][i],) if i in last_buf[src] else ()
            lk = tb.load(BUF[src], i, deps)
            dig = tb.op(T.LOGIC, lk)
            d = int(digit[i])
            ls = tb.load(SUM, d, (dig, last_sum[d]))
            pos = int(offset[d])
            offset[d] += 1
            out[pos] = a[i]
            last_buf[1 - src][pos] = tb.store(BUF[1 - src], pos, (ls,))
            inc = tb.op(T.IADD, ls)
            last_sum[d] = tb.store(SUM, d, (inc,))
        a = out
        src = 1 - src
    return tb.build()
