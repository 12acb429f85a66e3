"""SPMV-CRS (MachSuite spmv/crs): sparse matrix-vector multiply over a
compressed-row-storage matrix, fp64 values + int32 column indices.

The dense vector is gathered through ``cols`` — a data-dependent access
stream whose strides follow the (random) sparsity pattern, the paper's
archetype of an index-chasing, low-spatial-locality kernel.  The ``val``
and ``cols`` streams themselves are stride-one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n: int = 494             # MachSuite: N=494 rows
    nnz_per_row: int = 10    # MachSuite: L=10 nonzeros/row (mean here)
    seed: int = 19


TINY = Params(n=32, nnz_per_row=4)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    counts = rng.integers(1, 2 * p.nnz_per_row, size=p.n)
    row_ptr = np.zeros(p.n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    cols = np.concatenate(
        [np.sort(rng.choice(p.n, size=int(c), replace=False))
         for c in counts]).astype(np.int32)
    return {
        "vals": rng.standard_normal(int(row_ptr[-1])),
        "cols": cols,
        "row_ptr": row_ptr,
        "vec": rng.standard_normal(p.n),
    }


def run_np(vals: np.ndarray, cols: np.ndarray, row_ptr: np.ndarray,
           vec: np.ndarray) -> np.ndarray:
    out = np.zeros(row_ptr.shape[0] - 1, vals.dtype)
    for i in range(out.shape[0]):
        acc = 0.0
        for j in range(int(row_ptr[i]), int(row_ptr[i + 1])):
            acc += vals[j] * vec[cols[j]]
        out[i] = acc
    return out


def run_torch(vals: torch.Tensor, cols: torch.Tensor, row_ptr: np.ndarray,
              vec: torch.Tensor) -> torch.Tensor:
    """CRS y = A @ x as a gather + segment ``index_add_`` on the device
    of ``vals``.  ``row_ptr`` is static (numpy): the row segmentation is
    part of the matrix structure, like the trace generator's loop
    bounds."""
    row_ptr = np.asarray(row_ptr)
    n = row_ptr.shape[0] - 1
    rows = torch.from_numpy(np.repeat(np.arange(n), np.diff(row_ptr))
                            ).to(vals.device)
    contrib = vals * vec[cols.long()]
    return torch.zeros(n, dtype=vals.dtype, device=vals.device
                       ).index_add_(0, rows, contrib)


def gen_trace(p: Params = Params()) -> T.Trace:
    inp = make_inputs(p)
    cols, row_ptr = inp["cols"], inp["row_ptr"]
    tb = T.TraceBuilder("spmv_crs")
    VAL = tb.declare_array("val", 8)
    COL = tb.declare_array("cols", 4)
    ROWD = tb.declare_array("rowDelimiters", 4)
    VEC = tb.declare_array("vec", 8)
    OUT = tb.declare_array("out", 8)
    for i in range(p.n):
        lb = tb.load(ROWD, i)
        le = tb.load(ROWD, i + 1)
        acc = -1
        for j in range(int(row_ptr[i]), int(row_ptr[i + 1])):
            lv = tb.load(VAL, j, (lb, le))
            lc = tb.load(COL, j, (lb, le))
            lx = tb.load(VEC, int(cols[j]), (lc,))   # data-dependent gather
            mul = tb.op(T.FMUL, lv, lx)
            acc = tb.op(T.FADD, mul, acc) if acc >= 0 else mul
        tb.store(OUT, i, (acc,) if acc >= 0 else ())
    return tb.build()
