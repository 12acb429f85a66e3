"""STENCIL2D (MachSuite stencil/stencil2d): 3x3 convolution over a 2-D
grid, fp32.  Compute-intensive with mixed strides (unit within a row,
row-pitch across rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    rows: int = 64
    cols: int = 64
    seed: int = 5


TINY = Params(rows=10, cols=10)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    return {
        "orig": rng.standard_normal((p.rows, p.cols)).astype(np.float32),
        "filter": rng.standard_normal((3, 3)).astype(np.float32),
    }


def run_torch(orig: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """The 3x3 stencil as nine shifted multiply-adds on the device of
    ``orig``."""
    r, c = orig.shape
    out = torch.zeros((r - 2, c - 2), dtype=orig.dtype, device=orig.device)
    for k1 in range(3):
        for k2 in range(3):
            out = out + filt[k1, k2] * orig[k1:k1 + r - 2, k2:k2 + c - 2]
    return out


def gen_trace(p: Params = Params()) -> T.Trace:
    tb = T.TraceBuilder("stencil2d")
    ORIG = tb.declare_array("orig", 4)
    FILT = tb.declare_array("filter", 4)
    SOL = tb.declare_array("sol", 4)
    filter_loads = [tb.load(FILT, i) for i in range(9)]
    for r in range(p.rows - 2):
        for c in range(p.cols - 2):
            acc = -1
            for k1 in range(3):
                for k2 in range(3):
                    ld = tb.load(ORIG, (r + k1) * p.cols + (c + k2))
                    mul = tb.op(T.FMUL, ld, filter_loads[k1 * 3 + k2])
                    acc = tb.op(T.FADD, mul, acc) if acc >= 0 else mul
            tb.store(SOL, r * p.cols + c, (acc,))
    return tb.build()
