"""GEMM-NCUBED (MachSuite gemm/ncubed): naive triple-loop fp64 matmul.

Low spatial locality per the paper IV-B: 8-byte fp64 words bound the
Weinberg contribution to <=1/8 even on the unit-element-stride stream,
and the B matrix is walked down columns (stride = 8*n bytes).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n: int = 24          # MachSuite uses 64; reduced for trace tractability


TINY = Params(n=6)


def run_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the operands' full precision on their device (the
    reference's ``precision="highest"``).  On the card an f32 product
    must not run on TF32 tensor cores: the global setting is read, never
    changed."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("gemm_ncubed.run_torch needs TF32 matmuls off "
                           "(torch.backends.cuda.matmul.allow_tf32)")
    return a @ b


def gen_trace(p: Params = Params()) -> T.Trace:
    n = p.n
    tb = T.TraceBuilder("gemm_ncubed")
    A = tb.declare_array("A", 8)
    B = tb.declare_array("B", 8)
    C = tb.declare_array("C", 8)
    for i in range(n):
        for j in range(n):
            acc = -1
            for k in range(n):
                la = tb.load(A, i * n + k)
                lb = tb.load(B, k * n + j)
                mul = tb.op(T.FMUL, la, lb)
                acc = tb.op(T.FADD, mul, acc) if acc >= 0 else tb.op(T.FADD, mul)
            tb.store(C, i * n + j, (acc,))
    return tb.build()
