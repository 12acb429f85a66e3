"""MD-KNN (MachSuite md/knn): Lennard-Jones forces over a k-nearest-
neighbour list.  Position arrays are gathered through the neighbour list
-> data-dependent strides -> the paper's canonical *low* spatial
locality benchmark where true-multiport AMM shines.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n_atoms: int = 256
    max_neighbors: int = 16
    seed: int = 11


TINY = Params(n_atoms=24, max_neighbors=4)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    pos = rng.uniform(0.0, 20.0, size=(p.n_atoms, 3))
    nl = np.stack(
        [rng.choice(np.delete(np.arange(p.n_atoms), i),
                    size=p.max_neighbors, replace=False)
         for i in range(p.n_atoms)]
    ).astype(np.int32)  # an atom is never its own neighbour (r2 > 0)
    return {"position": pos, "neighbor_list": nl}


def run_torch(position: torch.Tensor, neighbor_list: torch.Tensor
              ) -> torch.Tensor:
    """LJ force accumulation (MachSuite constants lj1=1.5, lj2=2.0) on
    the device of ``position``."""
    lj1, lj2 = 1.5, 2.0
    pi = position[:, None, :]                       # [A,1,3]
    pj = position[neighbor_list.long()]             # [A,K,3]
    d = pi - pj
    r2inv = 1.0 / (d * d).sum(dim=-1)               # [A,K]
    r6inv = r2inv * r2inv * r2inv
    potential = r6inv * (lj1 * r6inv - lj2)
    force = r2inv * potential
    return (force[..., None] * d).sum(dim=1)        # [A,3]


def gen_trace(p: Params = Params()) -> T.Trace:
    inputs = make_inputs(p)
    nl = inputs["neighbor_list"]
    tb = T.TraceBuilder("md_knn")
    NL = tb.declare_array("NL", 4)
    PX = tb.declare_array("position_x", 8)
    PY = tb.declare_array("position_y", 8)
    PZ = tb.declare_array("position_z", 8)
    FX = tb.declare_array("force_x", 8)
    FY = tb.declare_array("force_y", 8)
    FZ = tb.declare_array("force_z", 8)
    for i in range(p.n_atoms):
        lx = tb.load(PX, i)
        ly = tb.load(PY, i)
        lz = tb.load(PZ, i)
        accx = accy = accz = -1
        for j in range(p.max_neighbors):
            ln = tb.load(NL, i * p.max_neighbors + j)
            jidx = int(nl[i, j])
            jx = tb.load(PX, jidx, (ln,))
            jy = tb.load(PY, jidx, (ln,))
            jz = tb.load(PZ, jidx, (ln,))
            dx = tb.op(T.FADD, lx, jx)
            dy = tb.op(T.FADD, ly, jy)
            dz = tb.op(T.FADD, lz, jz)
            sq = tb.op(T.FADD,
                       tb.op(T.FADD, tb.op(T.FMUL, dx, dx),
                             tb.op(T.FMUL, dy, dy)),
                       tb.op(T.FMUL, dz, dz))
            r2inv = tb.op(T.FDIV, sq)
            r6 = tb.op(T.FMUL, tb.op(T.FMUL, r2inv, r2inv), r2inv)
            pot = tb.op(T.FADD, tb.op(T.FMUL, r6, r6), r6)
            f = tb.op(T.FMUL, r2inv, pot)
            tx = tb.op(T.FMUL, f, dx)
            ty = tb.op(T.FMUL, f, dy)
            tz = tb.op(T.FMUL, f, dz)
            accx = tb.op(T.FADD, tx, accx) if accx >= 0 else tx
            accy = tb.op(T.FADD, ty, accy) if accy >= 0 else ty
            accz = tb.op(T.FADD, tz, accz) if accz >= 0 else tz
        tb.store(FX, i, (accx,))
        tb.store(FY, i, (accy,))
        tb.store(FZ, i, (accz,))
    return tb.build()
