"""The plain reference of ``machsuite-md_knn``: MachSuite md/knn
(Lennard-Jones forces over a k-nearest-neighbour list, 256 atoms, 16
neighbours) traced as the benchmark's own copy of the generator.

The positions are gathered through the neighbour list drawn from the
seed: data-dependent strides, the paper's low-locality benchmark.
"""
import numpy as np

from chipbench.reference import trace as T


def neighbor_list(n_atoms: int, max_neighbors: int, seed: int
                  ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rng.uniform(0.0, 20.0, size=(n_atoms, 3))      # the positions' draw
    return np.stack(
        [rng.choice(np.delete(np.arange(n_atoms), i), size=max_neighbors,
                    replace=False) for i in range(n_atoms)]
    ).astype(np.int32)


def gen_trace(params: dict, seed: int) -> T.Trace:
    n_atoms = int(params["n_atoms"])
    k = int(params["max_neighbors"])
    nl = neighbor_list(n_atoms, k, seed)
    tb = T.TraceBuilder("md_knn")
    NL = tb.declare_array("NL", 4)
    PX = tb.declare_array("position_x", 8)
    PY = tb.declare_array("position_y", 8)
    PZ = tb.declare_array("position_z", 8)
    FX = tb.declare_array("force_x", 8)
    FY = tb.declare_array("force_y", 8)
    FZ = tb.declare_array("force_z", 8)
    for i in range(n_atoms):
        lx, ly, lz = tb.load(PX, i), tb.load(PY, i), tb.load(PZ, i)
        accx = accy = accz = -1
        for j in range(k):
            ln = tb.load(NL, i * k + j)
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
