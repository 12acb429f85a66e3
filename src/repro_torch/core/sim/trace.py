"""Dynamic-trace representation (the Aladdin flow's LLVM trace analogue).

Aladdin compiles C to LLVM IR, executes it, and extracts a dynamic data
dependency graph (paper III-B / Fig 3).  Here each benchmark *generates*
its exact dynamic trace directly from its loop nest (same information,
no LLVM): a struct-of-arrays of ops plus CSR predecessor lists.

Op kinds: loads/stores carry (array_id, byte address); compute ops carry
a functional-unit class.  Node ids are topologically ordered by
construction (an op may only depend on earlier ops).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# op kind encoding
LOAD, STORE = 0, 1
FADD, FMUL, FDIV, IADD, IMUL, ICMP, LOGIC = 2, 3, 4, 5, 6, 7, 8

KIND_NAMES = {
    LOAD: "load", STORE: "store", FADD: "fadd", FMUL: "fmul", FDIV: "fdiv",
    IADD: "iadd", IMUL: "imul", ICMP: "icmp", LOGIC: "logic",
}
FU_CLASS = {FADD: "fadd", FMUL: "fmul", FDIV: "fdiv", IADD: "iadd",
            IMUL: "imul", ICMP: "icmp", LOGIC: "logic"}

# issue-to-result latencies in cycles (Aladdin-style 45nm FU library)
LATENCY = {LOAD: 2, STORE: 1, FADD: 3, FMUL: 4, FDIV: 16,
           IADD: 1, IMUL: 3, ICMP: 1, LOGIC: 1}


@dataclasses.dataclass
class Trace:
    kinds: np.ndarray          # [N] int8
    array_ids: np.ndarray     # [N] int16  (-1 for compute ops)
    addrs: np.ndarray          # [N] int64  byte addresses (-1 for compute)
    pred_ptr: np.ndarray       # [N+1] CSR offsets into pred_idx
    pred_idx: np.ndarray       # [E] predecessor node ids
    array_names: dict[int, str]
    word_bytes: dict[int, int]  # element size per array
    name: str = "trace"

    @property
    def n_nodes(self) -> int:
        return int(self.kinds.shape[0])

    @property
    def n_mem(self) -> int:
        return int(np.sum(self.kinds <= STORE))

    def mem_mask(self) -> np.ndarray:
        return self.kinds <= STORE

    def mem_addrs_and_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        m = self.mem_mask()
        return self.addrs[m], self.array_ids[m]

    def depths(self) -> np.ndarray:
        """Dependency depth (critical-path level) per node.

        Delegates to the memoized :class:`PreparedTrace` analysis, which
        computes depths with vectorized O(E) frontier sweeps instead of a
        per-node Python loop.
        """
        from repro_torch.core.sim.prepared import prepare_trace
        return prepare_trace(self).depth

    def stats(self) -> dict:
        m = self.mem_mask()
        return {
            "nodes": self.n_nodes,
            "mem_ops": int(m.sum()),
            "loads": int(np.sum(self.kinds == LOAD)),
            "stores": int(np.sum(self.kinds == STORE)),
            "arrays": {self.array_names[a]: int(np.sum(self.array_ids == a))
                       for a in self.array_names},
        }


class TraceBuilder:
    """Append-only builder; node ids are return values of :meth:`add`."""

    def __init__(self, name: str = "trace") -> None:
        self.name = name
        self._kinds: list[int] = []
        self._arrays: list[int] = []
        self._addrs: list[int] = []
        self._preds: list[tuple[int, ...]] = []
        self.array_names: dict[int, str] = {}
        self.word_bytes: dict[int, int] = {}

    def declare_array(self, name: str, word_bytes: int) -> int:
        aid = len(self.array_names)
        self.array_names[aid] = name
        self.word_bytes[aid] = word_bytes
        return aid

    def add(self, kind: int, deps: tuple[int, ...] = (),
            array: int = -1, index: int = -1) -> int:
        """index is the *element* index into the array; converted to bytes."""
        nid = len(self._kinds)
        self._kinds.append(kind)
        self._arrays.append(array)
        if array >= 0 and index >= 0:
            self._addrs.append(index * self.word_bytes[array])
        else:
            self._addrs.append(-1)
        self._preds.append(tuple(int(d) for d in deps))
        return nid

    # convenience wrappers -------------------------------------------------
    def load(self, array: int, index: int, deps: tuple[int, ...] = ()) -> int:
        return self.add(LOAD, deps, array, index)

    def store(self, array: int, index: int, deps: tuple[int, ...] = ()) -> int:
        return self.add(STORE, deps, array, index)

    def op(self, kind: int, *deps: int) -> int:
        return self.add(kind, tuple(deps))

    def build(self) -> Trace:
        n = len(self._kinds)
        counts = np.fromiter((len(p) for p in self._preds), np.int64, n)
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        if n and int(ptr[-1]):
            idx = np.fromiter(
                (d for p in self._preds for d in p), np.int64, int(ptr[-1]))
        else:
            idx = np.empty(0, np.int64)
        return Trace(
            kinds=np.asarray(self._kinds, np.int8),
            array_ids=np.asarray(self._arrays, np.int16),
            addrs=np.asarray(self._addrs, np.int64),
            pred_ptr=ptr,
            pred_idx=idx,
            array_names=dict(self.array_names),
            word_bytes=dict(self.word_bytes),
            name=self.name,
        )
