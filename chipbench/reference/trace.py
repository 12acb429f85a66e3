"""The reference's own trace: a struct of numpy arrays and the builder
that the per-configuration generators (``chipbench/configs/*.py``) use.

A trace is the dynamic data-dependence graph of one run of a MachSuite
kernel: memory ops carry an array and a byte address, compute ops a
functional-unit class, and every node lists its predecessors, which all
have smaller ids.  This is the benchmark's own copy of that format,
frozen here so that the comparison which decides ``correct`` does not
depend on the program it judges.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LOAD, STORE = 0, 1
FADD, FMUL, FDIV, IADD, IMUL, ICMP, LOGIC = 2, 3, 4, 5, 6, 7, 8

# issue-to-result latency in cycles, by op kind (the paper's 45 nm FU
# library); a load's latency is the sweep's mem_latency instead
LATENCY = (2, 1, 3, 4, 16, 1, 3, 1, 1)

# functional-unit classes in resource-class order, and the class of
# each compute kind
FU_ORDER = ("fadd", "fmul", "fdiv", "iadd", "imul", "icmp", "logic")
FU_OF_KIND = {FADD: "fadd", FMUL: "fmul", FDIV: "fdiv", IADD: "iadd",
              IMUL: "imul", ICMP: "icmp", LOGIC: "logic"}


@dataclasses.dataclass
class Trace:
    kinds: np.ndarray          # [N] int8
    array_ids: np.ndarray      # [N] int16, -1 for compute ops
    addrs: np.ndarray          # [N] int64 byte addresses, -1 for compute
    pred_ptr: np.ndarray       # [N+1] CSR offsets into pred_idx
    pred_idx: np.ndarray       # [E] predecessor ids
    array_names: dict
    word_bytes: dict
    name: str

    @property
    def n_nodes(self) -> int:
        return int(self.kinds.shape[0])


class TraceBuilder:
    """Append-only builder: each call returns the new node's id."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._kinds: list = []
        self._arrays: list = []
        self._addrs: list = []
        self._preds: list = []
        self.array_names: dict = {}
        self.word_bytes: dict = {}

    def declare_array(self, name: str, word_bytes: int) -> int:
        aid = len(self.array_names)
        self.array_names[aid] = name
        self.word_bytes[aid] = word_bytes
        return aid

    def add(self, kind: int, deps=(), array: int = -1,
            index: int = -1) -> int:
        """``index`` is the element index into ``array``."""
        nid = len(self._kinds)
        self._kinds.append(kind)
        self._arrays.append(array)
        self._addrs.append(index * self.word_bytes[array]
                           if array >= 0 and index >= 0 else -1)
        self._preds.append(tuple(int(d) for d in deps))
        return nid

    def load(self, array: int, index: int, deps=()) -> int:
        return self.add(LOAD, deps, array, index)

    def store(self, array: int, index: int, deps=()) -> int:
        return self.add(STORE, deps, array, index)

    def op(self, kind: int, *deps: int) -> int:
        return self.add(kind, deps)

    def build(self) -> Trace:
        n = len(self._kinds)
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum([len(p) for p in self._preds], out=ptr[1:])
        idx = np.fromiter((d for p in self._preds for d in p), np.int64,
                          int(ptr[-1]))
        return Trace(kinds=np.asarray(self._kinds, np.int8),
                     array_ids=np.asarray(self._arrays, np.int16),
                     addrs=np.asarray(self._addrs, np.int64),
                     pred_ptr=ptr, pred_idx=idx,
                     array_names=dict(self.array_names),
                     word_bytes=dict(self.word_bytes), name=self.name)
