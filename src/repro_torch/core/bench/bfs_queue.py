"""BFS-QUEUE (MachSuite bfs/queue): breadth-first traversal of a sparse
random digraph with an explicit work queue.

Every step chases pointers: node records are fetched in discovery order
(not index order), the edge list is read in per-node bursts that jump
between unrelated CSR ranges, and the byte-wide ``level`` array is
gathered/updated through edge destinations — the paper's graph-traversal
archetype of low spatial locality.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n_nodes: int = 256
    avg_deg: int = 4         # MachSuite graphs average ~8; kept sparse
    seed: int = 23
    start: int = 0


TINY = Params(n_nodes=128, avg_deg=2)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    degs = rng.integers(1, 2 * p.avg_deg + 1, size=p.n_nodes)
    edge_ptr = np.zeros(p.n_nodes + 1, np.int64)
    np.cumsum(degs, out=edge_ptr[1:])
    edges = np.concatenate(
        [np.sort(rng.choice(p.n_nodes, size=int(d), replace=False))
         for d in degs]).astype(np.int64)
    return {"edge_ptr": edge_ptr, "edges": edges}


def run_np(edge_ptr: np.ndarray, edges: np.ndarray, n: int,
           start: int = 0) -> np.ndarray:
    """Queue BFS; unreached nodes keep the sentinel level ``n``."""
    level = np.full(n, n, np.int32)
    level[start] = 0
    queue = [start]
    while queue:
        v = queue.pop(0)
        for e in range(int(edge_ptr[v]), int(edge_ptr[v + 1])):
            dst = int(edges[e])
            if level[dst] == n:
                level[dst] = level[v] + 1
                queue.append(dst)
    return level


def run_torch(edge_ptr: np.ndarray, edges: torch.Tensor, n: int,
              start: int = 0) -> torch.Tensor:
    """Level-synchronous BFS on the device of ``edges``: ``n`` rounds of
    scatter-min edge relaxation (equivalent to the queue traversal's
    level assignment).  ``edge_ptr`` is static (numpy), like the trace
    generator's loop bounds."""
    dev = edges.device
    edge_ptr = np.asarray(edge_ptr)
    src = torch.from_numpy(np.repeat(np.arange(n), np.diff(edge_ptr))).to(dev)
    dst = edges.long()
    level = torch.full((n,), n, dtype=torch.int32, device=dev)
    level[start] = 0
    for h in range(n):
        cand = torch.where(level[src] == h, h + 1, n).to(torch.int32)
        level.scatter_reduce_(0, dst, cand, "amin", include_self=True)
    return level


def gen_trace(p: Params = Params()) -> T.Trace:
    inp = make_inputs(p)
    edge_ptr, edges = inp["edge_ptr"], inp["edges"]
    n = p.n_nodes
    tb = T.TraceBuilder("bfs_queue")
    NODES = tb.declare_array("nodes", 8)    # (begin, end) pair per node
    EDGES = tb.declare_array("edges", 8)
    LEVEL = tb.declare_array("level", 1)
    QUEUE = tb.declare_array("queue", 8)
    level = np.full(n, -1, np.int64)
    level[p.start] = 0
    last_level_store: dict[int, int] = {}
    queue_store: dict[int, int] = {}
    last_level_store[p.start] = tb.store(LEVEL, p.start)
    queue_store[0] = tb.store(QUEUE, 0)
    queue = [p.start]
    front, back = 0, 1
    while front < back:
        v = queue[front]
        lq = tb.load(QUEUE, front, (queue_store[front],))
        front += 1
        lb = tb.load(NODES, 2 * v, (lq,))
        le = tb.load(NODES, 2 * v + 1, (lq,))
        for e in range(int(edge_ptr[v]), int(edge_ptr[v + 1])):
            ledge = tb.load(EDGES, e, (lb, le))
            dst = int(edges[e])
            deps = (ledge,) + ((last_level_store[dst],)
                               if dst in last_level_store else ())
            llvl = tb.load(LEVEL, dst, deps)
            cmp = tb.op(T.ICMP, llvl)
            if level[dst] < 0:
                level[dst] = level[v] + 1
                last_level_store[dst] = tb.store(LEVEL, dst, (cmp,))
                queue_store[back] = tb.store(QUEUE, back, (cmp,))
                queue.append(dst)
                back += 1
    return tb.build()
