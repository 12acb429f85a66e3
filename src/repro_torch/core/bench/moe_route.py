"""MoE top-k expert routing: gather/scatter through per-expert queues.

Mirrors the capacity-based dispatch of the MoE layer
(``models/moe.py::moe_apply``) for a single sequence: top-k softmax gating, row-local queue positions via
cumulative counts, capacity-dropped overflow, and the combine
scatter-add back to token order.  The memory shape is two coupled
irregular phases: routing scatters token ids into per-expert queues
(write stream ordered by the *gating*, not the address), then each
expert drains its queue with data-dependent token gathers and writes
results back through the same indirection — at cluster scale this is
the paper's lens on expert banks as a multi-ported memory
(``repro_torch.memory.planner.expert_stream``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n_tokens: int = 512
    n_experts: int = 16
    top_k: int = 2
    capacity_factor: float = 1.25
    seed: int = 31


# the tighter capacity factor makes some experts overflow at TINY size,
# so the capacity-drop path is exercised by goldens and property tests
TINY = Params(n_tokens=64, n_experts=4, capacity_factor=0.75)


def capacity(p: Params) -> int:
    """Same rule as moe.moe_apply: C = max(int(cf * T * K / E), 1)."""
    return max(int(p.capacity_factor * p.n_tokens * p.top_k
                   / p.n_experts), 1)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    return {
        "logits": rng.standard_normal(
            (p.n_tokens, p.n_experts)).astype(np.float32),
        "x": rng.standard_normal(p.n_tokens).astype(np.float32),
        "w_exp": rng.standard_normal(p.n_experts).astype(np.float32),
    }


def _route_np(logits: np.ndarray, top_k: int):
    """Top-k gating: normalized gates + expert choices, flat (t,k)
    order — the order that defines queue positions."""
    z = logits - logits.max(axis=1, keepdims=True)
    gates = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    top_e = np.argsort(-gates, axis=1, kind="stable")[:, :top_k]
    top_g = np.take_along_axis(gates, top_e, axis=1)
    top_g = top_g / np.maximum(top_g.sum(axis=1, keepdims=True), 1e-9)
    return top_g, top_e


def run_np(logits: np.ndarray, x: np.ndarray, w_exp: np.ndarray,
           top_k: int, capacity_factor: float) -> np.ndarray:
    t_, e_ = logits.shape
    cap = max(int(capacity_factor * t_ * top_k / e_), 1)
    top_g, top_e = _route_np(logits, top_k)
    counts = np.zeros(e_, np.int64)
    y = np.zeros(t_, np.float32)
    for t in range(t_):
        for j in range(top_k):
            e = int(top_e[t, j])
            pos = counts[e]
            counts[e] += 1
            if pos < cap:                       # over capacity: dropped
                y[t] += top_g[t, j] * x[t] * w_exp[e]
    return y


def run_torch(logits: torch.Tensor, x: torch.Tensor, w_exp: torch.Tensor,
              top_k: int, capacity_factor: float) -> torch.Tensor:
    """The sort-free dispatch-table formulation (one row) on the device
    of ``logits``.  Over-capacity entries go to a sentinel slot
    ``e * cap`` that is sliced off; the per-token sum is an
    ``index_add_``, whose float atomics on CUDA are unordered."""
    t_, e_ = logits.shape
    dev = logits.device
    cap = max(int(capacity_factor * t_ * top_k / e_), 1)
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    top_g, top_e = torch.topk(gates, top_k, dim=-1)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(t_ * top_k)
    onehot = torch.nn.functional.one_hot(flat_e, e_)
    pos = torch.cumsum(onehot, dim=0) - 1
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    dest = torch.where(slot < cap, flat_e * cap + slot, e_ * cap)
    token_ids = torch.arange(t_, device=dev).repeat_interleave(top_k)
    table = torch.full((e_ * cap + 1,), t_, dtype=torch.int64, device=dev)
    table[dest] = token_ids
    gate_tbl = torch.zeros(e_ * cap + 1, dtype=torch.float32, device=dev)
    gate_tbl[dest] = top_g.reshape(-1)
    table, gate_tbl = table[:-1], gate_tbl[:-1]
    x_pad = torch.cat([x, x.new_zeros(1)])
    contrib = (x_pad[table] * w_exp.repeat_interleave(cap) * gate_tbl
               ).to(torch.float32)
    out = torch.zeros(t_ + 1, dtype=torch.float32, device=dev)
    return out.index_add_(0, table, contrib)[:t_]


def gen_trace(p: Params = Params()) -> T.Trace:
    inp = make_inputs(p)
    _, top_e = _route_np(inp["logits"], p.top_k)
    cap = capacity(p)
    tb = T.TraceBuilder("moe_route")
    TOK = tb.declare_array("tokens", 8)
    CNT = tb.declare_array("expert_counts", 4)
    QUEUE = tb.declare_array("expert_queues", 4)
    WEXP = tb.declare_array("expert_weights", 8)
    OUT = tb.declare_array("out", 8)
    # phase 1 — routing: scatter token ids into per-expert queues; the
    # write stream is ordered by the gating decision, not the address
    counts = np.zeros(p.n_experts, np.int64)
    queues: list[list[int]] = [[] for _ in range(p.n_experts)]
    for t in range(p.n_tokens):
        lt = tb.load(TOK, t)
        sel = tb.op(T.ICMP, lt)                # top-k select of router row
        for j in range(p.top_k):
            e = int(top_e[t, j])
            lc = tb.load(CNT, e, (sel,))       # queue-tail gather
            up = tb.op(T.IADD, lc)
            tb.store(CNT, e, (up,))
            pos = int(counts[e])
            counts[e] += 1
            if pos < cap:
                queues[e].append(t)
                tb.store(QUEUE, e * cap + pos, (up, lt))
    # phase 2 — expert drain: each queue slot names a token; gather it,
    # apply the expert, scatter the result back to token order
    for e in range(p.n_experts):
        lw = tb.load(WEXP, e)
        for c, t in enumerate(queues[e]):
            lq = tb.load(QUEUE, e * cap + c)
            lx = tb.load(TOK, t, (lq,))        # data-dependent gather
            m = tb.op(T.FMUL, lx, lw)
            m2 = tb.op(T.FADD, m, lq)          # gate-weighted combine
            tb.store(OUT, t, (m2,))            # data-dependent scatter
    return tb.build()
