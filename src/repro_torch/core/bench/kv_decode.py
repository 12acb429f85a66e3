"""Batched banked KV-cache decode at serving scale (ROADMAP north star).

One decode step of flash attention over a per-request KV cache with a
*mixed-length* batch — the continuous-batching traffic shape an LLM
inference accelerator sees (large batch, long context, every request at
a different position).  Geometry follows the checked-in model configs
(`repro_torch.configs`: qwen3-1.7b runs 8 KV heads of head_dim 128); one
trace word stands for one head_dim vector tile.

The engine walks cache positions in lockstep across the (request,
kv-head) rows — the execution order of the batched decode kernel
(`kernels/banked_kv_decode.py`) — so consecutive K/V accesses stride by
a whole context window.  That makes the K/V streams the archetypal
low-spatial-locality multi-port burst of the paper's Fig-5 claim, while
the per-row online-softmax recurrence keeps every access data-dependent
on the request's own length.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    batch: int = 16          # concurrent decode requests
    n_kv_heads: int = 2      # KV heads kept per request (GQA groups)
    max_len: int = 128       # cache capacity S (context window)
    head_dim: int = 64       # per-head vector width (ref math only)
    seed: int = 23


TINY = Params(batch=4, n_kv_heads=2, max_len=16, head_dim=8)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    return {
        "q": rng.standard_normal(
            (p.batch, p.n_kv_heads, p.head_dim)).astype(np.float32),
        "k": rng.standard_normal(
            (p.batch, p.n_kv_heads, p.max_len, p.head_dim)
        ).astype(np.float32),
        "v": rng.standard_normal(
            (p.batch, p.n_kv_heads, p.max_len, p.head_dim)
        ).astype(np.float32),
        # mixed request lengths: each row is at its own decode position
        "lengths": rng.integers(1, p.max_len + 1, p.batch).astype(np.int32),
    }


def run_np(q: np.ndarray, k: np.ndarray, v: np.ndarray,
           lengths: np.ndarray) -> np.ndarray:
    """Online-softmax (flash) decode, position at a time — the same
    one-pass recurrence the trace generator models."""
    b_, h_, d_ = q.shape
    out = np.zeros((b_, h_, d_), np.float32)
    scale = 1.0 / np.sqrt(d_)
    for b in range(b_):
        for h in range(h_):
            m = -np.inf
            den = 0.0
            acc = np.zeros(d_, np.float64)
            for pos in range(int(lengths[b])):
                s = float(q[b, h] @ k[b, h, pos]) * scale
                m_new = max(m, s)
                c = np.exp(m - m_new) if np.isfinite(m) else 0.0
                w = np.exp(s - m_new)
                den = den * c + w
                acc = acc * c + w * v[b, h, pos].astype(np.float64)
                m = m_new
            out[b, h] = (acc / den).astype(np.float32)
    return out


def run_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Masked dense decode attention on the device of ``q`` (the two
    formulations must agree: online rescaling vs one-shot softmax)."""
    d_ = q.shape[-1]
    s_ = k.shape[2]
    scores = torch.einsum("bhd,bhsd->bhs", q, k) / math.sqrt(d_)
    valid = (torch.arange(s_, device=q.device)[None, None, :]
             < lengths[:, None, None])
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.where(valid,
                    torch.exp(scores - scores.amax(-1, keepdim=True)), 0.0)
    w = w / w.sum(-1, keepdim=True)
    return torch.einsum("bhs,bhsd->bhd", w, v)


def gen_trace(p: Params = Params()) -> T.Trace:
    lengths = make_inputs(p)["lengths"]
    b_, h_, s_ = p.batch, p.n_kv_heads, p.max_len
    tb = T.TraceBuilder("kv_decode")
    LEN = tb.declare_array("lengths", 4)
    Q = tb.declare_array("q", 8)
    K = tb.declare_array("k_cache", 8)
    V = tb.declare_array("v_cache", 8)
    OUT = tb.declare_array("out", 8)
    llen = [tb.load(LEN, b) for b in range(b_)]
    rows = [(b, h) for b in range(b_) for h in range(h_)]
    lq = {}
    acc = {}
    for b, h in rows:
        r = b * h_ + h
        lq[r] = tb.load(Q, r, (llen[b],))
        acc[r] = -1
    # lockstep continuous batching: all live rows advance one position
    # per step, so the K/V bursts interleave across the whole batch
    for pos in range(s_):
        for b, h in rows:
            if pos >= int(lengths[b]):
                continue
            r = b * h_ + h
            lk = tb.load(K, r * s_ + pos, (lq[r],))
            s = tb.op(T.FMUL, lk, lq[r])                 # q . k tile
            mx = (tb.op(T.ICMP, s) if acc[r] < 0
                  else tb.op(T.ICMP, s, acc[r]))          # online max/rescale
            lv = tb.load(V, r * s_ + pos, (mx,))
            wv = tb.op(T.FMUL, lv, mx)
            acc[r] = wv if acc[r] < 0 else tb.op(T.FADD, wv, acc[r])
    for b, h in rows:
        r = b * h_ + h
        nrm = tb.op(T.FDIV, acc[r])                       # 1/denominator
        tb.store(OUT, r, (nrm,))
    return tb.build()
