"""Paged-attention KV gather: block-table indirection at serving scale.

vLLM-style paged KV storage: each request's context lives in fixed-size
pages scattered through a shared physical pool, found through a per
-request block table.  The pool fragments the way a real serving pool
does — requests grow one page at a time while other requests are
interleaved between them — so a request's pages stride by the number of
concurrently-growing requests, and which physical page a load touches
is only known after the previous block-table load resolves: the
archetypal data-dependent index chase (same family as ``spmv_crs``'s
column gather, but with the indirection *in the address path*).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n_seqs: int = 32         # concurrent requests sharing the pool
    page_size: int = 8       # tokens per physical page
    max_pages: int = 16      # block-table width (max context / page_size)
    seed: int = 29


TINY = Params(n_seqs=4, page_size=4, max_pages=4)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    max_len = p.page_size * p.max_pages
    lengths = rng.integers(1, max_len + 1, p.n_seqs).astype(np.int32)
    n_pages = -(-lengths // p.page_size)                 # ceil division
    # fragmented allocation: pages are handed out in growth order, all
    # live requests interleaved (request b's pages stride by however
    # many requests were still growing when it claimed each one)
    table = np.full((p.n_seqs, p.max_pages), -1, np.int32)
    counter = 0
    for step in range(p.max_pages):
        for b in range(p.n_seqs):
            if step < n_pages[b]:
                table[b, step] = counter
                counter += 1
    return {
        "block_table": table,
        "lengths": lengths,
        "kv_pool": rng.standard_normal(
            counter * p.page_size).astype(np.float32),
        "weights": rng.standard_normal(max_len).astype(np.float32),
    }


def run_np(block_table: np.ndarray, lengths: np.ndarray,
           kv_pool: np.ndarray, weights: np.ndarray,
           page_size: int) -> np.ndarray:
    """Token gather through the block table + weighted reduction (the
    attention-value accumulation with scores precomputed)."""
    out = np.zeros(lengths.shape[0], np.float32)
    for b in range(lengths.shape[0]):
        acc = 0.0
        for t in range(int(lengths[b])):
            pp = int(block_table[b, t // page_size])
            acc += kv_pool[pp * page_size + t % page_size] * weights[t]
        out[b] = acc
    return out


def run_torch(block_table: torch.Tensor, lengths: torch.Tensor,
              kv_pool: torch.Tensor, weights: torch.Tensor,
              page_size: int) -> torch.Tensor:
    """Token gather through the block table + weighted reduction on the
    device of ``kv_pool``; masked positions read index 0."""
    n_seqs, max_pages = block_table.shape
    max_len = max_pages * page_size
    t = torch.arange(max_len, device=kv_pool.device)
    pp = block_table.long().gather(
        1, (t // page_size)[None, :].expand(n_seqs, max_len))
    mask = t[None, :] < lengths[:, None]
    idx = torch.where(mask, pp * page_size + t[None, :] % page_size, 0)
    vals = kv_pool[idx] * weights[None, :]
    return torch.where(mask, vals, 0.0).sum(dim=1)


def gen_trace(p: Params = Params()) -> T.Trace:
    inp = make_inputs(p)
    table, lengths = inp["block_table"], inp["lengths"]
    tb = T.TraceBuilder("paged_kv")
    LEN = tb.declare_array("lengths", 4)
    BT = tb.declare_array("block_table", 4)
    KV = tb.declare_array("kv_pool", 8)
    W = tb.declare_array("weights", 8)
    OUT = tb.declare_array("out", 8)
    for b in range(p.n_seqs):
        ll = tb.load(LEN, b)
        acc = -1
        for lp in range(-(-int(lengths[b]) // p.page_size)):
            lbt = tb.load(BT, b * p.max_pages + lp, (ll,))
            pp = int(table[b, lp])
            n_tok = min(p.page_size, int(lengths[b]) - lp * p.page_size)
            for slot in range(n_tok):
                # page chase: the address is the block-table load's value
                lkv = tb.load(KV, pp * p.page_size + slot, (lbt,))
                lw = tb.load(W, lp * p.page_size + slot)
                m = tb.op(T.FMUL, lkv, lw)
                acc = tb.op(T.FADD, m, acc) if acc >= 0 else m
        tb.store(OUT, b, (acc,) if acc >= 0 else ())
    return tb.build()
