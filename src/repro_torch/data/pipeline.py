"""Synthetic data pipeline with tunable spatial locality: a copy of
``src/repro/data/pipeline.py`` without its unused jax import, so the
port's batches are bit-equal to the reference's for the same config.

The corpus is a deterministic order-1 Markov token stream whose
stationary distribution is Zipf(alpha).  alpha controls how skewed the
embedding-gather address stream is: the knob the AMM memory planner
(``repro_torch.memory.planner``) reads.  Every (process, data-shard)
pair derives a disjoint deterministic key; a daemon thread keeps
``prefetch`` batches ready.  Batches are numpy; ``launch.train`` moves
them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    zipf_alpha: float = 1.2
    markov_order_strength: float = 0.7   # prob of following the chain
    seed: int = 1234
    n_shards: int = 1
    shard_id: int = 0
    prefetch: int = 2


class SyntheticCorpus:
    """Deterministic, learnable synthetic LM corpus."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.local_batch = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self.stationary = p / p.sum()
        # sparse deterministic "grammar": each token has one likely successor
        self.successor = rng.permutation(v).astype(np.int64)

    def batch_iter(self) -> Iterator[dict[str, np.ndarray]]:
        cfg = self.cfg
        step = 0
        while True:
            rng = np.random.default_rng(
                (cfg.seed, cfg.shard_id, step))
            b, s = self.local_batch, cfg.seq_len
            follow = rng.random((b, s)) < cfg.markov_order_strength
            fresh = rng.choice(cfg.vocab, size=(b, s), p=self.stationary)
            toks = np.empty((b, s + 1), np.int32)
            toks[:, 0] = fresh[:, 0]
            for t in range(1, s + 1):
                nxt = self.successor[toks[:, t - 1]]
                toks[:, t] = np.where(follow[:, t - 1], nxt, fresh[:, t - 1])
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
            step += 1

    def embedding_trace(self, n_tokens: int = 8192) -> np.ndarray:
        """Byte-address stream of the embedding gathers this corpus
        generates, for the AMM planner and the locality metric."""
        it = self.batch_iter()
        out = []
        while sum(x.size for x in out) < n_tokens:
            out.append(next(it)["tokens"].reshape(-1))
        ids = np.concatenate(out)[:n_tokens]
        return ids.astype(np.int64) * 4          # 4-byte table rows


class PrefetchLoader:
    """Runs the corpus iterator in a daemon thread."""

    def __init__(self, corpus: SyntheticCorpus) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=corpus.cfg.prefetch)
        self._stop = threading.Event()

        def worker() -> None:
            for batch in corpus.batch_iter():
                if self._stop.is_set():
                    return
                self._q.put(batch)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        return self._q.get()

    def close(self) -> None:
        """Stop the worker: set the flag and free one slot, so a worker
        blocked on a full queue wakes, sees the flag and returns."""
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
