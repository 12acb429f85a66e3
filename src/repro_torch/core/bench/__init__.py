"""Benchmark registry: the trace side (copy of the JAX package's
``core/bench``).

Each module provides ``Params`` (+ ``TINY``) and ``gen_trace(params)``,
with the numpy helpers ``gen_trace`` calls.  The four discussion
benchmarks of the paper (Fig 4) are fft_strided, gemm_ncubed, kmp,
md_knn; sort_merge, stencil2d and aes widen the locality spread for the
Fig-5 analysis, and the irregular MachSuite kernels — spmv_crs,
bfs_queue, nw, viterbi, radix_sort — populate its low/mid-locality end.
The ``SERVING`` triple adds the LLM-inference access patterns: batched
mixed-length KV-cache decode (kv_decode), paged-attention block-table
gather (paged_kv) and MoE top-k expert routing (moe_route).

Two parts of the reference registry are not here: each module's runnable
implementation (``run_jax``, ported later as ``run_torch``) and the
on-disk trace cache.  ``get_trace`` memoizes generated traces in memory
only, so every consumer in one process shares one trace object and its
prepared-trace analysis.
"""
from __future__ import annotations

import dataclasses
import importlib
from collections.abc import Mapping

_BENCH_NAMES = ("fft_strided", "gemm_ncubed", "kmp", "md_knn",
                "sort_merge", "stencil2d", "aes",
                "spmv_crs", "bfs_queue", "nw", "viterbi", "radix_sort",
                "kv_decode", "paged_kv", "moe_route")


class _LazyRegistry(Mapping):
    """name -> benchmark module, imported on first access."""

    def __getitem__(self, name: str):
        if name not in _BENCH_NAMES:
            raise KeyError(name)
        return importlib.import_module(f"repro_torch.core.bench.{name}")

    def __iter__(self):
        return iter(_BENCH_NAMES)

    def __len__(self) -> int:
        return len(_BENCH_NAMES)


BENCHMARKS = _LazyRegistry()

PAPER_FIG4 = ("fft_strided", "gemm_ncubed", "kmp", "md_knn")

# the LLM-serving workload family
SERVING = ("kv_decode", "paged_kv", "moe_route")

_TRACE_MEMO: dict = {}


def get_trace(name: str, params=None, *, full: bool = False):
    """Memoized ``BENCHMARKS[name].gen_trace(params)``.

    ``params`` defaults to the module's full-size ``Params()`` when
    ``full`` else ``TINY``.  Traces are cached in memory per (benchmark,
    params) for the process lifetime.
    """
    mod = BENCHMARKS[name]
    if params is None:
        params = mod.Params() if full else mod.TINY
    key = (name, dataclasses.astuple(params))
    tr = _TRACE_MEMO.get(key)
    if tr is None:
        tr = _TRACE_MEMO[key] = mod.gen_trace(params)
    return tr


__all__ = ["BENCHMARKS", "PAPER_FIG4", "SERVING", "get_trace"]
