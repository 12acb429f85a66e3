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

Each module also has its runnable implementation, ``run_torch`` (the
reference's ``run_jax``), which computes on the device of the tensors it
is given, and the numpy references it is held to.

``trace_cache_key`` names a trace without generating it (the sweep
cache's manifest maps it to the trace's fingerprint).  The reference's
on-disk trace cache is not here: ``get_trace`` memoizes generated traces
in memory only, so every consumer in one process shares one trace object
and its prepared-trace analysis.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import pathlib
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

_TRACE_CACHE_VERSION = 1
_SRC_HASH_MEMO: dict = {}


def _module_src_hash(mod) -> str:
    """Content hash of the benchmark module's source file, so an edit to
    a ``gen_trace`` changes its :func:`trace_cache_key`."""
    path = getattr(mod, "__file__", None)
    if path not in _SRC_HASH_MEMO:
        src = pathlib.Path(path) if path else None
        _SRC_HASH_MEMO[path] = (
            hashlib.sha256(src.read_bytes()).hexdigest()[:16]
            if src is not None and src.is_file() else "nosrc")
    return _SRC_HASH_MEMO[path]


def trace_cache_key(name: str, params=None, *, full: bool = False) -> str:
    """Stable identity of ``get_trace(name, params, full=full)`` WITHOUT
    generating the trace.

    Trace generation is pure in (module source, params), so this key
    changes exactly when the generated trace would.  The DSE sweep cache
    maps it to the trace *fingerprint* (``manifest.json``), letting a
    fully-cached sweep skip trace generation and preparation entirely.
    It hashes this package's module source, so it differs from the JAX
    package's key for the same benchmark; the sweep cache's point
    entries, keyed by the trace's fingerprint, are shared all the same.
    """
    mod = BENCHMARKS[name]
    if params is None:
        params = mod.Params() if full else mod.TINY
    return hashlib.sha256(
        repr((_TRACE_CACHE_VERSION, _module_src_hash(mod), name,
              dataclasses.astuple(params))).encode()).hexdigest()[:24]


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


__all__ = ["BENCHMARKS", "PAPER_FIG4", "SERVING", "get_trace",
           "trace_cache_key"]
