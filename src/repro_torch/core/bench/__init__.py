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
cache's manifest maps it to the trace's fingerprint).  ``get_trace``
memoizes generated traces in memory, so every consumer in one process
shares one trace object and its prepared-trace analysis, and on disk
under ``$REPRO_CACHE_DIR/traces`` (default ``~/.cache/repro``; off with
``REPRO_NO_TRACE_CACHE``), so repeat runs skip the trace builders.  The
files are keyed by :func:`trace_cache_key`, which hashes this package's
module source, so the two packages never read each other's files.

Unlike the reference, a damaged trace file is not silently regenerated:
each file carries a sha256 of its payload, and one that fails it raises
an error naming its path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import io
import json
import os
import pathlib
from collections.abc import Mapping

import numpy as np

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


_TRACE_ARRAYS = ("kinds", "array_ids", "addrs", "pred_ptr", "pred_idx")


def _disk_cache_path(name: str, params) -> "pathlib.Path | None":
    """Where the generated trace of ``(name, params)`` is kept on disk, or
    None when ``REPRO_NO_TRACE_CACHE`` is set.  The key is
    :func:`trace_cache_key`, which hashes the generator module's source:
    stale traces are never reused."""
    if os.environ.get("REPRO_NO_TRACE_CACHE"):
        return None
    root = pathlib.Path(os.environ.get("REPRO_CACHE_DIR")
                        or pathlib.Path.home() / ".cache" / "repro")
    return root / "traces" / f"{name}-{trace_cache_key(name, params)}.trace"


def _trace_from_disk(path: pathlib.Path):
    """The trace in ``path``: a line with the sha256 of the payload, then
    an ``.npz`` payload of the trace's arrays and its ``meta`` JSON.
    Raises ``ValueError`` naming ``path`` when the digest does not match
    (a torn or edited file): delete the file to regenerate it."""
    from repro_torch.core.sim.trace import Trace

    raw = path.read_bytes()
    head, _, body = raw.partition(b"\n")
    if head != hashlib.sha256(body).hexdigest().encode():
        raise ValueError(f"damaged trace cache file {path}: its sha256 "
                         "does not match its contents; delete it to "
                         "regenerate the trace")
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        return Trace(
            **{k: z[k] for k in _TRACE_ARRAYS},
            array_names={int(k): v for k, v in meta["array_names"].items()},
            word_bytes={int(k): int(v)
                        for k, v in meta["word_bytes"].items()},
            name=meta["name"])


def _trace_to_disk(path: pathlib.Path, tr) -> None:
    """Write ``tr`` as :func:`_trace_from_disk` reads it, atomically (a
    temp file, then ``os.replace``)."""
    buf = io.BytesIO()
    meta = json.dumps({"name": tr.name, "array_names": tr.array_names,
                       "word_bytes": tr.word_bytes})
    np.savez(buf, meta=np.asarray(meta),
             **{k: getattr(tr, k) for k in _TRACE_ARRAYS})
    body = buf.getvalue()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(hashlib.sha256(body).hexdigest().encode() + b"\n"
                    + body)
    os.replace(tmp, path)


def get_trace(name: str, params=None, *, full: bool = False):
    """Memoized ``BENCHMARKS[name].gen_trace(params)``.

    ``params`` defaults to the module's full-size ``Params()`` when
    ``full`` else ``TINY``.  Traces are cached per (benchmark, params) —
    in memory for the process lifetime and on disk under
    ``$REPRO_CACHE_DIR`` (``~/.cache/repro``) across runs — so every
    consumer shares one trace object and its prepared-trace analysis.
    """
    mod = BENCHMARKS[name]
    if params is None:
        params = mod.Params() if full else mod.TINY
    key = (name, dataclasses.astuple(params))
    tr = _TRACE_MEMO.get(key)
    if tr is None:
        path = _disk_cache_path(name, params)
        if path is not None and path.is_file():
            tr = _trace_from_disk(path)
        else:
            tr = mod.gen_trace(params)
            if path is not None:
                _trace_to_disk(path, tr)
        _TRACE_MEMO[key] = tr
    return tr


__all__ = ["BENCHMARKS", "PAPER_FIG4", "SERVING", "get_trace",
           "trace_cache_key"]
