"""Prepared-trace layer: one-time, vectorized per-trace analysis (copy
of the JAX package's ``core/sim/prepared.py``).

The DSE evaluates the *same* dynamic trace under dozens of memory
designs and unroll factors.  :class:`PreparedTrace` computes everything
that depends only on the trace **once** (vectorized with numpy O(E)
frontier sweeps), so each design point pays only for the cycle loop.

PreparedTrace contract
----------------------
A ``PreparedTrace`` is an immutable companion of one :class:`Trace`:

* graph structure: ``succ_ptr``/``succ_idx`` (CSR successor lists),
  ``indegree``;
* scheduling priorities: ``height`` (longest latency-weighted path to a
  sink, the list-scheduling priority) and ``depth`` (dependency level),
  from the numpy sweeps the reference calls bit-identical to its C
  analysis pass;
* per-array geometry: ``array_depths`` (power-of-two depth from the max
  word index), ``loads_per_array``/``stores_per_array``;
* locality stats: Weinberg ``locality`` over the memory stream;
* ``fingerprint``: a content hash of the trace;
* contiguous numpy per-node arrays (``is_load_np``, ``latency_np``,
  ``word_index_np``, ``klass_np``) and the padded fixed-shape tensors
  of the batched timing backend (:meth:`PreparedTrace.device_views`).

``prepare_trace(tr)`` memoizes the analysis on the trace object itself,
so repeated calls share one analysis.  The reference's plain-Python
mirrors and memory profile (its pure-Python loop and its surrogate) are
not copied yet.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.locality import trace_locality
from repro_torch.core.sim import trace as T

_PREPARED_ATTR = "_prepared_trace"

# fixed resource-class order: class id = array_id for memory ops, or
# n_arrays + FU_ORDER.index(class) for compute ops
FU_ORDER: tuple[str, ...] = ("fadd", "fmul", "fdiv", "iadd", "imul",
                             "icmp", "logic")


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


# ----------------------------------------------------------------------
# vectorized DAG analyses (O(E) total work, swept frontier by frontier)
# ----------------------------------------------------------------------
def _flatten_ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(s, e) for s, e in zip(starts, ends)]``."""
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    cum = np.cumsum(lens)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(cum - lens, lens)
    out += np.repeat(starts, lens)
    return out


def successor_csr(pred_ptr: np.ndarray, pred_idx: np.ndarray,
                  n: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR successor lists from the predecessor CSR (vectorized).

    Edge ordering matches the seed implementation: for each node ``p``
    the successors appear in increasing destination-id order.
    """
    counts = np.bincount(pred_idx, minlength=n).astype(np.int64)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    dst = np.repeat(np.arange(n, dtype=np.int64),
                    (pred_ptr[1:] - pred_ptr[:-1]))
    order = np.argsort(pred_idx, kind="stable")
    return ptr, dst[order]


def dependency_depths(pred_ptr: np.ndarray, pred_idx: np.ndarray,
                      succ_ptr: np.ndarray, succ_idx: np.ndarray) -> np.ndarray:
    """Dependency depth (critical-path level) per node, vectorized.

    Same recurrence as the seed ``Trace.depths()``:
    ``depth[i] = max(depth[preds]) + 1`` (0 for roots).
    """
    n = pred_ptr.shape[0] - 1
    indeg = (pred_ptr[1:] - pred_ptr[:-1]).astype(np.int64).copy()
    depth = np.zeros(n, np.int32)
    frontier = np.nonzero(indeg == 0)[0]
    while frontier.size:
        starts, ends = succ_ptr[frontier], succ_ptr[frontier + 1]
        edges = _flatten_ranges(starts, ends)
        if edges.size == 0:
            break
        dsts = succ_idx[edges]
        srcs = np.repeat(frontier, ends - starts)
        np.maximum.at(depth, dsts, depth[srcs] + 1)
        hit = np.bincount(dsts, minlength=n)
        indeg -= hit
        frontier = np.nonzero((indeg == 0) & (hit > 0))[0]
    return depth


def schedule_heights(kinds: np.ndarray, pred_ptr: np.ndarray,
                     pred_idx: np.ndarray, succ_ptr: np.ndarray,
                     succ_idx: np.ndarray) -> np.ndarray:
    """Longest latency-weighted path to any sink (list-sched priority).

    Same recurrence as the seed ``_heights``: sinks are 0, otherwise
    ``h[i] = max(h[succs]) + LATENCY[kind[i]]``.
    """
    n = kinds.shape[0]
    lat = np.asarray([T.LATENCY[k] for k in range(len(T.LATENCY))],
                     np.int64)[kinds]
    outdeg = (succ_ptr[1:] - succ_ptr[:-1]).astype(np.int64).copy()
    best_succ = np.zeros(n, np.int64)
    h = np.zeros(n, np.int64)
    frontier = np.nonzero(outdeg == 0)[0]          # sinks: h == 0
    while frontier.size:
        starts, ends = pred_ptr[frontier], pred_ptr[frontier + 1]
        edges = _flatten_ranges(starts, ends)
        if edges.size == 0:
            break
        preds = pred_idx[edges]
        np.maximum.at(best_succ, preds,
                      np.repeat(h[frontier], ends - starts))
        hit = np.bincount(preds, minlength=n)
        outdeg -= hit
        frontier = np.nonzero((outdeg == 0) & (hit > 0))[0]
        h[frontier] = best_succ[frontier] + lat[frontier]
    return h


# ----------------------------------------------------------------------
def trace_fingerprint(tr: T.Trace) -> str:
    """Stable content hash of a trace (the on-disk sweep-cache key)."""
    hsh = hashlib.sha256()
    hsh.update(tr.name.encode())
    for arr in (tr.kinds, tr.array_ids, tr.addrs, tr.pred_ptr, tr.pred_idx):
        hsh.update(np.ascontiguousarray(arr).tobytes())
    for aid in sorted(tr.word_bytes):
        hsh.update(f"{aid}:{tr.word_bytes[aid]}:"
                   f"{tr.array_names.get(aid, '')};".encode())
    return hsh.hexdigest()


@dataclasses.dataclass(frozen=True)
class DeviceViews:
    """Fixed-shape, padded per-trace tensors for the batched timing
    backend (``repro_torch.core.sim.batched_cycle``).

    Shapes are padded so that traces of similar size share one compiled
    kernel: ``n_pad`` is the node count rounded up to a power of two and
    ``n_preds_max`` the padded predecessor fan-in.  Padding is inert by
    construction — pad nodes depend on themselves (``preds_pad[i] = i``)
    so they are never ready, never issue, and never retire; real nodes
    pad their missing predecessor slots with the sentinel index
    ``n_pad``, whose finish time is pinned to ``-1`` (always retired).

    ``perm`` lists every node grouped by resource class (array ids
    first, then ``FU_ORDER`` classes, then the pad tail), each group
    sorted by the list-scheduling priority ``(-height, node)`` — i.e.
    exactly the order the reference loops pop their per-class heaps.
    ``class_bounds[c]`` is the half-open ``perm`` range of class ``c``.
    """

    n_real: int
    n_pad: int
    n_preds_max: int
    n_arrays: int
    a_pad: int                 # array-axis bucket (>= max(n_arrays, 1))
    preds_pad: np.ndarray      # [n_pad, n_preds_max] int32 (pad = n_pad)
    lat: np.ndarray            # [n_pad] int32 FU/store latency per node
    is_load: np.ndarray        # [n_pad] bool
    word_idx: np.ndarray       # [n_pad] int32 (0 for compute/pad nodes)
    perm: np.ndarray           # [n_pad] int32 class-grouped priority order
    gid_perm: np.ndarray       # [n_pad] int32 class id per perm slot:
                               #   array id, a_pad + FU index, a_pad + 7 pads
    seg_start: np.ndarray      # [a_pad + 8] int32 segment starts (+ total)
    class_bounds: tuple        # ((lo, hi), ...) per real class id

    @property
    def signature(self) -> tuple:
        """Static shape key (padded dimensions only): the class segment
        layout travels as data (``gid_perm``/``seg_start``)."""
        return (self.n_pad, self.n_preds_max, self.a_pad)


def _build_device_views(pt: "PreparedTrace") -> DeviceViews:
    n = pt.trace.n_nodes
    n_pad = _next_pow2(max(n, 16))
    n_classes = pt.n_arrays + len(FU_ORDER)
    a_pad = _next_pow2(max(pt.n_arrays, 1))

    indeg = pt.indegree
    p_max = _next_pow2(max(int(indeg.max()) if n else 0, 1))
    preds_pad = np.full((n_pad, p_max), n_pad, np.int32)
    if n:
        ptr = pt.trace.pred_ptr
        idx = pt.trace.pred_idx
        lens = (ptr[1:] - ptr[:-1]).astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        cols = np.arange(idx.shape[0], dtype=np.int64) - np.repeat(
            ptr[:-1], lens)
        preds_pad[rows, cols] = idx.astype(np.int32)
    # pad nodes gate on themselves: never ready, never issued
    pad_ids = np.arange(n, n_pad, dtype=np.int32)
    preds_pad[n:] = pad_ids[:, None]

    # class-grouped, priority-sorted permutation.  np.lexsort is stable
    # and sorts by the LAST key first: (class, -height, node).
    klass = np.concatenate([pt.klass_np.astype(np.int64),
                            np.full(n_pad - n, n_classes, np.int64)])
    height = np.concatenate([pt.height.astype(np.int64),
                             np.zeros(n_pad - n, np.int64)])
    node = np.arange(n_pad, dtype=np.int64)
    perm = np.lexsort((node, -height, klass)).astype(np.int32)

    counts = np.bincount(klass[perm], minlength=n_classes + 1)
    ends = np.cumsum(counts)
    bounds = tuple((int(ends[c] - counts[c]), int(ends[c]))
                   for c in range(n_classes))

    # a_pad-relative class ids per perm slot + segment starts, as device
    # data: arrays [0, n_arrays), empty pad arrays [n_arrays, a_pad), FU
    # classes [a_pad, a_pad + 7), trace pads a_pad + 7
    gid_perm = np.full(n_pad, a_pad + len(FU_ORDER), np.int32)
    seg_start = np.zeros(a_pad + len(FU_ORDER) + 1, np.int32)
    pos = 0
    for g in range(a_pad + len(FU_ORDER)):
        c = g if g < pt.n_arrays else (
            pt.n_arrays + (g - a_pad) if g >= a_pad else -1)
        if 0 <= c < n_classes:
            lo, hi = bounds[c]
            gid_perm[lo:hi] = g
            seg_start[g] = lo
            pos = hi
        else:
            seg_start[g] = pos          # empty pad-array segment
    seg_start[-1] = pos

    lat = np.zeros(n_pad, np.int32)
    lat[:n] = pt.latency_np
    is_load = np.zeros(n_pad, bool)
    is_load[:n] = pt.is_load_np.astype(bool)
    word_idx = np.zeros(n_pad, np.int32)
    if n:
        wi = pt.word_index_np
        if wi.size and int(wi.max()) >= 2**31:
            raise ValueError("word indices exceed int32: the batched "
                             "backend does not support this trace")
        word_idx[:n] = np.maximum(wi, 0).astype(np.int32)

    return DeviceViews(
        n_real=n, n_pad=n_pad, n_preds_max=p_max, n_arrays=pt.n_arrays,
        a_pad=a_pad, preds_pad=preds_pad, lat=lat, is_load=is_load,
        word_idx=word_idx, perm=perm, gid_perm=gid_perm,
        seg_start=seg_start, class_bounds=bounds)


@dataclasses.dataclass
class PreparedTrace:
    """One-time trace analysis shared by every design-point evaluation.

    See the module docstring for the full contract.  Treat instances as
    immutable: the scheduler and sweep layers read but never mutate them.
    """
    trace: T.Trace
    fingerprint: str
    # graph structure (numpy)
    succ_ptr: np.ndarray
    succ_idx: np.ndarray
    indegree: np.ndarray
    height: np.ndarray
    depth: np.ndarray
    # per-array geometry / stats
    array_depths: dict[int, int]
    loads_per_array: dict[int, int]
    stores_per_array: dict[int, int]
    locality: float
    n_arrays: int
    # contiguous numpy per-node arrays
    is_load_np: np.ndarray     # [N] uint8
    latency_np: np.ndarray     # [N] int64
    word_index_np: np.ndarray  # [N] int64
    klass_np: np.ndarray       # [N] int64
    _device: "DeviceViews | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def name(self) -> str:
        return self.trace.name

    @property
    def n_nodes(self) -> int:
        return self.trace.n_nodes

    def device_views(self) -> DeviceViews:
        """Build (once) the padded fixed-shape tensors of the batched
        timing backend — see :class:`DeviceViews`."""
        if self._device is None:
            self._device = _build_device_views(self)
        return self._device


def _array_depths(tr: T.Trace, word_idx: np.ndarray) -> dict[int, int]:
    """Power-of-two depth per array from the trace's max word index."""
    depths: dict[int, int] = {}
    mem = tr.mem_mask()
    for aid in tr.array_names:
        sel = mem & (tr.array_ids == aid)
        if not sel.any():
            depths[aid] = 16
            continue
        max_idx = int(word_idx[sel].max())
        depths[aid] = max(16, 1 << (max_idx + 1).bit_length())
    return depths


def _build(tr: T.Trace) -> PreparedTrace:
    n = tr.n_nodes
    succ_ptr, succ_idx = successor_csr(tr.pred_ptr, tr.pred_idx, n)
    lat_np = np.asarray([T.LATENCY[k] for k in range(len(T.LATENCY))],
                        np.int64)[tr.kinds]
    height = schedule_heights(tr.kinds, tr.pred_ptr, tr.pred_idx,
                              succ_ptr, succ_idx)
    depth = dependency_depths(tr.pred_ptr, tr.pred_idx, succ_ptr, succ_idx)
    indegree = (tr.pred_ptr[1:] - tr.pred_ptr[:-1]).astype(np.int64)

    # word index per node (-1 for compute ops), vectorized per array
    word_idx = np.full(n, -1, np.int64)
    mem = tr.mem_mask()
    for aid, wb in tr.word_bytes.items():
        sel = mem & (tr.array_ids == aid)
        word_idx[sel] = tr.addrs[sel] // wb

    loads = {aid: int(np.sum(mem & (tr.array_ids == aid)
                             & (tr.kinds == T.LOAD)))
             for aid in tr.array_names}
    stores = {aid: int(np.sum(mem & (tr.array_ids == aid)
                              & (tr.kinds == T.STORE)))
              for aid in tr.array_names}

    addrs_m, aids_m = tr.mem_addrs_and_arrays()
    locality = trace_locality(addrs_m, aids_m) if addrs_m.size else 0.0

    # resource class per node: array id for memory ops, else
    # n_arrays + FU_ORDER index (vectorized via a kind -> class table)
    n_arrays = (max(tr.array_names) + 1) if tr.array_names else 0
    fu_of_kind = np.zeros(len(T.LATENCY), np.int64)
    for kind, fu_name in T.FU_CLASS.items():
        fu_of_kind[kind] = n_arrays + FU_ORDER.index(fu_name)
    klass_np = np.where(mem, tr.array_ids.astype(np.int64),
                        fu_of_kind[tr.kinds])

    return PreparedTrace(
        trace=tr,
        fingerprint=trace_fingerprint(tr),
        succ_ptr=succ_ptr,
        succ_idx=succ_idx,
        indegree=indegree,
        height=height,
        depth=depth,
        array_depths=_array_depths(tr, word_idx),
        loads_per_array=loads,
        stores_per_array=stores,
        locality=float(locality),
        n_arrays=n_arrays,
        is_load_np=np.ascontiguousarray(tr.kinds == T.LOAD, np.uint8),
        latency_np=np.ascontiguousarray(lat_np),
        word_index_np=np.ascontiguousarray(word_idx, np.int64),
        klass_np=np.ascontiguousarray(klass_np),
    )


def prepare_trace(tr: "T.Trace | PreparedTrace") -> PreparedTrace:
    """Return the (memoized) :class:`PreparedTrace` for ``tr``.

    Passing an already-prepared trace is a no-op, so every API in the
    sim/dse stack accepts ``Trace | PreparedTrace`` interchangeably.
    """
    if isinstance(tr, PreparedTrace):
        return tr
    cached = getattr(tr, _PREPARED_ATTR, None)
    if cached is None:
        cached = _build(tr)
        object.__setattr__(tr, _PREPARED_ATTR, cached)
    return cached
