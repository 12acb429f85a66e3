"""Sweep runner: cached DSE point evaluation on the card (the port of
the JAX package's ``core/dse/runner.py``).

The paper's Fig-4/5 loop evaluates one trace under O(64) accelerator
compositions.  This module is the entry point for that loop:

* **Shared analysis** — the trace is prepared once
  (:class:`repro_torch.core.sim.prepared.PreparedTrace`).
* **Batched evaluation** — every uncached point is scheduled by the
  batched timing backend, one ``cycle_lanes`` launch per
  ``batched_cycle.BATCH_LANES`` points (one CTA a point on the card),
  and costed on the host
  (:func:`repro_torch.core.dse.sweep.evaluate_points`).
* **Incremental re-sweeps** — an on-disk result cache keyed by
  ``(trace fingerprint, design, unroll, mem_latency, cache version)``
  makes re-runs and ``--full`` extensions of a previous sweep pay only
  for the new points.  A ``manifest.json`` alongside the cache maps
  benchmark identities to trace fingerprints so a *fully* cached sweep
  (:func:`run_sweep_bench`) skips trace generation and preparation
  entirely.  Entries and keys are those of the JAX package's runner, so
  the two runners share a cache directory; the manifest's benchmark
  identities hash each package's own module source, so each package
  records its own.
* **Surrogate pruning** — ``prune="surrogate"`` ranks the full grid on
  the host with the analytic cycle predictor
  (:mod:`repro_torch.core.dse.surrogate`), serves the predicted Pareto
  band's cached points and schedules its misses under the reference's
  front cap (:func:`repro_torch.core.dse.sweep.evaluate_points` with
  ``front_cap=True``): a miss that provably cannot reach the time/area
  front, being slower than a strictly cheaper miss, is dropped, neither
  returned nor cached.  The returned points are the reference's, point
  for point, for the same cache state; like the reference's they depend
  on that state
  (only the misses run under the cap), and they always hold the exact
  time/area front.
* **Audit** — ``check=True`` re-schedules the returned points with
  event logging (one ``schedule_batched`` call) and validates every log
  with :mod:`repro_torch.core.verify`.

The reference's process pool (``--jobs``, ``--chunk-timeout``,
``--chunk-retries``) and its CPU cycle-loop backends (``--backend``) are
not here: on the card one launch takes ``BATCH_LANES`` points.

Results are deterministic: the returned list is always ordered
``designs``-major / ``unrolls``-minor and each point is bitwise
identical whether it came from the card, the plain lanes on the CPU or
the cache.

CLI::

    python -m repro_torch.core.dse.runner --bench gemm_ncubed
    python -m repro_torch.core.dse.runner --bench md_knn --full \\
        --cache-dir .dse_cache --unrolls 1,2,4,8 --check
    python -m repro_torch.core.dse.runner --bench md_knn --full \\
        --prune surrogate --front-only
    python -m repro_torch.core.dse.runner --bench kmp --device cpu
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Iterable, Sequence

from repro_torch import tracing
from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                        DesignPoint, DSEPoint,
                                        evaluate_points,
                                        schedule_config_for)
from repro_torch.core.sim import batched_cycle
from repro_torch.core.sim import trace as T
from repro_torch.core.sim.prepared import PreparedTrace, prepare_trace
from repro_torch.device import resolve_device

__all__ = ["CACHE_VERSION", "SweepCache", "point_key", "run_sweep",
           "run_sweep_bench", "main"]

# The JAX package's cache version: its entries and this runner's are
# interchangeable.  v4: checksummed entry envelope ({"sha256", "point"})
# + DSEPoint res_* resilience fields.  Entries stay fault-agnostic:
# campaigns are attached after cache load, so the same entry serves
# faulted and fault-free sweeps.
CACHE_VERSION = 4

_ENV_CACHE_DIR = "REPRO_DSE_CACHE"


# ----------------------------------------------------------------------
# cache
# ----------------------------------------------------------------------
# An entry or manifest that is missing, not ASCII or not of the shape
# this runner (or the JAX package's) writes reads as a miss: the text is
# matched against the JSON grammar of that shape before it is parsed,
# so the parse cannot fail.  Entries: {"sha256": <64 hex>, "point": a
# flat object of strings, numbers and literals}; the manifest: a flat
# object of strings.
_STR = r'"(?:[^"\\\x00-\x1f]|\\(?:["\\/bfnrt]|u[0-9a-fA-F]{4}))*"'
_NUM = (r"(?:-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?"
        r"|NaN|-?Infinity)")
_VAL = rf"(?:{_STR}|{_NUM}|true|false|null)"


def _flat(value: str) -> str:
    pair = rf"{_STR}\s*:\s*{value}"
    return rf"\{{\s*(?:{pair}\s*(?:,\s*{pair}\s*)*)?\}}"


_ENTRY = re.compile(rf'\s*\{{\s*"sha256"\s*:\s*"[0-9a-f]{{64}}"\s*,\s*'
                    rf'"point"\s*:\s*{_flat(_VAL)}\s*\}}\s*')
_MANIFEST = re.compile(rf"\s*{_flat(_STR)}\s*")
_POINT_FIELDS = {f.name for f in dataclasses.fields(DSEPoint)}


def _read_json(path: Path, shape: "re.Pattern") -> "dict | None":
    """The JSON object in ``path``, or None when the file is missing or
    its text does not have ``shape``."""
    if not path.is_file():
        return None
    raw = path.read_bytes()
    if not raw.isascii() or shape.fullmatch(raw.decode("ascii")) is None:
        return None
    return json.loads(raw)


def point_key(fingerprint: str, dp: DesignPoint, unroll: int,
              mem_latency: int) -> str:
    """Stable cache key for one (trace, design, unroll, latency) point."""
    payload = json.dumps(
        {"v": CACHE_VERSION, "trace": fingerprint,
         "design": dataclasses.asdict(dp), "unroll": unroll,
         "mem_latency": mem_latency},
        sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


class SweepCache:
    """One-JSON-file-per-point result cache under ``root``.

    Writes are atomic (tmp file + fsync + rename) so interrupted sweeps
    never leave a torn entry behind, and every entry carries a sha256 of
    its payload: an entry corrupted *after* landing on disk (bit rot,
    partial copy, hand edits) fails the shape check or the checksum and
    reads as a miss instead of deserializing garbage.
    """

    def __init__(self, root: "str | Path") -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> Path:
        return self.root / f"{key[:2]}" / f"{key}.json"

    @staticmethod
    def _digest(point_dict: dict) -> str:
        payload = json.dumps(point_dict, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()

    def get(self, key: str) -> "DSEPoint | None":
        d = _read_json(self._path(key), _ENTRY)
        if (d is None or set(d["point"]) != _POINT_FIELDS
                or d["sha256"] != self._digest(d["point"])):
            self.misses += 1
            return None
        self.hits += 1
        return DSEPoint(**d["point"])

    def put(self, key: str, point: DSEPoint) -> None:
        d = dataclasses.asdict(point)
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(f".tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"sha256": self._digest(d), "point": d}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    # -- bench-identity -> trace-fingerprint manifest ------------------
    # Point keys need the trace *fingerprint*, which normally requires
    # generating + preparing the trace.  The manifest remembers the
    # mapping from a generation-free bench identity
    # (repro_torch.core.bench.trace_cache_key) to the fingerprint, so a
    # sweep whose points are all cached never touches the trace at all.
    def _manifest_path(self) -> Path:
        return self.root / "manifest.json"

    def _manifest_read(self) -> dict:
        d = _read_json(self._manifest_path(), _MANIFEST)
        return {} if d is None else d

    def manifest_get(self, bench_key: str) -> "str | None":
        return self._manifest_read().get(bench_key)

    def manifest_put(self, bench_key: str, fingerprint: str) -> None:
        d = self._manifest_read()
        if d.get(bench_key) == fingerprint:
            return
        d[bench_key] = fingerprint
        p = self._manifest_path()
        tmp = p.with_suffix(f".tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(d, f, indent=0, sort_keys=True)
        os.replace(tmp, p)


def _resolve_cache(cache_dir: "str | Path | None") -> "SweepCache | None":
    if cache_dir is None:
        cache_dir = os.environ.get(_ENV_CACHE_DIR) or None
    return SweepCache(cache_dir) if cache_dir else None


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------
def _attach_faults(points: list, designs: Sequence[DesignPoint], faults,
                   device) -> list:
    """Fill ``res_*`` fields from per-design fault campaigns.

    ``faults`` is a :class:`repro_torch.core.fault.FaultConfig`, an int
    (fault-population size with default config), or None (no-op).
    Campaigns run at the canonical 256x32b geometry on ``device`` and
    are memoised per design, so this costs one campaign per distinct
    design label per process regardless of benches/unrolls.
    """
    if faults is None:
        return points
    from repro_torch.core.fault import FaultConfig, attach_resilience

    if isinstance(faults, int):
        faults = FaultConfig(n_faults=faults)
    return attach_resilience(points, designs, cfg=faults, device=device)


def _vlog(verbose: bool, msg: str) -> None:
    if verbose:
        print(f"[sweep] {msg}", file=sys.stderr, flush=True)


def _legality_pass(pt: PreparedTrace, designs: Sequence[DesignPoint],
                   mem_latency: int, points: "Sequence[DSEPoint]",
                   verbose: bool, device) -> None:
    """Independently re-check every sweep point's schedule legality.

    Each point's config is rebuilt from its design label; the points are
    re-scheduled with issue-event logging (one ``schedule_batched``
    call), and each lane is validated by ``repro_torch.core.verify``.
    The sweep's own cycle count is cross-checked against the audited
    run, so a stale/corrupt cache entry also fails here.  Raises
    ``LegalityError`` on the first violating point.
    """
    from repro_torch.core.verify import Violation, verify_result

    by_label = {dp.label: dp for dp in designs}
    t0 = time.perf_counter()
    cfgs = [schedule_config_for(pt, by_label[p.design], p.unroll,
                                mem_latency) for p in points]
    results, logs = batched_cycle.schedule_batched(pt, cfgs, device=device,
                                                   collect_events=True)
    for p, cfg, res, ev in zip(points, cfgs, results, logs):
        rep = verify_result(pt, cfg, res, ev, backend=str(device))
        if res.cycles != p.cycles:
            rep.violations.append(Violation(
                "counter",
                f"sweep point {p.design}@u{p.unroll} reports "
                f"{p.cycles} cycles but the audited re-run took "
                f"{res.cycles}"))
        rep.raise_if_failed()
    _vlog(verbose,
          f"{pt.trace.name}: legality-checked {len(points)} points in "
          f"{time.perf_counter() - t0:.3f}s (0 violations)")


def _evaluate(pt: PreparedTrace, grid: "list[tuple[DesignPoint, int]]",
              mem_latency: int, cache: "SweepCache | None", verbose: bool,
              dev, front_cap: bool = False
              ) -> "list[DSEPoint | None]":
    """The points of ``grid``, in its order: cache hits as they are, the
    misses scheduled by :func:`evaluate_points` and stored.  With
    ``front_cap`` the misses run under the front cap, and a capped miss
    is ``None``, neither returned nor cached."""
    keys = [point_key(pt.fingerprint, dp, u, mem_latency) if cache else None
            for dp, u in grid]
    results: "list[DSEPoint | None]" = [cache.get(k) if cache else None
                                        for k in keys]
    todo = [i for i, p in enumerate(results) if p is None]
    _vlog(verbose, f"{pt.trace.name}: {len(grid) - len(todo)}/{len(grid)} "
                   f"points cached, {len(todo)} to evaluate on {dev}")

    if todo:
        t0 = time.perf_counter()
        fresh = evaluate_points(pt, [grid[i] for i in todo], mem_latency,
                                front_cap=front_cap, device=dev)
        for i, p in zip(todo, fresh):
            results[i] = p
            if cache and p is not None:
                cache.put(keys[i], p)
        capped = sum(p is None for p in fresh)
        _vlog(verbose,
              f"{pt.trace.name}: simulated {len(todo) - capped} points "
              f"({capped} front-capped, {len(grid) - len(todo)} cache hits) "
              f"in {-(-len(todo) // batched_cycle.BATCH_LANES)} launches, "
              f"{time.perf_counter() - t0:.3f}s")
    return results


def _run_pruned(pt: PreparedTrace, designs: Sequence[DesignPoint],
                unrolls: "tuple[int, ...]", mem_latency: int,
                cache: "SweepCache | None", margin: "float | None",
                verbose: bool, dev) -> list[DSEPoint]:
    """Surrogate-pruned sweep: rank the grid on the host, keep the
    predicted Pareto band and evaluate it as :func:`_evaluate` does,
    its misses under the front cap (in ascending-area order).

    Returns the retained points (a designs-major subsequence of the
    grid), as the reference's ``runner.py:337-397`` does: the hits, and
    the misses the cap did not drop.  The result holds every member of
    the exact Pareto front: the band keeps the near-front candidates
    (``margin`` is the slack on predicted time) and the cap drops only
    points proven off the front against exact cheaper results."""
    from repro_torch.core.dse.surrogate import (DEFAULT_MARGIN,
                                                grid_predictions,
                                                select_band)

    if margin is None:
        margin = DEFAULT_MARGIN
    t0 = time.perf_counter()
    with tracing.span("dse.rank"):
        preds = grid_predictions(pt, designs, unrolls)
        keep = select_band(preds, margin)
    _vlog(verbose,
          f"{pt.trace.name}: surrogate ranked {len(preds)} points in "
          f"{time.perf_counter() - t0:.3f}s; band kept {sum(keep)} "
          f"(margin {margin:g})")
    band = [(p.design, p.unroll) for p, k in zip(preds, keep) if k]
    return [p for p in _evaluate(pt, band, mem_latency, cache, verbose, dev,
                                 front_cap=True)
            if p is not None]


def _prune_falls_back(pt: PreparedTrace, mem_latency: int,
                      verbose: bool) -> bool:
    """True where the surrogate is not calibrated, so a pruned sweep runs
    the exhaustive grid instead (saying why on stderr)."""
    from repro_torch.core.dse.surrogate import (CALIBRATED_BENCHES,
                                                CALIBRATED_MEM_LATENCY)

    if mem_latency != CALIBRATED_MEM_LATENCY:
        _vlog(verbose,
              f"{pt.trace.name}: surrogate calibrated at mem_latency="
              f"{CALIBRATED_MEM_LATENCY}, got {mem_latency}: "
              "running exhaustive")
        return True
    if pt.trace.name not in CALIBRATED_BENCHES:
        # uncalibrated trace family (the serving benches): exactness
        # over speed — run the full grid
        _vlog(verbose,
              f"{pt.trace.name}: trace family not in the surrogate "
              "calibration set: running exhaustive")
        return True
    return False


def run_sweep(
    tr: "T.Trace | PreparedTrace",
    designs: Sequence[DesignPoint] = DEFAULT_DESIGNS,
    unrolls: Iterable[int] = DEFAULT_UNROLLS,
    *,
    mem_latency: int = 2,
    cache_dir: "str | Path | None" = None,
    cache: "SweepCache | None" = None,
    prune: "str | None" = None,
    margin: "float | None" = None,
    faults=None,
    check: bool = False,
    verbose: bool = False,
    device=None,
) -> list[DSEPoint]:
    """Evaluate every ``(design, unroll)`` composition on one trace.

    Args:
      tr: trace (raw or prepared) to sweep.
      designs / unrolls: the composition grid; results are returned in
        ``designs``-major, ``unrolls``-minor order.
      mem_latency: load issue-to-data latency forwarded to the scheduler.
      cache_dir: directory for the on-disk result cache (defaults to the
        ``REPRO_DSE_CACHE`` env var; no caching when unset).
      cache: pre-constructed :class:`SweepCache` (overrides cache_dir).
      prune: ``"surrogate"`` ranks the grid with the analytic cycle
        predictor on the host and schedules only the predicted Pareto
        band (:func:`repro_torch.core.dse.surrogate.select_band`), its
        cache misses under the front cap.  Returns a designs-major
        *subsequence* of the band whose time/area Pareto front is the
        exhaustive one, the reference's points for the same cache
        state; each point is bitwise identical to the exhaustive sweep's
        (and shares its cache entries).  The surrogate is calibrated at
        ``mem_latency == 2`` on the MachSuite trace families
        (``surrogate.CALIBRATED_BENCHES``); other latencies and the
        serving benches run the exhaustive grid.
      margin: safety slack on predicted time for the surrogate band
        (default :data:`repro_torch.core.dse.surrogate.DEFAULT_MARGIN`).
      faults: a :class:`repro_torch.core.fault.FaultConfig` (or fault
        count int) to run a seeded fault campaign per distinct design on
        ``device`` and fill each point's ``res_*`` fields.  Campaigns
        run at a canonical 256x32b geometry and are attached *after*
        cache load/store, so cache entries stay fault-agnostic.
      check: run the independent legality checker
        (``repro_torch.core.verify``) over every returned point after
        the sweep: the points are re-scheduled with issue-event logging,
        validated against rules compiled from their AMMSpecs and their
        static lower bounds, and held to the sweep's own cycle counts
        (catching stale cache entries too).  Raises
        ``repro_torch.core.verify.LegalityError`` on any violation.
      verbose: progress lines on stderr (cache hits, launch wall-clock,
        the surrogate's band or why it fell back).
      device: ``None`` runs the ``cycle_lanes`` kernel on the CUDA device
        (and raises without one); ``"cpu"`` runs its plain version.
    """
    if prune not in (None, "surrogate"):
        raise ValueError(f"prune must be None or 'surrogate', got {prune!r}")
    tracing.count("dse.sweeps")
    with tracing.span("dse.sweep"):
        dev = resolve_device(device)
        unrolls = tuple(unrolls)
        pt = prepare_trace(tr)
        if cache is None:
            cache = _resolve_cache(cache_dir)

        if prune == "surrogate" and not _prune_falls_back(pt, mem_latency,
                                                          verbose):
            results = _run_pruned(pt, designs, unrolls, mem_latency, cache,
                                  margin, verbose, dev)
        else:
            results = _evaluate(pt, [(dp, u) for dp in designs
                                     for u in unrolls],
                                mem_latency, cache, verbose, dev)
        if check:
            _legality_pass(pt, designs, mem_latency, results, verbose, dev)
        return _attach_faults(results, designs, faults, dev)


def run_sweep_bench(
    bench: str,
    designs: Sequence[DesignPoint] = DEFAULT_DESIGNS,
    unrolls: Iterable[int] = DEFAULT_UNROLLS,
    *,
    params=None,
    full: bool = False,
    mem_latency: int = 2,
    cache_dir: "str | Path | None" = None,
    cache: "SweepCache | None" = None,
    prune: "str | None" = None,
    margin: "float | None" = None,
    faults=None,
    check: bool = False,
    verbose: bool = False,
    stats: "dict | None" = None,
    device=None,
) -> list[DSEPoint]:
    """Sweep a registered benchmark by name, with a cold fast path.

    When every grid point is already cached, the sweep never generates
    or prepares the trace: the cache's ``manifest.json`` maps the
    benchmark identity (:func:`repro_torch.core.bench.trace_cache_key` —
    pure in the generator source + params) to the trace fingerprint, and
    the points are served straight from disk in designs-major order.
    Any miss falls through to :func:`run_sweep` on the real trace, which
    then records the manifest entry for next time.

    The fast path always returns the *full* grid — with every point
    cached, pruning would save nothing.  Otherwise ``prune`` and
    ``margin`` are :func:`run_sweep`'s.  ``stats`` (optional dict) gets
    ``fast_path`` (bool) and, when the trace was prepared, ``prepared``
    (the :class:`PreparedTrace`).
    ``device`` is :func:`run_sweep`'s: the CUDA device unless ``"cpu"``
    is asked for, also on the fast path.
    """
    import repro_torch.core.bench as bench_mod

    dev = resolve_device(device)
    if cache is None:
        cache = _resolve_cache(cache_dir)
    unrolls = tuple(unrolls)
    bkey = bench_mod.trace_cache_key(bench, params, full=full)

    # a legality audit re-runs every schedule against the real trace,
    # so the trace-free fully-cached fast path cannot serve it
    if cache is not None and not check:
        fp = cache.manifest_get(bkey)
        if fp is not None:
            hits: "list[DSEPoint] | None" = []
            for dp in designs:
                for u in unrolls:
                    hit = cache.get(point_key(fp, dp, u, mem_latency))
                    if hit is None:
                        hits = None
                        break
                    hits.append(hit)
                if hits is None:
                    break
            if hits is not None:
                _vlog(verbose, f"{bench}: fully cached ({len(hits)} "
                               "points), trace generation skipped")
                if stats is not None:
                    stats["fast_path"] = True
                return _attach_faults(hits, designs, faults, dev)

    tr = bench_mod.get_trace(bench, params, full=full)
    pt = prepare_trace(tr)
    if stats is not None:
        stats["fast_path"] = False
        stats["prepared"] = pt
    res = run_sweep(pt, designs, unrolls, mem_latency=mem_latency,
                    cache=cache, prune=prune, margin=margin, faults=faults,
                    check=check, verbose=verbose, device=dev)
    if cache is not None:
        cache.manifest_put(bkey, pt.fingerprint)
    return res


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------
def _parse_unrolls(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split(",") if x)


def main(argv: "Sequence[str] | None" = None) -> None:
    import argparse

    from repro_torch.core.bench import BENCHMARKS
    from repro_torch.core.dse.pareto import (design_space_expansion,
                                             pareto_front)

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.dse.runner",
        description="Cached DSE sweep over one MachSuite trace, scheduled "
                    "on the card.")
    ap.add_argument("--bench", required=True, choices=sorted(BENCHMARKS),
                    help="benchmark trace to sweep")
    ap.add_argument("--full", action="store_true",
                    help="full-size trace instead of TINY")
    ap.add_argument("--unrolls", type=_parse_unrolls,
                    default=DEFAULT_UNROLLS, metavar="1,2,4,8",
                    help="comma-separated unroll factors")
    ap.add_argument("--mem-latency", type=int, default=2)
    ap.add_argument("--cache-dir", default=None,
                    help=f"on-disk result cache (or ${_ENV_CACHE_DIR})")
    ap.add_argument("--prune", choices=("surrogate",), default=None,
                    help="surrogate-pruned sweep: schedule only the "
                         "predicted Pareto band (subset output; exact "
                         "time/area front preserved)")
    ap.add_argument("--margin", type=float, default=None,
                    help="surrogate band safety margin on predicted time "
                         "(default: surrogate.DEFAULT_MARGIN)")
    ap.add_argument("--faults", type=int, default=0, metavar="N",
                    help="inject an N-fault seeded campaign per design "
                         "and emit the res_* resilience columns (0 = off)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="campaign RNG seed (with --faults)")
    ap.add_argument("--fault-cycles", type=int, default=128,
                    help="campaign trace length in cycles (with --faults)")
    ap.add_argument("--check", action="store_true",
                    help="audit every emitted point with the independent "
                         "legality checker (repro_torch.core.verify): "
                         "event-log invariants + static hazard lower "
                         "bounds; exits nonzero on any violation")
    ap.add_argument("--front-only", action="store_true",
                    help="emit only Pareto-front rows (grid order kept); "
                         "pruned and exhaustive sweeps agree on this "
                         "output, so it diffs clean")
    ap.add_argument("--verbose", action="store_true",
                    help="progress lines on stderr")
    ap.add_argument("--device", default=None,
                    help="torch device of the schedules and campaigns "
                         "(default: the CUDA device; cpu runs the plain "
                         "lanes)")
    args = ap.parse_args(argv)

    cache = _resolve_cache(args.cache_dir)
    faults = None
    if args.faults > 0:
        from repro_torch.core.fault import FaultConfig

        faults = FaultConfig(n_faults=args.faults, seed=args.fault_seed,
                             n_cycles=args.fault_cycles)
    dev = resolve_device(args.device)
    stats: dict = {}
    t0 = time.perf_counter()
    pts = run_sweep_bench(args.bench, DEFAULT_DESIGNS, args.unrolls,
                          full=args.full, mem_latency=args.mem_latency,
                          cache=cache, prune=args.prune, margin=args.margin,
                          faults=faults, check=args.check,
                          verbose=args.verbose, stats=stats, device=dev)
    t_sweep = time.perf_counter() - t0

    emit = pts
    if args.front_only:
        on_front = {(p.design, p.unroll) for p in pareto_front(pts)}
        emit = [p for p in pts if (p.design, p.unroll) in on_front]

    # header and rows both derive from DSEPoint.row()
    cols = [f.name for f in dataclasses.fields(DSEPoint)]
    print(",".join(cols))
    for p in emit:
        row = p.row()
        print(",".join(f"{row[c]:.6g}" if isinstance(row[c], float)
                       else str(row[c]) for c in cols))

    banking = [p for p in pts if not p.is_amm]
    amm = [p for p in pts if p.is_amm]
    pt = stats.get("prepared")
    trace_info = (f"nodes={pt.n_nodes} locality={pt.locality:.3f}"
                  if pt is not None else "trace=cached-manifest")
    print(f"# {trace_info} points={len(pts)} "
          f"sweep={t_sweep*1e3:.1f}ms device={dev}"
          + (f" prune={args.prune}" if args.prune else ""))
    if banking and amm:
        print(f"# expansion={design_space_expansion(banking, amm):.2f} "
              f"pareto_banked={len(pareto_front(banking))} "
              f"pareto_amm={len(pareto_front(amm))}")
    if args.check:
        # run_sweep_bench raised LegalityError before reaching here if
        # any point violated a rule or a static bound
        print(f"# legality: {len(pts)} points audited "
              "(event-log invariants + static bounds), 0 violations")
    if cache:
        print(f"# cache: dir={cache.root} hits={cache.hits} "
              f"misses={cache.misses}")


if __name__ == "__main__":
    main()
