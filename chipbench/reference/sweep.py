"""The reference sweep: every ``(design, unroll)`` point of a grid
scheduled by :mod:`chipbench.reference.schedule` and costed by
:mod:`chipbench.reference.model`, in worker processes.

A point's schedule costs 0.2-4 s of plain Python on a full-size
MachSuite trace, so :func:`sweep` spreads the grid over up to
``workers`` spawned processes (slowest kinds first).  Each worker
rebuilds the trace from the configuration's generator and the seed;
nothing is taken from the program under test.

``scan_cap`` < 1 scales every memory's deferral-scan cap down: the
control, a scheduler that skips fewer blocked candidates a cycle than
the paper's simulator does.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from chipbench.reference import model as M
from chipbench.reference import schedule as S

_WORKER: dict = {}          # the worker process's prepared trace


def load_generator(path: str):
    """The ``gen_trace(params, seed)`` module beside a configuration."""
    spec = importlib.util.spec_from_file_location(
        "chipbench_gen_" + os.path.basename(path).replace("-", "_")
        .replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_trace(gen_path: str, params: dict, seed: int):
    return load_generator(gen_path).gen_trace(params, seed)


def point(pp: S.Prepared, design: "tuple[str, int, int, int]",
          unroll: int, mem_latency: int, scan_cap: float = 1.0) -> dict:
    """One grid point: its schedule's counts and its costs."""
    kind, n_read, n_write, n_banks = design
    mems = S.lane_mems(pp, kind, n_read, n_write, n_banks)
    arbs = [M.arbitration(m, 2) for m in mems]
    if scan_cap != 1.0:
        arbs = [dataclasses.replace(a, max_failed=max(
            1, int(a.max_failed * scan_cap))) for a in arbs]
    res = S.schedule(pp, arbs, M.fu_budgets(unroll), mem_latency)
    costs = [M.mem_cost(m) for m in mems]
    res.update(M.point_cost(costs, unroll, res["cycles"], res["issued"],
                            [pp.loads[a] for a in pp.array_ids],
                            [pp.stores[a] for a in pp.array_ids]))
    res.update(design=M.label(*design), unroll=unroll)
    return res


def _init(gen_path: str, params: dict, seed: int) -> None:
    _WORKER["pp"] = S.prepare(make_trace(gen_path, params, seed))


def _task(args) -> dict:
    return point(_WORKER["pp"], *args)


def _weight(design) -> int:
    """Rough plain-Python cost of a design's lanes, for ordering."""
    kind, n_read, _, n_banks = design
    return (3 if kind in ("h_ntx_rd", "b_ntx_wr", "hb_ntx") else 1) \
        * n_read * n_banks


def sweep(gen_path: str, params: dict, seed: int, designs, unrolls,
          mem_latency: int, *, workers: int, scan_cap: float = 1.0
          ) -> "list[dict]":
    """Every grid point, designs-major and unrolls-minor.  ``workers``
    0 runs them in this process."""
    grid = [(tuple(d), u) for d in designs for u in unrolls]
    if workers <= 0:
        pp = S.prepare(make_trace(gen_path, params, seed))
        return [point(pp, d, u, mem_latency, scan_cap) for d, u in grid]
    order = sorted(range(len(grid)), key=lambda i: -_weight(grid[i][0]))
    out: "list[dict | None]" = [None] * len(grid)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                             initializer=_init,
                             initargs=(gen_path, params, seed)) as pool:
        futs = {i: pool.submit(_task, (grid[i][0], grid[i][1], mem_latency,
                                       scan_cap)) for i in order}
        for i, f in futs.items():
            out[i] = f.result()
    return out


def cpu_workers() -> int:
    """The host cores this process may use, at most 8."""
    return max(1, min(8, len(os.sched_getaffinity(0))))
