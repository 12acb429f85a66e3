"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration's file of sizes and the plain trace generator beside it,
its traffic mix, and the readers of its per-layer metrics.

Every piece is a file of its own, so a later change adds a cell, a
configuration, a traffic mix or a metric by adding files and entries:

* ``<config file>.json`` (named by the configuration's ``file``) holds
  the benchmark, its sizes and the grid's operating point; the module
  ``<config file>.py`` beside it generates the reference's trace;
* ``chipbench/workloads/<traffic>.json`` holds a traffic mix: the
  designs, unrolls and load latency of the grid, the pruning mode, and
  which Pareto fronts a sweep is reduced to;
* ``chipbench/metrics/<metric>.py`` reads one per-layer metric: a
  function ``read(reading)`` returning a number, or None where it finds
  nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file
    config_name: str
    generator: pathlib.Path   # its reference trace generator
    traffic: dict             # the traffic mix's file
    traffic_name: str
    end_to_end: tuple         # this cell's end-to-end metric entries
    per_layer: tuple          # (entry, reader module) for this cell


def load_reader(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "chipbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ValueError(f"{path} has no read(reading) function")
    return mod


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def find(workload: str, root: pathlib.Path) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read
    from ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    cfg_file = root / cfg_entry["file"]
    traffic_file = root / "chipbench" / "workloads" / f"{w['traffic']}.json"
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, workload))
    moved = {m["name"] for m in e2e}
    per_layer = tuple(
        (m, load_reader(root / "chipbench" / "metrics" / f"{m['name']}.py"))
        for m in bench["per_layer"]
        if _applies(m, workload) and m["moves"] in moved)
    return Cell(name=workload, chips=int(w["chips"]),
                config=json.loads(cfg_file.read_text()),
                config_name=w["config"],
                generator=cfg_file.with_suffix(".py"),
                traffic=json.loads(traffic_file.read_text()),
                traffic_name=w["traffic"], end_to_end=e2e,
                per_layer=per_layer)
