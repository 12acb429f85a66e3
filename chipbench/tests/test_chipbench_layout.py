"""The benchmark's layout: ``BENCHMARK.json`` keeps the contract's
shapes, every cell, configuration, traffic mix and per-layer metric is
found by name in a file of its own (a cell is added by adding files and
an entry, in a copy), and nothing under ``chipbench/`` imports JAX or
the JAX package, nor the reference anything of the program."""
import ast
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from chipbench import catalog, cell
from chipbench.tests._small import ROOT, SMALL, few

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert BENCH["command"] == ["python3", "chipbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("chipbench/") and c["reduced"] == []
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"sweep_s", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(name):
    c = catalog.find(name, ROOT)
    assert c.generator.is_file()
    assert c.config["name"] == c.config_name
    assert {"designs", "unrolls", "mem_latency", "prune", "margin",
            "fronts"} <= set(c.traffic)
    assert {m["name"] for m in c.end_to_end} == {"sweep_s", "setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_readers_read_nothing_from_an_empty_trace(name):
    reader = catalog.load_reader(ROOT / "chipbench" / "metrics"
                                 / f"{name}.py")
    empty = cell.Reading(workload="x", traffic={"prune": None}, sweeps=1,
                         window_s=1.0, points=[{"cycles": 10}], lanes=80,
                         n_nodes=100, n_edges=100, device={}, rank_s=None)
    assert reader.read(empty) is None


def test_readers_on_a_trace_summary():
    ops = {"void cycle_lanes_kernel<false, false>(Params)": (1.5, 3),
           "Memcpy HtoD (Pageable -> Device)": (0.1, 30)}
    r = cell.Reading(workload="x", traffic={"prune": "surrogate"},
                     sweeps=3, window_s=2.0,
                     points=[{"cycles": 1000}, {"cycles": 5000}], lanes=20,
                     n_nodes=1000, n_edges=2000,
                     device={"ops": ops, "busy_s": 1.6,
                             "trace_window_s": 2.0}, rank_s=0.02)
    got = {m["name"]: catalog.load_reader(
        ROOT / "chipbench" / "metrics" / f"{m['name']}.py").read(r)
        for m in BENCH["per_layer"]}
    assert got["host.ms_per_sweep"] == pytest.approx(500 / 3)
    assert got["cycle_lanes.ns_per_cycle"] == pytest.approx(1e5)
    assert got["device.idle"] == pytest.approx(20.0)
    assert got["surrogate.rank_ms"] == pytest.approx(20.0)
    assert got["surrogate.lanes"] == 20
    need = (1000 * 11 + 2000 * 4 + 20 * 48) * 3
    assert got["cycle_lanes_roofline"] == pytest.approx(
        100 * need / 3.35e12 / 1.5)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


SOURCES = sorted((ROOT / "chipbench").rglob("*.py"))
REFERENCE = sorted((ROOT / "chipbench" / "reference").glob("*.py")) \
    + sorted((ROOT / "chipbench" / "configs").glob("*.py")) \
    + [ROOT / "chipbench" / "judge.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_nor_the_jax_package(path):
    top = {name.split(".")[0] for name in _imports(path)}
    assert not top & {"jax", "jaxlib", "flax", "repro"}, path


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    top = {name.split(".")[0] for name in _imports(path)}
    assert top <= {"__future__", "numpy", "chipbench", "bisect",
                   "dataclasses", "heapq", "math", "os", "importlib",
                   "multiprocessing", "concurrent"}, path


def test_a_cell_is_added_by_files_and_an_entry(tmp_path):
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = few(json.loads(
        (ROOT / "chipbench" / "workloads" / "grid.json").read_text()))
    (tmp_path / "chipbench" / "workloads" / "few.json").write_text(
        json.dumps(traffic))
    (tmp_path / "chipbench" / "metrics" / "sweep.count.py").write_text(
        "def read(r):\n    return r.sweeps\n")
    bench["workloads"].append({"name": "md_knn.few",
                               "config": "machsuite-md_knn",
                               "traffic": "few", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "sweep.count", "unit": "sweeps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "runner", "moves": "sweep_s",
                               "workloads": ["md_knn.few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "chipbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}

    c = catalog.find("md_knn.few", tmp_path)
    assert [m["name"] for m, _ in c.per_layer][-1] == "sweep.count"
    out = cell.run(c, 3, 0.0, True, device=torch.device("cpu"),
                   process_start=time.time(), workers=0,
                   params=SMALL["machsuite-md_knn"])
    assert out["correct"] is True
    assert out["metrics"]["sweep.count"] == {"value": 1.0,
                                             "unit": "sweeps"}
    assert before == {p: p.read_bytes()
                      for p in (ROOT / "chipbench").rglob("*")
                      if p.is_file() and "__pycache__" not in p.parts}


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "md_knn.grid",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_cli_prints_no_result_without_a_cuda_device():
    done = _cli(ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA device" in done.stderr


def test_cli_prints_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    done = _cli(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
