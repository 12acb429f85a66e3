"""The port stands alone: no module of ``repro_torch``, nor
``chip_smoke.py``, ``kernel_ab.py`` or ``phase_ab.py``, imports JAX or anything of the JAX package ``repro``,
and no kernel path falls back to a plain version through a ``try``.
"""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
AB = ROOT / "kernel_ab.py"
PHASE_AB = ROOT / "phase_ab.py"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE, AB, PHASE_AB]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name, line in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)}:{line} imports {name}"


def test_importing_the_port_loads_no_jax():
    """Import every module of the port, and chip_smoke.py, in a fresh
    interpreter: neither ``jax`` nor any ``repro.*`` module may load."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(SMOKE)!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "repro")
                     or m.startswith(("jax.", "jaxlib.", "repro.")))
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20     # every module was walked


@pytest.mark.parametrize("sub", ["kernels", "memory", "models", "launch",
                                 "core", "runtime", "dtensor_ops.py"])
def test_no_try_on_the_kernel_path(sub):
    """A failed build or launch raises; nothing catches it and runs the
    plain version instead."""
    paths = [PORT / sub] if sub.endswith(".py") else \
        sorted((PORT / sub).rglob("*.py"))
    for path in paths:
        tree = ast.parse(path.read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{path.relative_to(ROOT)} has try at {tries}"


def test_the_timing_backend_modules_are_scanned():
    """The batched timing backend's modules are among the files the
    import scan reads and the ``try`` scan walks."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for name in ("core/sim/batched_cycle.py", "core/sim/prepared.py",
                 "core/sim/arbiter.py", "core/sim/trace.py",
                 "core/bench/__init__.py", "core/bench/aes.py",
                 "core/dse/sweep.py", "core/dse/pareto.py",
                 "core/dse/runner.py", "core/dse/ratio.py",
                 "core/dse/surrogate.py", "core/dse/_surrogate_coef.py",
                 "core/locality.py", "kernels/cycle_lanes.py"):
        assert name in files, name


def test_the_mesh_modules_are_scanned():
    """The mesh-bound group's modules are among the files the import
    scan reads and the ``try`` scan walks."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for name in ("launch/mesh.py", "launch/sharding.py", "launch/specs.py",
                 "launch/roofline.py", "launch/dryrun.py",
                 "runtime/pipeline.py", "runtime/compressed_sync.py",
                 "dtensor_ops.py"):
        assert name in files, name
