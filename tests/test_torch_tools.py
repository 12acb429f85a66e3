"""The port's copies of the DSE tools in ``tools/`` against the JAX
package's tools, on the CPU.

* ``surrogate_report_torch.py`` writes the reference report's CSV byte
  for byte.
* ``check_legality_torch.py --device cpu`` (the plain lanes) gives the
  reference's ``--backends c`` rows at the same stride, every column but
  ``backend`` (the reference's ``py`` rows where its compiled C loop
  cannot be built: the two are pinned equal), and exits 1 on a log that
  lost one event.
* ``fit_surrogate_torch.py --dry-run`` reproduces the checked-in
  ``repro_torch/core/dse/_surrogate_coef.py`` exactly (the one slow test
  of this file, ~27 s; it never writes the file).
"""
import csv
import importlib.util
import pathlib

import pytest

from _torch_sched_util import one_thread  # noqa: F401  (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
# every 27th golden row: 15 rows over 13 benchmarks, ~12 s on the plain
# lanes on one thread with the reference's rows
STRIDE = 27


def _load(name: str):
    path = TOOLS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_surrogate_report_csv_equals_the_reference_s(tmp_path):
    ref, port = tmp_path / "ref.csv", tmp_path / "port.csv"
    _load("surrogate_report").main(["--csv", str(ref)])
    stats = _load("surrogate_report_torch").main(["--csv", str(port)])
    assert port.read_bytes() == ref.read_bytes()
    assert (stats["rows"], stats["calibrated_rows"]) == (390, 312)


def _rows(path: pathlib.Path) -> list:
    rows = list(csv.DictReader(path.open()))
    for r in rows:
        r.pop("backend")
    return rows


def test_legality_rows_equal_the_reference_s(tmp_path, capsys, one_thread):
    from repro.core.sim import _cycle_ext

    backend = "c" if _cycle_ext.load() is not None else "py"
    ref, port = tmp_path / "ref.csv", tmp_path / "port.csv"
    assert _load("check_legality").main(
        ["--backends", backend, "--stride", str(STRIDE),
         "--out", str(ref)]) == 0
    out = _load("check_legality_torch").main(
        ["--device", "cpu", "--stride", str(STRIDE), "--out", str(port)])
    assert out["rc"] == 0 and out["violations"] == 0
    want = _rows(ref)
    assert out["rows"] == len(want) == 15
    assert _rows(port) == want
    assert {r["backend"] for r in csv.DictReader(port.open())} == {"cpu"}
    assert "tight on" in capsys.readouterr().out


def test_legality_tool_exits_1_on_a_log_that_lost_an_event(tmp_path,
                                                          monkeypatch,
                                                          capsys,
                                                          one_thread):
    tool = _load("check_legality_torch")
    schedule = tool.schedule_batched

    def drop_one(*args, **kwargs):
        results, logs = schedule(*args, **kwargs)
        logs[0].cycle[5] = -1
        return results, logs

    monkeypatch.setattr(tool, "schedule_batched", drop_one)
    out = tool.main(["--device", "cpu", "--stride", "390",
                     "--out", str(tmp_path / "bad.csv")])
    assert (out["rows"], out["violations"], out["rc"]) == (1, 1, 1)
    assert "LEGALITY CHECK FAILED" in capsys.readouterr().err
    (row,) = csv.DictReader((tmp_path / "bad.csv").open())
    assert row["ok"] == "0" and "completeness" in row["violations"]


def test_fit_reproduces_the_checked_in_coefficients(capsys):
    from repro_torch.core.dse import _surrogate_coef as coef

    out = _load("fit_surrogate_torch").main(["--dry-run"])
    assert out["text"] == pathlib.Path(coef.__file__).read_text()
    fitted: dict = {}
    exec(compile(out["text"], "_surrogate_coef", "exec"), fitted)
    for name in ("BASE", "PORT", "INTF", "STALL", "FIT_STATS"):
        assert fitted[name] == getattr(coef, name), name
    assert out["stats"] == coef.FIT_STATS
    assert "ALL medrel=" in capsys.readouterr().out


@pytest.mark.parametrize("rel", [
    "examples/quickstart_torch.py", "examples/dse_machsuite_torch.py",
    "examples/serve_lm_torch.py", "examples/train_lm_torch.py"])
def test_scripts_are_lint_clean(rel):
    """The repo's accelerator lint finds nothing in the port's examples.
    Its tree scan (``tests/test_lint.py``) walks ``tools/``, the port's
    tools included, but not ``examples/``."""
    findings = _load("lint_repro").lint_file(ROOT / rel, ROOT)
    assert not findings, [str(f) for f in findings]
