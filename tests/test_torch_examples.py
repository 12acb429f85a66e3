"""The port's copies of ``examples/`` against the JAX package's examples,
on the CPU.

* ``quickstart_torch.py`` and ``dse_machsuite_torch.py kmp`` print, byte
  for byte, what ``quickstart.py`` and ``dse_machsuite.py kmp --jobs 1``
  print (both run in this process).
* The quickstart's RAM oracle reads the replay's int32 word bits as
  ``uint32``: words at or past 2**31 read OK, where an int32 comparison
  of the same words fails.
* ``serve_lm_torch.py`` and ``train_lm_torch.py`` hand the port's
  ``launch/serve.py`` and ``launch/train.py`` the reference examples'
  arguments, ``--device`` passed through, the training checkpoints in a
  directory of their own; the serving example runs once for real with
  its tiny defaults.
"""
import importlib.util
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

from _torch_sched_util import one_thread  # noqa: F401  (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str):
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_stdout(name: str, argv: list, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_prints_the_reference_s_stdout(capsys, monkeypatch,
                                                  one_thread):
    want = _reference_stdout("quickstart", [], capsys, monkeypatch)
    out = _load("quickstart_torch").main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert out["replay_ok"] and out["parity_agrees"]
    assert out["reads"].tolist() == [0, 1, 128, 255]
    assert out["writes"] == (111, 222) and out["parity_read"] == 222


def test_dse_machsuite_kmp_prints_the_reference_s_stdout(capsys,
                                                         monkeypatch,
                                                         one_thread,
                                                         tmp_path):
    monkeypatch.delenv("REPRO_DSE_CACHE", raising=False)
    want = _reference_stdout("dse_machsuite", ["kmp", "--jobs", "1"],
                             capsys, monkeypatch)
    # with no --cache-dir the runner's REPRO_DSE_CACHE is the cache, and
    # its counts are the ones reported
    monkeypatch.setenv("REPRO_DSE_CACHE", str(tmp_path))
    out = _load("dse_machsuite_torch").main(["kmp", "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert len(out["points"]) == 80
    assert (out["cache_hits"], out["cache_misses"]) == (0, 80)
    assert any(tmp_path.iterdir())


def test_dse_machsuite_takes_no_jobs():
    """The runner's process pool is not ported: ``--jobs`` is refused,
    not accepted and ignored."""
    with pytest.raises(SystemExit):
        _load("dse_machsuite_torch").main(["kmp", "--jobs", "2",
                                           "--device", "cpu"])


def test_quickstart_oracle_reads_words_past_2_31_as_uint32():
    from repro_torch.core import AMMSpec, make_amm
    from repro_torch.core.amm import replay as rp

    qs = _load("quickstart_torch")
    spec = AMMSpec("hb_ntx", n_read=4, n_write=2, depth=64)
    init = np.arange(64, dtype=np.uint32) + np.uint32(2**31)
    sim = make_amm(spec, init, device="cpu")
    ra, wa, wv, wm = rp.make_trace(spec, n_cycles=64, seed=3)
    _, res = sim.replay(sim.state, ra, wa, wv, wm)
    got = qs.as_u32(res.read_vals)
    assert (got >= 2**31).any()
    assert qs.replay_matches_ram(init, ra, wa, wv, wm, res.read_vals)

    # the same words held against the oracle as int32 read as mismatches
    oracle = init.copy()
    bits = res.read_vals.numpy()
    as_int32 = True
    for t in range(len(ra)):
        as_int32 &= bool((bits[t] == oracle[ra[t]]).all())
        oracle[wa[t][wm[t]]] = wv[t][wm[t]]
    assert not as_int32

    # and a read that is wrong in one bit is caught
    bad = res.read_vals.clone()
    bad[5, 1] ^= 1
    assert not qs.replay_matches_ram(init, ra, wa, wv, wm, bad)


def _captured(monkeypatch, module, run) -> list:
    seen = []
    monkeypatch.setattr(module, "main",
                        lambda argv=None: seen.append(list(argv)) or {})
    run()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("extra", [[], ["--arch", "mamba2-130m"]])
def test_serve_lm_passes_the_reference_s_arguments(monkeypatch, extra):
    import repro.launch.serve as ref_serve
    from repro_torch.launch import serve

    port = _load("serve_lm_torch")
    for device in ([], ["--device", "cpu"]):
        argv = extra + device
        monkeypatch.setattr(sys, "argv", ["serve_lm.py", *argv])
        want = _captured(monkeypatch, ref_serve, lambda: runpy.run_path(
            str(EXAMPLES / "serve_lm.py"), run_name="__main__"))
        got = _captured(monkeypatch, serve, lambda: port.main(argv))
        assert got == want
    assert want[want.index("--arch") + 1] == (extra[1] if extra
                                              else "qwen3-1.7b")


def test_train_lm_passes_the_reference_s_arguments(monkeypatch):
    import repro.launch.train as ref_train
    from repro_torch.launch import train

    port = _load("train_lm_torch")
    assert pathlib.Path(port.CKPT_DIR).name == "repro_torch_train_lm"
    for steps in ([], ["--steps", "160"]):
        monkeypatch.setattr(sys, "argv", ["train_lm.py", *steps])
        want = _captured(monkeypatch, ref_train, lambda: runpy.run_path(
            str(EXAMPLES / "train_lm.py"), run_name="__main__"))
        assert want[want.index("--ckpt-dir") + 1] == "/tmp/repro_train_lm"
        want[want.index("--ckpt-dir") + 1] = port.CKPT_DIR
        got = _captured(monkeypatch, train, lambda: port.main(steps))
        assert got == want
        got = _captured(monkeypatch, train,
                        lambda: port.main(steps + ["--device", "cpu"]))
        assert got == want + ["--device", "cpu"]


def test_serve_lm_runs_its_tiny_defaults_on_the_cpu(capsys):
    out = _load("serve_lm_torch").main(["--device", "cpu"])
    assert out["generated"].shape == (4, 32)
    assert np.isfinite(out["tok_per_s"]) and out["tok_per_s"] > 0
    assert "memory plan:" in capsys.readouterr().out


def test_examples_default_to_the_cuda_device(monkeypatch):
    """With no ``--device`` the port's examples ask for the CUDA device
    and raise without one; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("quickstart_torch", []),
                       ("dse_machsuite_torch", ["kmp"]),
                       ("serve_lm_torch", []), ("train_lm_torch", [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main(argv)
