"""Run ``chip_smoke.py``'s serving and training phases (10, 11 and 12)
on this checkout and another, to compare their end-to-end times and
peak memory on one card in one run.

    python3 phase_ab.py OTHER      # OTHER: e.g. a git archive of the parent
    python3 phase_ab.py OTHER --phases 11,12 --rounds 2

runs OTHER, this checkout, this checkout, OTHER (``--rounds`` times),
each in a fresh process whose ``repro_torch`` comes from that
checkout's ``src`` (each builds its own kernels under its own
``build/``) and whose phases are this checkout's ``chip_smoke.py``
functions, so both sides run the same phases with the same timers and
checks.  Each run's whole output goes to ``build/phase_ab/run<i>.log``
beside this script; from it the script reads every prefill and decode
time the phases print (host clock, fenced), each training step's time
and peak memory, and each phase's seconds and peak device memory.

Prints the card's name and power limit, one JSON line a run, and last
the medians by side over all its runs.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "build" / "phase_ab"
_SERVE = re.compile(r"^(?:serve )?(\S+) .*?prefill ([\d.]+) ms.*?"
                    r"decode ([\d.]+) ms a")
_STEP = re.compile(r"^(.+?): step ([\d.]+) ms .*peak memory ([\d.]+) GB")
_PHASE = re.compile(r"^phase (\d+): ([\d.]+) s(?:, peak device memory "
                    r"([\d.]+) GB)?")


def numbers(log: str) -> dict:
    """The times and peaks the phases print, by name."""
    out = {}
    for line in log.splitlines():
        if m := _SERVE.match(line):
            out[f"{m[1]}_prefill_ms"] = float(m[2])
            out[f"{m[1]}_decode_ms"] = float(m[3])
        elif m := _STEP.match(line):
            what = m[1].replace(" ", "_")
            out[f"{what}_step_ms"] = float(m[2])
            out[f"{what}_peak_gb"] = float(m[3])
        elif m := _PHASE.match(line):
            out[f"phase{m[1]}_s"] = float(m[2])
            if m[3]:
                out[f"phase{m[1]}_peak_gb"] = float(m[3])
    return out


def worker(tree: pathlib.Path, run: int, phases: "list[int]") -> dict:
    """``phases`` of ``chip_smoke.py`` (of 10, 11, 12) on ``tree``'s
    ``repro_torch``."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))
    import chip_smoke as smoke
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.amm_gather import amm_gather_u32
    from repro_torch.kernels.banked_kv_decode import banked_kv_decode
    from repro_torch.kernels.cycle_lanes import cycle_lanes
    from repro_torch.kernels.ssd_scan import ssd_chunk_step
    pkg = pathlib.Path(repro_torch.__file__).resolve()
    if tree.resolve() not in pkg.parents:
        raise RuntimeError(f"repro_torch came from {pkg}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = {"amm_gather": amm_gather_u32,
               "banked_kv_decode": banked_kv_decode,
               "ssd_scan": ssd_chunk_step, "cycle_lanes": cycle_lanes}
    buf = io.StringIO()
    run_phase = {10: lambda: smoke.attention_serving(dev, kernels),
                 11: lambda: smoke.family_serving(dev, gen, kernels),
                 12: lambda: smoke.training(dev, kernels)}
    with contextlib.redirect_stdout(buf):
        for ph in phases:
            run_phase[ph]()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"run{run}.log").write_text(buf.getvalue())
    return {"tree": str(tree), **numbers(buf.getvalue())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path,
                    help="the other checkout (its src/repro_torch is run)")
    ap.add_argument("--phases", default="10,11,12",
                    help="the smoke's phases to run, of 10, 11, 12")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times to run OTHER, this, this, OTHER")
    ap.add_argument("--worker", type=int, default=None,
                    help="run OTHER's phases in this process, as run N")
    args = ap.parse_args(argv)
    phases = [int(p) for p in args.phases.split(",")]
    if not torch.cuda.is_available():
        print("phase_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.worker is not None:
        print(json.dumps(worker(args.other, args.worker, phases)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    runs = []
    order = (args.other, HERE, HERE, args.other) * args.rounds
    for i, tree in enumerate(order):
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               str(tree), "--worker", str(i), "--phases", args.phases]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout[-4000:] + p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        line = p.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    summary = {}
    for side, tree in (("other", args.other), ("this", HERE)):
        sel = [r for t, r in zip(order, runs) if t == tree]
        for key in sel[0]:
            if key != "tree" and all(key in r for r in sel):
                summary[f"{side}_{key}"] = statistics.median(
                    r[key] for r in sel)
    print(json.dumps({"card": card, "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
