"""Time the gather, SSD and timing-backend kernels of this checkout
against another checkout's, with one timer, in one run on the card.

    python3 kernel_ab.py OTHER      # OTHER: e.g. a git archive of the parent

runs OTHER, this checkout, this checkout, OTHER, each in a fresh process
whose ``repro_torch`` comes from that checkout's ``src`` (each builds its
own kernels under its own ``build/``).  Every run times
``amm_gather_u32`` and ``ssd_chunk`` at ``chip_smoke.py``'s shapes with
``chip_smoke.py``'s own ``time_ms`` (median of device time between CUDA
events, the card spun first) and ``device_profile`` (device time of one
call), and ``cycle_lanes`` on the full-size DSE matrix's lanes of
``SCHEDULE_BENCHES`` (one ``schedule_batched`` call of 80 lanes each,
its launch fenced by CUDA events as ``chip_smoke.py`` phase 8b fences
it; the median of three calls), all with this checkout's timers, so the
two sides share one timer.

Prints the card's name and power limit, one JSON line a run, and last
the medians by side.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
# the timing backend's launches: the two slowest under the first design
# and two whose lanes jump idle cycles
SCHEDULE_BENCHES = ("sort_merge", "stencil2d", "kmp", "md_knn")


def schedule_ms(bench: str, dev: torch.device, reps: int = 3) -> float:
    """Median device ms of the one ``cycle_lanes`` launch that schedules
    ``bench``'s full-size DSE matrix (80 lanes), over ``reps`` calls of
    ``schedule_batched``, each checked against
    ``tests/golden_schedule_full.json``."""
    import chip_smoke as smoke
    from repro_torch.core.bench import get_trace
    from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS,
                                            DEFAULT_UNROLLS,
                                            schedule_config_for)
    from repro_torch.core.sim import prepare_trace
    from repro_torch.core.sim.batched_cycle import schedule_batched
    from repro_torch.kernels import ops

    pt = prepare_trace(get_trace(bench, full=True))
    cfgs = [schedule_config_for(pt, dp, u) for dp in DEFAULT_DESIGNS
            for u in DEFAULT_UNROLLS]
    spans, wrapper = [], ops.cycle_lanes

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = wrapper(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    rows = [g for g in json.loads(smoke.GOLDEN_SCHEDULE_FULL.read_text())
            if g["bench"] == bench]
    ops.cycle_lanes = timed
    try:
        for _ in range(reps):
            results = schedule_batched(pt, cfgs, device=dev)
            if not all(smoke.schedule_row_matches(r, g)
                       for r, g in zip(results, rows)):
                raise RuntimeError(f"cycle_lanes on {bench} != the golden "
                                   "rows")
    finally:
        ops.cycle_lanes = wrapper
    torch.cuda.synchronize()
    if len(spans) != reps:
        raise RuntimeError(f"{len(spans)} cycle_lanes launches for {reps} "
                           "calls")
    return statistics.median(s.elapsed_time(e) for s, e in spans)


def worker(tree: pathlib.Path) -> dict:
    """Time one checkout's kernels; its ``src`` comes first on the path,
    this checkout's ``chip_smoke.py`` supplies the timer and shapes."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))
    import chip_smoke as smoke
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import pack_amm_banks, ssd_chunk
    from repro_torch.kernels.amm_gather import amm_gather_u32
    from repro_torch.memory.planner import embedding_stream
    from repro_torch.models import ssm_config
    pkg = pathlib.Path(repro_torch.__file__).resolve()
    if tree.resolve() not in pkg.parents:
        raise RuntimeError(f"repro_torch came from {pkg}, not {tree}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"tree": str(tree)}

    arch = get_arch(smoke.ARCH)
    table = torch.randn((arch.padded_vocab, arch.d_model), generator=gen,
                        device=dev, dtype=torch.bfloat16)
    idx = torch.from_numpy(embedding_stream(
        arch, n=smoke.GATHER_IDS)).to(dev, torch.int32)
    banks, parity = pack_amm_banks(table, smoke.GATHER_BANKS)
    want = table[idx.long()].view(torch.int16)

    def gather():
        return amm_gather_u32(banks, parity, idx)

    if not torch.equal(gather(), want):
        raise RuntimeError("amm_gather != table[idx]")
    res["gather_ms"] = smoke.time_ms(gather)
    prof, _ = smoke.device_profile(gather)
    res["gather_profiled_ms"] = sum(
        ms for k, ms in prof.items() if "amm_gather" in k)
    del table, banks, parity

    scfg = ssm_config(get_arch(smoke.SSM_ARCH))
    bt, h, q, p, n = (smoke.SERVE_BATCH, scfg.n_heads, scfg.chunk,
                      scfg.head_dim, scfg.d_state)
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((bt, h, q), generator=gen,
                                            device=dev)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    cum = torch.cumsum(dt * A[None, :, None], dim=-1)
    ins = (torch.randn((bt, h, q, p), generator=gen, device=dev), dt, cum,
           torch.randn((bt, q, n), generator=gen, device=dev),
           torch.randn((bt, q, n), generator=gen, device=dev),
           torch.randn((bt, h, p, n), generator=gen, device=dev))
    res["ssd_ms"] = smoke.time_ms(lambda: ssd_chunk(*ins))
    prof, _ = smoke.device_profile(lambda: ssd_chunk(*ins))
    res["ssd_profiled_ms"] = sum(ms for k, ms in prof.items() if "ssd_" in k)
    del ins
    torch.cuda.empty_cache()
    for bench in SCHEDULE_BENCHES:
        res[f"cycle_lanes_{bench}_ms"] = schedule_ms(bench, dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path,
                    help="the other checkout (its src/repro_torch is timed)")
    ap.add_argument("--worker", action="store_true",
                    help="time OTHER's kernels in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.other)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    runs = []
    for tree in (args.other, HERE, HERE, args.other):
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               str(tree), "--worker"]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        line = p.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    summary = {}
    for side, sel in (("other", (0, 3)), ("this", (1, 2))):
        for key in runs[sel[0]]:
            if key != "tree":
                summary[f"{side}_{key}"] = statistics.median(
                    runs[i][key] for i in sel)
    print(json.dumps({"card": card, "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
