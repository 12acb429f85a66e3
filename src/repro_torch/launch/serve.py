"""Serve a model: prefill a batch of prompts, then decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --preset full --batch 8 --prompt-len 4096 --gen 16

Serves every family (``--mla-absorb`` decodes MLA in latent space).
Runs on the CUDA device unless ``--device cpu`` is given.  Prompts, and
the vlm's patch embeddings after them, come from
``np.random.default_rng(0)``, as in the JAX package's serve.py, so both
serve the same inputs; the weights are random, from seed 0.  As that
serve.py does, the hybrid and encdec families make no prefill: they
decode from an empty cache (the encdec against a zero cross cache),
starting from each prompt's first token.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch, tiny_variant
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.memory import plan_memory
from repro_torch.models import DTypePolicy, init_model, make_cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_NAMES))
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.preset == "tiny":
        arch = tiny_variant(arch)
    policy = DTypePolicy.standard()

    # the paper's planner: pick the memory layout for this serving shape
    plan = plan_memory(arch, SHAPES["decode_32k"])
    print("memory plan:")
    for s in plan.streams:
        print(f"  {s.stream:12s} L={s.locality:5.3f} "
              f"{'AMM' if s.use_amm else 'banked'} banks={s.n_banks}  "
              f"({s.note})")

    params = init_model(0, arch, policy, device)
    cache_len = args.prompt_len + args.gen
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, arch.vocab, (args.batch, args.prompt_len))
    ).to(device=device, dtype=torch.int32)
    batch = {"tokens": tokens}
    if arch.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (args.batch, arch.n_patches, arch.vit_dim))).to(
            device=device, dtype=torch.float32)

    if arch.family == "hybrid" or arch.is_encdec:
        cache = make_cache(arch, cache_len, args.batch, policy, device)
        if arch.is_encdec:
            print("enc-dec: decoding against zero cross-cache (driver demo)")
        last = tokens[:, :1]
    else:
        prefill_step = make_prefill_step(arch, policy, cache_len)
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, batch)
        _sync(device)
        print(f"prefill {args.batch}x{args.prompt_len}: "
              f"{time.perf_counter() - t0:.3f}s")
        last = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)

    decode = make_decode_step(arch, policy, mla_absorb=args.mla_absorb)
    outs = []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        last, logits, cache = decode(params, cache, last)
        outs.append(last)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.gen * args.batch
    print(f"decode: {toks} tokens in {dt:.3f}s -> {toks / dt:.1f} tok/s")
    gen = torch.cat(outs, dim=1).cpu().numpy()
    print("sample continuation ids:", gen[0, :16].tolist())
    return {"tok_per_s": toks / dt, "generated": gen}


if __name__ == "__main__":
    main()
