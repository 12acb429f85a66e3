"""End-to-end training (example application + fault-tolerance
demonstration), as ``src/repro/launch/train.py``: the train step
(gradient accumulation + AdamW), periodic checkpoints, straggler
monitoring, optional int8 gradient compression with error feedback, and
crash-restart recovery (``--simulate-failure``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --preset tiny --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset m100 \\
      --steps 300

Runs on the CUDA device unless ``--device cpu`` is given.  The weights
are random, from seed 0; the batches come from ``SyntheticCorpus``, the
same as the reference's for the same flags.  Returns
{"first_loss", "final_loss", "steps"} and, for the caller's timing,
"step_ms": each step's host-clock ms up to its loss on the host (which
waits for the step's device work).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_arch, tiny_variant
from repro_torch.configs.base import ArchConfig, RuntimeConfig
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import DTypePolicy, count_params, init_model
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw
from repro_torch.runtime import HeartbeatMonitor, compressed_grad_tree

M100 = ArchConfig(
    name="m100", family="dense", n_layers=12, d_model=640, n_heads=10,
    n_kv_heads=5, d_ff=2560, vocab=16384, head_dim=64, qk_norm=True,
    act="silu", gated_mlp=True, tie_embeddings=True)


def build_arch(args) -> ArchConfig:
    if args.preset == "m100":
        return M100
    base = get_arch(args.arch)
    if args.preset == "tiny":
        return tiny_variant(base)
    return base


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_NAMES))
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "m100", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="crash (and auto-restart once) at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = build_arch(args)
    rt = RuntimeConfig(accum_steps=args.accum, remat="none")
    policy = DTypePolicy.standard()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps)

    params = init_model(0, arch, policy, device)
    opt_state = adamw.init(params, policy)
    print(f"arch={arch.name} params={count_params(params)/1e6:.1f}M "
          f"batch={args.batch}x{args.seq} device={device}")

    corpus = SyntheticCorpus(DataConfig(
        vocab=arch.vocab, seq_len=args.seq, global_batch=args.batch))
    loader = PrefetchLoader(corpus)

    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2, async_save=True)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = ckpt.latest_step()
        print(f"resumed from step {start}")

    if args.compress_grads:
        # grads quantized to int8 with error feedback before the update;
        # the loss is over the whole batch (no accumulation)
        def step(params, opt_state, err, batch):
            loss, _, grads = loss_and_grads(params, arch, batch, rt, policy)
            grads, err = compressed_grad_tree(grads, err)
            new_p, new_o, stats = adamw.update(grads, opt_state, params,
                                               opt_cfg, policy)
            return new_p, new_o, err, {"loss": loss, **stats}
        err_state = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    else:
        base_step = make_train_step(arch, rt, policy, opt_cfg)
        err_state = None

    monitor = HeartbeatMonitor(n_workers=1)
    losses, step_ms = [], []
    crashed = False
    i = start
    while i < args.steps:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(loader).items()}
        t0 = time.perf_counter()
        if args.compress_grads:
            params, opt_state, err_state, stats = step(
                params, opt_state, err_state, batch)
        else:
            params, opt_state, stats = base_step(params, opt_state, batch)
        losses.append(float(stats["loss"]))
        dt = time.perf_counter() - t0
        monitor.report(0, dt)
        step_ms.append(dt * 1e3)
        i += 1
        if (args.simulate_failure and i == args.simulate_failure
                and not crashed):
            print(f"!! simulated node failure at step {i}; restoring")
            crashed = True
            ckpt.save(i, {"params": params, "opt": opt_state}, blocking=True)
            # crash: lose live state, restore into fresh templates
            params = opt_state = None
            fresh = init_model(0, arch, policy, device)
            state = ckpt.restore({"params": fresh,
                                  "opt": adamw.init(fresh, policy)})
            params, opt_state = state["params"], state["opt"]
            i = ckpt.latest_step()
            print(f"recovered at step {i}")
        if i % args.ckpt_every == 0:
            ckpt.save(i, {"params": params, "opt": opt_state})
        if i % args.log_every == 0 or i == args.steps:
            print(f"step {i:5d} loss={losses[-1]:.4f} "
                  f"lr={float(stats['lr']):.2e} "
                  f"gnorm={float(stats['grad_norm']):.2f} "
                  f"dt={dt:.3f}s")
    ckpt.wait()
    loader.close()
    out = {"first_loss": losses[0], "final_loss": losses[-1],
           "steps": len(losses), "step_ms": step_ms}
    print(f"done: loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}")
    assert out["final_loss"] < out["first_loss"], "training failed to learn"
    return out


if __name__ == "__main__":
    main()
