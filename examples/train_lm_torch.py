"""Scenario on the PyTorch port: end-to-end training.

Trains the ~100M-parameter preset on the synthetic corpus for a few
hundred steps with checkpointing + crash-recovery enabled, asserting the
loss goes down, through ``repro_torch.launch.train.main`` with the
arguments ``examples/train_lm.py`` gives the JAX package's
``launch/train.py``.  Its checkpoints go to ``repro_torch_train_lm``
under the temporary directory, never the JAX example's
``repro_train_lm``: the two checkpoint formats differ, and the recovery
must find only its own.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
          [--device cpu]
      (the CUDA device unless ``--device`` names another)
"""
import argparse
import os
import tempfile

from repro_torch.launch import train

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default="300")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    return train.main([
        "--preset", "m100",
        "--steps", args.steps,
        "--batch", "8",
        "--seq", "256",
        "--ckpt-dir", CKPT_DIR,
        "--ckpt-every", "100",
        "--simulate-failure", "150",
        "--log-every", "25",
    ] + (["--device", args.device] if args.device else []))


if __name__ == "__main__":
    main()
