"""Scenario on the PyTorch port: batched serving with the AMM memory
planner.

Runs the planner (locality -> AMM-vs-banked decision per memory stream),
prefills a batch of prompts and decodes continuations, printing
tokens/s, through ``repro_torch.launch.serve.main`` with the arguments
``examples/serve_lm.py`` gives the JAX package's ``launch/serve.py``.
Try --arch minicpm3-4b to see the MLA latent cache, or --arch
mamba2-130m for the attention-free path, whose prefill runs the SSD
chunk kernel once a chunk of each layer.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py
          [--arch qwen3-1.7b] [--device cpu]
      (the CUDA device unless ``--device`` names another)
"""
import sys

from repro_torch.launch import serve

FIXED = ["--preset", "tiny", "--batch", "4", "--prompt-len", "64",
         "--gen", "32"]


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv += ["--arch", "qwen3-1.7b"]
    return serve.main(argv + FIXED)


if __name__ == "__main__":
    main()
