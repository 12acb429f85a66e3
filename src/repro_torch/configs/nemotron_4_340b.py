"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP (arXiv:2402.16819)."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, head_dim=192,
    act="relu2", gated_mlp=False, rope_theta=10000.0,
)
