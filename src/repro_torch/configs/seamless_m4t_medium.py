"""seamless-m4t-medium [audio] — enc-dec; speech frontend is a STUB
(input_specs provides precomputed frame embeddings) (arXiv:2308.11596)."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    enc_layers=12, act="gelu", gated_mlp=False,
)
