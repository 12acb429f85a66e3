"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block every
6 layers (arXiv:2411.15242)."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    shared_attn_every=6, tie_embeddings=True, sub_quadratic=True,
)
