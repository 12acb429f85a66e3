"""mamba2-130m [ssm] — SSD, attention-free (arXiv:2405.21060)."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True, sub_quadratic=True,
)
