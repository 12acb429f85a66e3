"""internvl2-1b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + Qwen2-0.5B LM backbone (arXiv:2404.16821)."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, head_dim=64,
    vit_dim=1024, n_patches=256,
    act="silu", gated_mlp=True, tie_embeddings=True,
    rope_theta=1000000.0,
)
