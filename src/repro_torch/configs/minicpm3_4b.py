"""minicpm3-4b [dense] — MLA attention (hf:openbmb/MiniCPM3-4B)."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=64,
    attn_type="mla", q_lora_rank=768, kv_lora_rank=256, rope_head_dim=32,
    act="silu", gated_mlp=True, tie_embeddings=True,
)
