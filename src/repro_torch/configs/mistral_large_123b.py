"""mistral-large-123b [dense] — GQA, SwiGLU (hf:mistralai/Mistral-Large-Instruct-2407)."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768, head_dim=128,
    act="silu", gated_mlp=True, rope_theta=1000000.0,
)
