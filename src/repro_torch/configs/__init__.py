"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (FAMILIES, SHAPES, ArchConfig,
                                      RuntimeConfig, ShapeConfig,
                                      shape_applicable)

_MODULES = {
    "nemotron-4-340b": "nemotron_4_340b",
    "mistral-large-123b": "mistral_large_123b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen3-1.7b": "qwen3_1_7b",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-130m": "mamba2_130m",
    "internvl2-1b": "internvl2_1b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.ARCH


def tiny_variant(arch: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    import dataclasses
    small = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(arch.n_kv_heads, 2)),
        d_ff=128,
        vocab=256,
        head_dim=16,
    )
    if arch.attn_type == "mla":
        small.update(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                     head_dim=16, n_kv_heads=4)
    if arch.family == "moe":
        small.update(n_experts=4, top_k=2, d_ff=32)
    if arch.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if arch.family == "hybrid":
        small.update(shared_attn_every=2, n_heads=4, head_dim=16,
                     n_kv_heads=4)
    if arch.is_encdec:
        small.update(enc_layers=2)
    if arch.family == "vlm":
        small.update(vit_dim=32, n_patches=8)
    small.update(overrides)
    return dataclasses.replace(arch, **small)


__all__ = [
    "ArchConfig", "ShapeConfig", "RuntimeConfig", "SHAPES", "FAMILIES",
    "ARCH_NAMES", "get_arch", "tiny_variant", "shape_applicable",
]
