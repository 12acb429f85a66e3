"""Architecture + shape configuration system.

``ArchConfig`` captures everything needed to build one of the assigned
architectures; one ``configs/<id>.py`` per arch instantiates it with the
exact published numbers.  ``ShapeConfig`` captures the assigned input
shapes (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    attn_type: str = "gqa"         # gqa | mla
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MLA (minicpm3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    shared_attn_every: int = 0     # hybrid: shared attn block cadence
    # --- enc-dec (audio) ---
    enc_layers: int = 0            # >0 -> encoder-decoder
    cross_len_frac: int = 8        # encoder len = seq_len // frac at decode
    # --- VLM ---
    vit_dim: int = 0               # stub patch-embedding dim
    n_patches: int = 256
    # --- technique hooks (the paper's AMM planner) ---
    sub_quadratic: bool = False    # can run long_500k
    vocab_pad_multiple: int = 128  # TPU lane alignment + mesh divisibility

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def param_count_estimate(self) -> int:
        """Analytic parameter count (sanity-checked in tests)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        total = V * d                       # embedding
        if not self.tie_embeddings:
            total += V * d                  # head
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            if self.attn_type == "mla":
                per_layer += d * self.q_lora_rank
                per_layer += self.q_lora_rank * self.n_heads * (hd + self.rope_head_dim)
                per_layer += d * (self.kv_lora_rank + self.rope_head_dim)
                per_layer += self.kv_lora_rank * self.n_heads * hd * 2
                per_layer += self.n_heads * hd * d
            else:
                per_layer += d * self.n_heads * hd
                per_layer += 2 * d * self.n_kv_heads * hd
                per_layer += self.n_heads * hd * d
            if self.family == "moe":
                ff_mults = 3 if self.gated_mlp else 2
                per_layer += d * self.n_experts          # router
                per_layer += self.n_experts * ff_mults * d * self.d_ff
            else:
                ff_mults = 3 if self.gated_mlp else 2
                per_layer += ff_mults * d * self.d_ff
        elif self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            h = di // self.ssm_head_dim
            per_layer += d * (2 * di + 2 * self.ssm_state + h)   # in_proj
            per_layer += di * d                                   # out_proj
        total += L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            # one shared attention+mlp block (+ concat projector)
            total += 4 * d * self.n_heads * hd + (3 if self.gated_mlp else 2) * d * self.d_ff
            total += 2 * d * d
        if self.is_encdec:
            # encoder blocks + decoder cross-attention
            enc_per = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + (3 if self.gated_mlp else 2) * d * self.d_ff
            total += self.enc_layers * enc_per
            total += self.n_layers * (2 * d * self.n_heads * hd)  # cross kv/q approx
        if self.family == "vlm":
            total += self.vit_dim * d
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (skip for pure
    full-attention archs, run for SSM/hybrid — per the assignment)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch: 500k decode is quadratic-cost; skipped per assignment"
    return True, ""


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Per (arch x shape) runtime knobs, resolved by the launcher."""
    dtype_preset: str = "standard"     # standard | lean | ultra_lean
    accum_steps: int = 1
    seq_shard_acts: bool = False       # Megatron-SP boundary activations
    kv_shard: str = "heads"            # heads | seq
    mla_absorb: bool = False
    remat: str = "full"                # full | none
    axis_profile: str = "tp"           # tp (Megatron) | dp (pure FSDP-256)
