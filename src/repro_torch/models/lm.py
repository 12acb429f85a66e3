"""Language-model assembly — the dense and moe families (GQA or MLA
attention) and the ssm family (Mamba2) of ``src/repro/models/lm.py``.

Public entry points (the JAX package's, without its runtime config,
which only carries mesh and remat hooks; MLA's absorbed decode is the
keyword ``mla_absorb``):
  init_model(seed, arch, policy, device)            -> params
  forward(params, arch, batch, policy)              -> (logits, aux)
  loss_fn(params, arch, batch, policy)              -> (loss, metrics)
  make_cache(arch, seq_len, batch, policy, device)  -> decode cache
  prefill(params, arch, batch, cache_len, policy)   -> (logits, cache)
  decode_step(params, arch, cache, tokens, policy, *, mla_absorb)
                                                    -> (logits, cache)

Layers are stacked on a leading [L, ...] axis, as in the JAX params
pytree, and a Python loop over ``l`` indexes them.  ``decode_step`` of
the attention families writes the new K/V (or latent) rows into the
cache it is given, in place, and returns a cache that shares those
tensors (a functional copy would move the whole cache every step);
clone the cache to decode twice from one state.  The hybrid, vlm and
audio families raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (AttnConfig, gqa_apply, gqa_decode,
                                          gqa_init, gqa_prefill, mla_apply,
                                          mla_decode, mla_init, mla_prefill)
from repro_torch.models.common import (DTypePolicy, Params, dense_init,
                                       norm_init, rms_norm, stack_layer_init,
                                       tree_map, truncated_normal_init)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import (MoEConfig, aux_load_balance_loss,
                                    moe_apply, moe_init)
from repro_torch.models.ssm import (SSMConfig, mamba2_apply, mamba2_decode,
                                    mamba2_init)


def _require_ported(arch: ArchConfig) -> None:
    if arch.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"{arch.name}: family {arch.family!r} is not ported yet; it "
            f"waits for ROADMAP A9 (the {arch.family} family)")


# ======================================================================
# Config adapters
# ======================================================================
def attn_config(arch: ArchConfig) -> AttnConfig:
    """The JAX adapter's (causal) config.  Its ``kv_repeat`` comes from
    the mesh's TP degree, which is 1 without a mesh, and the port has
    none; its non-causal form waits for the encoder families."""
    return AttnConfig(
        d_model=arch.d_model,
        n_heads=arch.n_heads,
        n_kv_heads=arch.n_kv_heads,
        head_dim=arch.resolved_head_dim,
        qk_norm=arch.qk_norm,
        rope_theta=arch.rope_theta,
        attn_type=arch.attn_type,
        q_lora_rank=arch.q_lora_rank,
        kv_lora_rank=arch.kv_lora_rank,
        rope_head_dim=arch.rope_head_dim,
    )


def moe_config(arch: ArchConfig) -> MoEConfig:
    return MoEConfig(
        d_model=arch.d_model, d_ff_expert=arch.d_ff,
        n_experts=arch.n_experts, top_k=arch.top_k,
        capacity_factor=arch.moe_capacity_factor,
        act=arch.act, gated=arch.gated_mlp,
    )


def ssm_config(arch: ArchConfig) -> SSMConfig:
    return SSMConfig(
        d_model=arch.d_model, d_state=arch.ssm_state,
        head_dim=arch.ssm_head_dim, expand=arch.ssm_expand,
        chunk=arch.ssm_chunk,
    )


# ======================================================================
# Per-layer blocks
# ======================================================================
def _attn_block_init(gen: torch.Generator, arch: ArchConfig) -> Params:
    init = mla_init if arch.attn_type == "mla" else gqa_init
    return {"attn": init(gen, attn_config(arch)),
            "ln": norm_init(arch.d_model, gen.device)}


def _decoder_layer_init(gen: torch.Generator, arch: ArchConfig) -> Params:
    p = _attn_block_init(gen, arch)
    p["ln2"] = norm_init(arch.d_model, gen.device)
    if arch.family == "moe":
        p["moe"] = moe_init(gen, moe_config(arch))
    else:
        p["mlp"] = mlp_init(gen, arch.d_model, arch.d_ff, arch.gated_mlp)
    return p


def _ssm_layer_init(gen: torch.Generator, arch: ArchConfig) -> Params:
    return {"mamba": mamba2_init(gen, ssm_config(arch)),
            "ln": norm_init(arch.d_model, gen.device)}


def _layer(blocks: Params, l: int) -> Params:
    """Layer ``l`` of the stacked block params (views)."""
    return tree_map(lambda t: t[l], blocks)


def _ffn(bp: Params, arch: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if arch.family == "moe":
        return moe_apply(bp["moe"], moe_config(arch), x)
    return mlp_apply(bp["mlp"], x, arch.act)


def _layer_apply_full(p: Params, arch: ArchConfig, h: torch.Tensor
                      ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Full-sequence decoder layer (train / prefill without a cache).
    Returns (h, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    x = rms_norm(h, p["ln"]["scale"])
    if arch.family == "ssm":
        return h + mamba2_apply(p["mamba"], ssm_config(arch), x), aux
    attn = mla_apply if arch.attn_type == "mla" else gqa_apply
    h = h + attn(p["attn"], attn_config(arch), x)
    x2 = rms_norm(h, p["ln2"]["scale"])
    h = h + _ffn(p, arch, x2)
    if arch.family == "moe":
        aux = aux_load_balance_loss(p["moe"], moe_config(arch), x2)
    return h, aux


# ======================================================================
# Model init
# ======================================================================
def init_model(seed: int, arch: ArchConfig,
               policy: DTypePolicy | None = None,
               device: "str | torch.device | None" = None) -> Params:
    """Random params from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the CUDA device when None), with the JAX initializer's
    distributions and pytree layout (not its values: carry JAX params
    across with ``convert.params_from_numpy``)."""
    _require_ported(arch)
    policy = policy or DTypePolicy.standard()
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d = arch.d_model
    params: Params = {
        # vocab padded to a multiple of 128, as in the JAX package
        "embed": truncated_normal_init(gen, (arch.padded_vocab, d), 1.0),
        "final_norm": norm_init(d, gen.device),
    }
    if not arch.tie_embeddings:
        params["head"] = dense_init(gen, d, arch.padded_vocab)
    layer_init = _ssm_layer_init if arch.family == "ssm" \
        else _decoder_layer_init
    params["blocks"] = stack_layer_init(partial(layer_init, arch=arch), gen,
                                        arch.n_layers)
    return tree_map(lambda t: t.to(policy.params)
                    if t.dtype == torch.float32 else t, params)


# ======================================================================
# Forward (train / prefill) and loss
# ======================================================================
def _cast_blocks(blocks: Params, dtype: torch.dtype) -> Params:
    """Stacked f32 weights of two or more dims (every stacked leaf, the
    norm scales included) to the compute dtype, as the JAX forward does
    once before its layer scan."""
    return tree_map(lambda t: t.to(dtype)
                    if t.ndim >= 2 and t.dtype == torch.float32 else t,
                    blocks)


def embed_tokens(params: Params, arch: ArchConfig, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Rows of the embedding times sqrt(d_model), the scale rounded to
    the compute dtype first, as JAX rounds it."""
    e = params["embed"][tokens.long()].to(compute_dtype)
    scale = torch.tensor(math.sqrt(arch.d_model), dtype=torch.float32,
                         device=e.device).to(compute_dtype)
    return e * scale


def _logits(params: Params, h: torch.Tensor, cd: torch.dtype
            ) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"]["scale"])
    head = params.get("head")
    w = (params["embed"].T if head is None else head).to(cd)
    return h @ w


def forward(params: Params, arch: ArchConfig, batch: "dict[str, torch.Tensor]",
            policy: DTypePolicy | None = None
            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Full-sequence forward.  batch: {"tokens": [B, S]}.  Returns
    (logits [B, S, V], aux loss: the MoE load-balance loss summed over
    the layers, 0 for the other families)."""
    _require_ported(arch)
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    h = embed_tokens(params, arch, batch["tokens"], cd)
    blocks = _cast_blocks(params["blocks"], cd)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for l in range(arch.n_layers):
        h, a = _layer_apply_full(_layer(blocks, l), arch, h)
        aux = aux + a
    return _logits(params, h, cd), aux


def loss_fn(params: Params, arch: ArchConfig,
            batch: "dict[str, torch.Tensor]",
            policy: DTypePolicy | None = None
            ) -> "tuple[torch.Tensor, dict]":
    """Next-token cross entropy + z-loss + 0.01 x the MoE aux loss.
    batch: {"tokens", "labels"} [B, S]; labels < 0 are masked."""
    logits, aux = forward(params, arch, batch, policy)
    labels = batch["labels"].long()
    lg = logits.float()
    m = torch.amax(lg, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    # the gold logit; JAX takes it by a masked reduce over the vocab,
    # which gives the same value
    gold = torch.gather(lg, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = torch.sum(nll * mask) / denom
    z_loss = 1e-4 * torch.sum(torch.square(lse) * mask) / denom
    aux_w = 0.01 * aux
    loss = ce + z_loss + aux_w
    return loss, {"ce": ce, "z_loss": z_loss, "aux": aux_w,
                  "tokens": mask.sum()}


# ======================================================================
# Decode caches
# ======================================================================
def make_cache(arch: ArchConfig, seq_len: int, batch: int,
               policy: DTypePolicy | None = None,
               device: "str | torch.device | None" = None) -> Params:
    """The decode cache of capacity ``seq_len`` on ``device`` (the CUDA
    device when None): K/V [L, B, Hkv, S, hd] (MLA: the latent c_kv
    [L, B, S, kvr] and the shared rope key k_rope [L, B, S, r]) in the
    compute dtype; the ssm family's state [L, B, H, P, N] (f32) and
    conv tail [L, B, W-1, C] (compute dtype)."""
    _require_ported(arch)
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    dev = resolve_device(device)
    L, B = arch.n_layers, batch

    def zeros(*shape, dtype=cd):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Params = {"len": zeros(dtype=torch.int32)}
    if arch.family == "ssm":
        scfg = ssm_config(arch)
        cache["ssm_h"] = zeros(L, B, scfg.n_heads, scfg.head_dim,
                               scfg.d_state, dtype=torch.float32)
        cache["ssm_conv"] = zeros(L, B, scfg.conv_width - 1,
                                  scfg.conv_channels)
    elif arch.attn_type == "mla":
        cache["c_kv"] = zeros(L, B, seq_len, arch.kv_lora_rank)
        cache["k_rope"] = zeros(L, B, seq_len, arch.rope_head_dim)
    else:
        hd = arch.resolved_head_dim
        cache["k"] = zeros(L, B, arch.n_kv_heads, seq_len, hd)
        cache["v"] = zeros(L, B, arch.n_kv_heads, seq_len, hd)
    return cache


# ======================================================================
# Prefill and decode
# ======================================================================
def prefill(params: Params, arch: ArchConfig,
            batch: "dict[str, torch.Tensor]", cache_len: int,
            policy: DTypePolicy | None = None
            ) -> "tuple[torch.Tensor, Params]":
    """Run the full-sequence forward and fill a decode cache of capacity
    ``cache_len`` (>= prompt length; the rest stays 0).  The layer
    weights stay f32, cast at each product.  Returns (logits of the
    last position [B, 1, V], cache)."""
    _require_ported(arch)
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    cache = make_cache(arch, cache_len, b, policy, tokens.device)
    h = embed_tokens(params, arch, tokens, cd)
    acfg = attn_config(arch)
    for l in range(arch.n_layers):
        bp = _layer(params["blocks"], l)
        xn = rms_norm(h, bp["ln"]["scale"])
        if arch.family == "ssm":
            o, (hf, conv_tail) = mamba2_apply(bp["mamba"], ssm_config(arch),
                                              xn, return_state=True)
            cache["ssm_h"][l] = hf
            cache["ssm_conv"][l] = conv_tail.to(cd)
        elif arch.attn_type == "mla":
            o, (ckv, kr) = mla_prefill(bp["attn"], acfg, xn)
            cache["c_kv"][l, :, :s] = ckv.to(cd)
            cache["k_rope"][l, :, :s] = kr.to(cd)
        else:
            o, (kc, vc) = gqa_prefill(bp["attn"], acfg, xn)
            cache["k"][l, :, :, :s] = kc.to(cd)
            cache["v"][l, :, :, :s] = vc.to(cd)
        h = h + o
        if arch.family != "ssm":
            h = h + _ffn(bp, arch, rms_norm(h, bp["ln2"]["scale"]))
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return _logits(params, h[:, -1:, :], cd), cache


def decode_step(params: Params, arch: ArchConfig, cache: Params,
                tokens: torch.Tensor, policy: DTypePolicy | None = None,
                *, mla_absorb: bool = False
                ) -> "tuple[torch.Tensor, Params]":
    """One decode step.  tokens: [B, 1] new token ids.  Returns (logits
    [B, 1, V], a cache with ``len`` one higher).  The attention
    families write their new rows into ``cache``'s tensors in place;
    the ssm family returns new state tensors."""
    _require_ported(arch)
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    h = embed_tokens(params, arch, tokens, cd)
    pos = cache["len"]
    if arch.family == "ssm":
        scfg = ssm_config(arch)
        hs, convs = [], []
        for l in range(arch.n_layers):
            bp = _layer(params["blocks"], l)
            xn = rms_norm(h, bp["ln"]["scale"])
            o, (hc, cc) = mamba2_decode(
                bp["mamba"], scfg, xn,
                (cache["ssm_h"][l], cache["ssm_conv"][l]))
            h = h + o
            hs.append(hc)
            convs.append(cc)
        cache = {**cache, "ssm_h": torch.stack(hs),
                 "ssm_conv": torch.stack(convs)}
    else:
        acfg = attn_config(arch)
        for l in range(arch.n_layers):
            bp = _layer(params["blocks"], l)
            xn = rms_norm(h, bp["ln"]["scale"])
            if arch.attn_type == "mla":
                o, _ = mla_decode(bp["attn"], acfg, xn,
                                  (cache["c_kv"][l], cache["k_rope"][l]),
                                  pos, absorb=mla_absorb)
            else:
                o, _ = gqa_decode(bp["attn"], acfg, xn,
                                  (cache["k"][l], cache["v"][l]), pos)
            h = h + o
            h = h + _ffn(bp, arch, rms_norm(h, bp["ln2"]["scale"]))
    cache = {**cache, "len": cache["len"] + 1}
    return _logits(params, h, cd), cache
