"""Language-model assembly for every family of ``src/repro/models/lm.py``:
dense and moe (GQA or MLA attention), ssm (Mamba2), hybrid (Mamba2 with
a zamba2-style shared attention block), vlm (a patch-embedding prefix)
and audio (an encoder-decoder with cross attention).

Public entry points (the JAX package's; its runtime config carries
mesh and remat hooks, and the port takes it as the keyword ``rt`` of
``forward`` and ``loss_fn``, where only ``rt.remat`` is read; MLA's
absorbed decode is the keyword ``mla_absorb``):
  init_model(seed, arch, policy, device)            -> params
  forward(params, arch, batch, policy, *, rt)       -> (logits, aux)
  loss_fn(params, arch, batch, policy, *, rt)       -> (loss, metrics)
  make_cache(arch, seq_len, batch, policy, device)  -> decode cache
  prefill(params, arch, batch, cache_len, policy)   -> (logits, cache)
  decode_step(params, arch, cache, tokens, policy, *, mla_absorb)
                                                    -> (logits, cache)

Layers are stacked on a leading [L, ...] axis, as in the JAX params
pytree, and a Python loop over ``l`` indexes them.  With ``rt.remat ==
"full"`` each layer of that loop (the decoder's, with the hybrid's
shared block; the encoder's; the cross decoder's) runs under
``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint``: its activations are recomputed in the backward, so
remat changes memory, not values.  ``rt=None`` runs without remat.
``decode_step`` writes the new K/V (or latent) rows into the cache it
is given, in place (the hybrid's shared K/V too), and returns a cache
that shares those tensors (a functional copy would move the whole cache
every step); clone the cache to decode twice from one state.

Activation-sharding hooks go through ``repro_torch.launch.sharding.
constrain`` at the reference's places (the boundary activations, the
logits), so the model code stays mesh-agnostic: outside an
``activation_sharding`` context they are the identity, and inside one
they redistribute DTensor activations (``launch/sharding.py``).  What
DTensor cannot run as written (head splits, the embedding lookup, the
cache writes, the gold logit) goes through ``repro_torch.dtensor_ops``,
which is the plain op on a plain tensor.

Kept from the reference, as it is: the hybrid's ``prefill`` skips the
shared block (its logits are the model's without it, and ``shared_k``/
``shared_v`` stay zero); the vlm's ``prefill`` and ``decode_step``
ignore ``patches``; an encdec cache holds at most
``max(cache_len // cross_len_frac, 16)`` encoder positions.
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, RuntimeConfig
from repro_torch.device import resolve_device
from repro_torch.dtensor_ops import (embedding_rows, merge_heads, per_head,
                                     put, split_dim, take_last)
from repro_torch.launch.sharding import constrain, tp_hint
from repro_torch.models.attention import (AttnConfig, flash_attention,
                                          gqa_apply, gqa_decode, gqa_init,
                                          gqa_prefill, mla_apply, mla_decode,
                                          mla_init, mla_prefill)
from repro_torch.models.common import (DTypePolicy, Params, dense_init,
                                       norm_init, rms_norm, stack_layer_init,
                                       tree_map, truncated_normal_init)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import (MoEConfig, aux_load_balance_loss,
                                    moe_apply, moe_init)
from repro_torch.models.ssm import (SSMConfig, mamba2_apply, mamba2_decode,
                                    mamba2_init)


# ======================================================================
# Config adapters
# ======================================================================
def attn_config(arch: ArchConfig, causal: bool = True) -> AttnConfig:
    """The JAX adapter's config: causal for the decoders, non-causal for
    the encoder's self attention and the cross attention.  Its
    ``kv_repeat`` comes from the TP degree of the activation-sharding
    context (``tp_hint``, 1 outside one): kv heads are replicated up to
    it where they are fewer and it divides the query heads."""
    tp = tp_hint()
    rep = 1
    if tp > 1 and arch.n_kv_heads < tp and tp % arch.n_kv_heads == 0 \
            and arch.n_heads % tp == 0:
        rep = tp // arch.n_kv_heads        # Megatron kv replication
    return AttnConfig(
        d_model=arch.d_model,
        n_heads=arch.n_heads,
        n_kv_heads=arch.n_kv_heads,
        head_dim=arch.resolved_head_dim,
        qk_norm=arch.qk_norm,
        rope_theta=arch.rope_theta,
        causal=causal,
        attn_type=arch.attn_type,
        q_lora_rank=arch.q_lora_rank,
        kv_lora_rank=arch.kv_lora_rank,
        rope_head_dim=arch.rope_head_dim,
        kv_repeat=rep,
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


def _has_ssm(arch: ArchConfig) -> bool:
    return arch.family in ("ssm", "hybrid")


def _shared_every(arch: ArchConfig) -> int:
    """The hybrid's shared-block cadence; 0 means no shared block."""
    return arch.shared_attn_every if arch.family == "hybrid" else 0


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


def _encoder_layer_init(gen: torch.Generator, arch: ArchConfig) -> Params:
    return {"attn": gqa_init(gen, attn_config(arch, causal=False)),
            "ln": norm_init(arch.d_model, gen.device),
            "mlp": mlp_init(gen, arch.d_model, arch.d_ff, arch.gated_mlp),
            "ln2": norm_init(arch.d_model, gen.device)}


def _cross_decoder_layer_init(gen: torch.Generator, arch: ArchConfig
                              ) -> Params:
    p = _decoder_layer_init(gen, arch)
    p["cross"] = gqa_init(gen, attn_config(arch, causal=False))
    p["ln_cross"] = norm_init(arch.d_model, gen.device)
    return p


def _shared_block_init(gen: torch.Generator, arch: ArchConfig) -> Params:
    """zamba2-style shared attention block, fed concat(h, emb0)."""
    p = _decoder_layer_init(gen, arch)
    p["w_cat"] = dense_init(gen, 2 * arch.d_model, arch.d_model)
    return p


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
    # sub-block outputs take the "hidden" layout before the residual add
    x = constrain(rms_norm(h, p["ln"]["scale"]), "tp_in")
    if _has_ssm(arch):
        h = h + constrain(mamba2_apply(p["mamba"], ssm_config(arch), x),
                          "hidden")
        return constrain(h, "hidden"), aux
    attn = mla_apply if arch.attn_type == "mla" else gqa_apply
    h = h + constrain(attn(p["attn"], attn_config(arch), x), "hidden")
    x2 = constrain(rms_norm(h, p["ln2"]["scale"]), "tp_in")
    h = h + constrain(_ffn(p, arch, x2), "hidden")
    if arch.family == "moe":
        aux = aux_load_balance_loss(p["moe"], moe_config(arch), x2)
    return constrain(h, "hidden"), aux


def _shared_block_apply(p: Params, arch: ArchConfig, h: torch.Tensor,
                        emb0: torch.Tensor, attend) -> torch.Tensor:
    """The shared block on concat(h, emb0) projected back to d_model.
    ``attend(attn_params, x)`` is its attention: the full-sequence GQA
    in ``forward``, one step against the shared cache in
    ``decode_step``."""
    z = torch.cat([constrain(h, "tp_in"), emb0.to(h.dtype)], dim=-1) \
        @ p["w_cat"].to(h.dtype)
    z = constrain(z, "hidden")
    z = z + constrain(attend(p["attn"], rms_norm(z, p["ln"]["scale"])),
                      "hidden")
    z = z + constrain(mlp_apply(p["mlp"], rms_norm(z, p["ln2"]["scale"]),
                                arch.act), "hidden")
    return h + z


def _cross_attn_full(p: Params, arch: ArchConfig, x: torch.Tensor,
                     enc_out: torch.Tensor):
    """Cross attention over every encoder position, without RoPE: q from
    the decoder's ``x`` [B, S, D], K/V from ``enc_out`` [B, S_enc, D].
    Returns (out [B, S, D], (k, v) [B, Hkv, S_enc, hd])."""
    cfg = attn_config(arch, causal=False)
    b, s, _ = x.shape
    hd = cfg.head_dim
    enc = enc_out.to(x.dtype)
    q = split_dim(x @ p["wq"].to(x.dtype), -1, cfg.n_heads, hd)
    k = split_dim(enc @ p["wk"].to(x.dtype), -1, cfg.n_kv_heads, hd)
    v = split_dim(enc @ p["wv"].to(x.dtype), -1, cfg.n_kv_heads, hd)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    o = flash_attention(q.transpose(1, 2), k, v, causal=False)
    o = merge_heads(o.transpose(1, 2))
    return o @ p["wo"].to(x.dtype), (k, v)


def _cross_decoder_layer(bp: Params, arch: ArchConfig, h: torch.Tensor,
                         enc_out: torch.Tensor):
    """One encdec decoder layer over the whole sequence: causal self
    attention, cross attention to ``enc_out``, MLP.  Returns (h, (self
    K, self V, cross K, cross V)), each [B, Hkv, *, hd]."""
    o, (kc, vc) = gqa_prefill(bp["attn"], attn_config(arch), constrain(
        rms_norm(h, bp["ln"]["scale"]), "tp_in"))
    h = h + o
    o, (xk, xv) = _cross_attn_full(bp["cross"], arch, constrain(
        rms_norm(h, bp["ln_cross"]["scale"]), "tp_in"), enc_out)
    h = h + o
    h = h + mlp_apply(bp["mlp"], constrain(
        rms_norm(h, bp["ln2"]["scale"]), "tp_in"), arch.act)
    return constrain(h, "hidden"), (kc, vc, xk, xv)


def _cross_decode_core(q, ck, cv):
    s = (q.float() @ ck.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(s, dim=-1) @ cv.float()


def _cross_attn_decode(p: Params, arch: ArchConfig, x: torch.Tensor,
                       ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One decoder token against the cross cache: x [B, D], ck/cv
    [B, Hkv, S_enc, hd]; f32 scores over every cached position, no
    mask.  Returns [B, 1, D]."""
    b = x.shape[0]
    hd = arch.resolved_head_dim
    g = arch.n_heads // arch.n_kv_heads
    q = split_dim(x @ p["wq"].to(x.dtype), -1, arch.n_kv_heads, g, hd)
    o = per_head(_cross_decode_core, q, (q, (0, 1)), (ck, (0, 1)),
                 (cv, (0, 1)))
    o = o.reshape(b, 1, arch.n_heads * hd).to(x.dtype)
    return o @ p["wo"].to(x.dtype)


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
    if _has_ssm(arch):
        layer_init = _ssm_layer_init
    elif arch.is_encdec:
        layer_init = _cross_decoder_layer_init
    else:
        layer_init = _decoder_layer_init
    params["blocks"] = stack_layer_init(partial(layer_init, arch=arch), gen,
                                        arch.n_layers)
    if _shared_every(arch):
        params["shared"] = _shared_block_init(gen, arch)
    if arch.is_encdec:
        params["enc_blocks"] = stack_layer_init(
            partial(_encoder_layer_init, arch=arch), gen, arch.enc_layers)
        params["enc_norm"] = norm_init(d, gen.device)
    if arch.family == "vlm":
        params["patch_proj"] = dense_init(gen, arch.vit_dim, d)
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
    e = embedding_rows(params["embed"], tokens.long()).to(compute_dtype)
    scale = torch.tensor(math.sqrt(arch.d_model), dtype=torch.float32,
                         device=e.device).to(compute_dtype)
    return constrain(e * scale, "hidden")


def _logits(params: Params, h: torch.Tensor, cd: torch.dtype
            ) -> torch.Tensor:
    h = constrain(rms_norm(h, params["final_norm"]["scale"]), "tp_in")
    head = params.get("head")
    w = (params["embed"].T if head is None else head).to(cd)
    return h @ w


def _remat(rt: "RuntimeConfig | None", layer, *args):
    """``layer(*args)``, under ``torch.utils.checkpoint`` when
    ``rt.remat`` is "full"."""
    if rt is not None and rt.remat == "full":
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def _encoder_forward(params: Params, arch: ArchConfig,
                     frames: torch.Tensor,
                     rt: "RuntimeConfig | None" = None) -> torch.Tensor:
    """The encoder over ``frames`` [B, S_enc, D] (non-causal), on the
    f32 block params cast at each product, as JAX runs it."""
    acfg = attn_config(arch, causal=False)

    def one_layer(h, bp):
        h = h + gqa_apply(bp["attn"], acfg, constrain(
            rms_norm(h, bp["ln"]["scale"]), "tp_in"))
        h = h + mlp_apply(bp["mlp"], constrain(
            rms_norm(h, bp["ln2"]["scale"]), "tp_in"), arch.act)
        return constrain(h, "hidden")

    h = frames
    for l in range(arch.enc_layers):
        h = _remat(rt, one_layer, h, _layer(params["enc_blocks"], l))
    return constrain(rms_norm(h, params["enc_norm"]["scale"]), "tp_in")


def forward(params: Params, arch: ArchConfig, batch: "dict[str, torch.Tensor]",
            policy: DTypePolicy | None = None, *,
            rt: "RuntimeConfig | None" = None
            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Full-sequence forward.  batch: "tokens" [B, S]; vlm: + "patches"
    [B, P, vit_dim], whose projections come before the tokens (logits
    [B, P + S, V]); audio: + "frames" [B, S_enc, d_model].  Returns
    (logits, aux loss: the MoE load-balance loss summed over the layers,
    0 for the other families).  ``rt.remat == "full"`` recomputes each
    layer in the backward."""
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    h = embed_tokens(params, arch, batch["tokens"], cd)
    if arch.family == "vlm":
        prefix = batch["patches"].to(cd) @ params["patch_proj"].to(cd)
        h = torch.cat([prefix, h], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if arch.is_encdec:
        # the encdec stacks run uncast, as in JAX
        enc_out = _encoder_forward(params, arch, batch["frames"].to(cd),
                                   rt)
        for l in range(arch.n_layers):
            h = _remat(rt, lambda hh, bp: _cross_decoder_layer(
                bp, arch, hh, enc_out)[0], h, _layer(params["blocks"], l))
        return constrain(_logits(params, h, cd), "logits"), aux
    blocks = _cast_blocks(params["blocks"], cd)
    every, emb0 = _shared_every(arch), h
    acfg = attn_config(arch)

    def one_layer(hh, bp, l):
        hh, a = _layer_apply_full(bp, arch, hh)
        if every and l % every == 0:
            hh = _shared_block_apply(params["shared"], arch, hh, emb0,
                                     lambda ap, x: gqa_apply(ap, acfg, x))
        return hh, a

    for l in range(arch.n_layers):
        h, a = _remat(rt, one_layer, h, _layer(blocks, l), l)
        aux = aux + a
    return constrain(_logits(params, h, cd), "logits"), aux


def loss_fn(params: Params, arch: ArchConfig,
            batch: "dict[str, torch.Tensor]",
            policy: DTypePolicy | None = None, *,
            rt: "RuntimeConfig | None" = None
            ) -> "tuple[torch.Tensor, dict]":
    """Next-token cross entropy + z-loss + 0.01 x the MoE aux loss.
    batch: forward's, with "labels" [B, S]; labels < 0 are masked.  The
    vlm's logits are cut to the labels' length (the token positions).
    ``rt`` is forward's."""
    logits, aux = forward(params, arch, batch, policy, rt=rt)
    labels = batch["labels"].long()
    if arch.family == "vlm":
        logits = logits[:, -labels.shape[1]:, :]
    lg = logits.float()
    m = torch.amax(lg, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    # the gold logit (JAX takes it by a masked reduce over the vocab,
    # which gives the same value; so does take_last on vocab shards)
    gold = take_last(lg, torch.clamp(labels, min=0))
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
    device when None), in the compute dtype unless said: self K/V
    [L, B, Hkv, S, hd] (MLA: the latent c_kv [L, B, S, kvr] and the
    shared rope key k_rope [L, B, S, r]); an encdec's cross K/V
    [L, B, Hkv, max(S // cross_len_frac, 16), hd]; the ssm and hybrid
    state [L, B, H, P, N] (f32) and conv tail [L, B, W-1, C]; the
    hybrid's shared-block K/V [ceil(L / every), B, Hkv, S, hd]."""
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    dev = resolve_device(device)
    L, B = arch.n_layers, batch
    hd = arch.resolved_head_dim

    def zeros(*shape, dtype=cd):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Params = {"len": zeros(dtype=torch.int32)}
    if _has_ssm(arch):
        scfg = ssm_config(arch)
        cache["ssm_h"] = zeros(L, B, scfg.n_heads, scfg.head_dim,
                               scfg.d_state, dtype=torch.float32)
        cache["ssm_conv"] = zeros(L, B, scfg.conv_width - 1,
                                  scfg.conv_channels)
    elif arch.attn_type == "mla":
        cache["c_kv"] = zeros(L, B, seq_len, arch.kv_lora_rank)
        cache["k_rope"] = zeros(L, B, seq_len, arch.rope_head_dim)
    else:
        cache["k"] = zeros(L, B, arch.n_kv_heads, seq_len, hd)
        cache["v"] = zeros(L, B, arch.n_kv_heads, seq_len, hd)
    if arch.is_encdec:
        s_enc = max(seq_len // arch.cross_len_frac, 16)
        cache["cross_k"] = zeros(L, B, arch.n_kv_heads, s_enc, hd)
        cache["cross_v"] = zeros(L, B, arch.n_kv_heads, s_enc, hd)
    every = _shared_every(arch)
    if every:
        n_uses = -(-L // every)
        cache["shared_k"] = zeros(n_uses, B, arch.n_kv_heads, seq_len, hd)
        cache["shared_v"] = zeros(n_uses, B, arch.n_kv_heads, seq_len, hd)
    return cache


# ======================================================================
# Prefill and decode
# ======================================================================
def prefill(params: Params, arch: ArchConfig,
            batch: "dict[str, torch.Tensor]", cache_len: int,
            policy: DTypePolicy | None = None
            ) -> "tuple[torch.Tensor, Params]":
    """Run the full-sequence forward over the tokens and fill a decode
    cache of capacity ``cache_len`` (>= prompt length; the rest stays
    0).  The layer weights stay f32, cast at each product.  An encdec
    runs its encoder over ``batch["frames"]`` and *replaces* the cross
    cache by the first ``s_enc`` encoder positions (fewer when there are
    fewer frames).  The hybrid skips its shared block and the vlm its
    patches, as the reference does.  Returns (logits of the last
    position [B, 1, V], cache)."""
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    cache = make_cache(arch, cache_len, b, policy, tokens.device)
    h = embed_tokens(params, arch, tokens, cd)
    acfg = attn_config(arch)
    if arch.is_encdec:
        enc_out = _encoder_forward(params, arch, batch["frames"].to(cd))
        s_enc = cache["cross_k"].shape[3]
        xks, xvs = [], []
    for l in range(arch.n_layers):
        bp = _layer(params["blocks"], l)
        if arch.is_encdec:
            h, (kc, vc, xk, xv) = _cross_decoder_layer(bp, arch, h, enc_out)
            put(cache, "k", (l, slice(None), slice(None), slice(s)),
                 kc.to(cd))
            put(cache, "v", (l, slice(None), slice(None), slice(s)),
                 vc.to(cd))
            xks.append(xk[:, :, :s_enc])
            xvs.append(xv[:, :, :s_enc])
            continue
        xn = constrain(rms_norm(h, bp["ln"]["scale"]), "tp_in")
        if _has_ssm(arch):
            o, (hf, conv_tail) = mamba2_apply(bp["mamba"], ssm_config(arch),
                                              xn, return_state=True)
            put(cache, "ssm_h", (l,), hf)
            put(cache, "ssm_conv", (l,), conv_tail.to(cd))
        elif arch.attn_type == "mla":
            o, (ckv, kr) = mla_prefill(bp["attn"], acfg, xn)
            put(cache, "c_kv", (l, slice(None), slice(s)), ckv.to(cd))
            put(cache, "k_rope", (l, slice(None), slice(s)), kr.to(cd))
        else:
            o, (kc, vc) = gqa_prefill(bp["attn"], acfg, xn)
            put(cache, "k", (l, slice(None), slice(None), slice(s)),
                 kc.to(cd))
            put(cache, "v", (l, slice(None), slice(None), slice(s)),
                 vc.to(cd))
        h = h + o
        if not _has_ssm(arch):
            h = h + _ffn(bp, arch, constrain(
                rms_norm(h, bp["ln2"]["scale"]), "tp_in"))
        h = constrain(h, "hidden")
    if arch.is_encdec:
        cache["cross_k"] = torch.stack(xks).to(cd)
        cache["cross_v"] = torch.stack(xvs).to(cd)
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return _logits(params, h[:, -1:, :], cd), cache


def decode_step(params: Params, arch: ArchConfig, cache: Params,
                tokens: torch.Tensor, policy: DTypePolicy | None = None,
                *, mla_absorb: bool = False
                ) -> "tuple[torch.Tensor, Params]":
    """One decode step.  tokens: [B, 1] new token ids.  Returns (logits
    [B, 1, V], a cache with ``len`` one higher).  The attention caches
    (self K/V or latent, the hybrid's shared K/V) take their new rows in
    place; the ssm state comes back as new tensors; an encdec reads its
    cross cache as it is."""
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    h = embed_tokens(params, arch, tokens, cd)
    pos = cache["len"]
    acfg = attn_config(arch)
    if _has_ssm(arch):
        scfg = ssm_config(arch)
        every, emb0 = _shared_every(arch), h
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
            if every and l % every == 0:
                kv = (cache["shared_k"][l // every],
                      cache["shared_v"][l // every])
                h = _shared_block_apply(
                    params["shared"], arch, h, emb0,
                    lambda ap, x: gqa_decode(ap, acfg, x, kv, pos)[0])
        cache = {**cache, "ssm_h": torch.stack(hs),
                 "ssm_conv": torch.stack(convs)}
    else:
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
            if arch.is_encdec:
                xc = rms_norm(h, bp["ln_cross"]["scale"])
                h = h + _cross_attn_decode(bp["cross"], arch, xc[:, 0],
                                           cache["cross_k"][l],
                                           cache["cross_v"][l])
            h = h + _ffn(bp, arch, rms_norm(h, bp["ln2"]["scale"]))
    cache = {**cache, "len": cache["len"] + 1}
    return constrain(_logits(params, h, cd), "logits"), cache
