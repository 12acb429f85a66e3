"""Attention variants: GQA (with optional qk-norm) and MLA (multi-head
latent attention, MiniCPM3/DeepSeek-V2 style), as
``src/repro/models/attention.py``.

Full-sequence attention is computed blockwise over KV blocks with an
online-softmax accumulator (the flash-attention recurrence, as the JAX
package's ``lax.scan``), so the [S, S] score matrix is never
materialized.  It is plain PyTorch on every device: the JAX package has
no Pallas kernel for it, and the port keeps the recurrence (scores and
accumulators in f32 whatever the input dtype, every KV block computed,
causal or not) rather than a library's fused attention.

Decode (one new token against a cache of capacity S_max) writes the new
K/V (or latent) row into the cache **in place** and reads the whole
capacity under a position mask.  The write clamps its position to
S_max - 1, as JAX's ``dynamic_update_slice`` clamps its start, so at
``cache_len >= S_max`` the new row lands in the last slot and the mask
admits every position; RoPE still takes the unclamped ``cache_len``.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch
import torch.nn.functional as F
from repro_torch.dtensor_ops import (merge_heads, per_head, split_dim,
                                     write_at, zero_pad)
from repro_torch.models.common import (Params, apply_rope, dense_init,
                                       norm_init, rms_norm)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    # MLA (attn_type == "mla")
    attn_type: str = "gqa"            # "gqa" | "mla"
    q_lora_rank: int = 0              # 0 = full-rank q projection
    kv_lora_rank: int = 0
    rope_head_dim: int = 0            # decoupled rope dims (MLA)
    block_q: int = 512
    block_kv: int = 1024
    # kv replication factor: full-seq paths repeat kv heads so that the
    # head axis divides the TP degree exactly (Megatron kv replication)
    kv_repeat: int = 1


# ======================================================================
# Blockwise (flash-style) attention core
# ======================================================================
def _flash_block_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, q_offset: int, block_kv: int
                      ) -> torch.Tensor:
    """Online-softmax attention.

    q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D]; returns [B, Hq, Sq, D] in
    q's dtype.  Group-query: Hq is a multiple of Hkv; q is viewed as
    [B, Hkv, G, Sq, D] so each KV head serves G query heads.  Masked
    scores are -inf; ``m_safe`` guards rows masked so far, and the
    padded tail of the last block is masked by ``kv_pos < Skv``.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    q32 = q.reshape(b, hkv, g * sq, d).float()
    scale = _inv_sqrt_f32(d)

    n_blocks = -(-skv // block_kv)
    pad = n_blocks * block_kv - skv
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))

    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for i in range(n_blocks):
        sl = slice(i * block_kv, (i + 1) * block_kv)
        k_i, v_i = k[:, :, sl].float(), v[:, :, sl].float()
        kv_pos = i * block_kv + torch.arange(block_kv, device=dev)
        s = (q32 @ k_i.transpose(-1, -2)).view(b, hkv, g, sq, block_kv) \
            * scale
        mask = kv_pos[None, :] <= q_pos[:, None] if causal else \
            torch.ones((sq, block_kv), dtype=torch.bool, device=dev)
        mask = mask & (kv_pos < skv)[None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = p.view(b, hkv, g * sq, block_kv) @ v_i
        acc = acc * alpha[..., None] + pv.view(b, hkv, g, sq, d)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, q_offset=0, block_kv=1024):
    """The block scan; DTensor inputs run it on each rank's batch rows
    and, where the kv heads divide over a mesh dim as the query heads
    do, its heads (``per_head``)."""
    return per_head(partial(_flash_block_scan, causal=causal,
                            q_offset=q_offset, block_kv=block_kv),
                    q, (q, (0, 1)), (k, (0, 1)), (v, (0, 1)))


def _inv_sqrt_f32(n: int) -> float:
    """``1 / sqrt(n)`` rounded as JAX's f32 arithmetic rounds it: the
    square root in f32, then the reciprocal in f32."""
    return (1.0 / torch.sqrt(torch.tensor(float(n)))).item()


def _write_row(cache: torch.Tensor, row: torch.Tensor,
               cache_len: torch.Tensor, dim: int) -> None:
    """Write ``row`` (size 1 along ``dim``) into ``cache`` in place at
    ``cache_len`` clamped to the capacity's last slot, as JAX's
    ``dynamic_update_slice_in_dim`` clamps its start."""
    at = torch.clamp(cache_len.reshape(1).long(), 0, cache.shape[dim] - 1)
    write_at(cache, row, at, dim)


# ======================================================================
# GQA
# ======================================================================
def gqa_init(gen: torch.Generator, cfg: AttnConfig) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, d, cfg.n_heads * hd),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wo": dense_init(gen, cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, gen.device)
        p["k_norm"] = norm_init(hd, gen.device)
    return p


def _project_qkv(params: Params, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    hd = cfg.head_dim
    q = split_dim(x @ params["wq"].to(x.dtype), -1, cfg.n_heads, hd)
    k = split_dim(x @ params["wk"].to(x.dtype), -1, cfg.n_kv_heads, hd)
    v = split_dim(x @ params["wv"].to(x.dtype), -1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"])
        k = rms_norm(k, params["k_norm"]["scale"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _replicate_kv(cfg: AttnConfig, k: torch.Tensor, v: torch.Tensor):
    """Repeat kv heads so the head axis divides TP exactly (Megatron kv
    replication).  GQA math is unchanged."""
    if cfg.kv_repeat > 1:
        k = torch.repeat_interleave(k, cfg.kv_repeat, dim=2)
        v = torch.repeat_interleave(v, cfg.kv_repeat, dim=2)
    return k, v


def _positions(s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)


def gqa_apply(params: Params, cfg: AttnConfig, x: torch.Tensor,
              positions: "torch.Tensor | None" = None) -> torch.Tensor:
    """Full-sequence (train / prefill) GQA."""
    return gqa_prefill(params, cfg, x, positions)[0]


def gqa_prefill(params: Params, cfg: AttnConfig, x: torch.Tensor,
                positions: "torch.Tensor | None" = None):
    """Returns (attn_out, (k_cache, v_cache)) with caches [B, Hkv, S, D]
    (the real heads, not the replicated ones)."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(s, x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    kr, vr = _replicate_kv(cfg, k, v)
    out = flash_attention(q.transpose(1, 2), kr.transpose(1, 2),
                          vr.transpose(1, 2), causal=cfg.causal,
                          block_kv=cfg.block_kv)
    out = merge_heads(out.transpose(1, 2))
    return out @ params["wo"].to(x.dtype), (k.transpose(1, 2),
                                            v.transpose(1, 2))


def _gqa_decode_core(qg, kc, vc, valid):
    """Scores of [B, Hkv, G, D] queries against the whole cache, masked
    past ``valid``, softmax and the weighted V, in f32."""
    hd = qg.shape[-1]
    scores = (qg.float() @ kc.float().transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(valid, scores, -math.inf)
    w = torch.softmax(scores, dim=-1)
    return w @ vc.float()                            # [B, Hkv, G, D]


def gqa_decode(params: Params, cfg: AttnConfig, x: torch.Tensor,
               cache: "tuple[torch.Tensor, torch.Tensor]",
               cache_len: torch.Tensor):
    """One-token decode.  x: [B, 1, D_model]; cache [B, Hkv, S_max, D],
    written in place at ``cache_len`` (see the module docstring).
    Returns (out [B, 1, D_model], cache)."""
    b = x.shape[0]
    hd = cfg.head_dim
    positions = cache_len.reshape(1).to(torch.int32)
    q, k, v = _project_qkv(params, cfg, x, positions)
    kc, vc = cache
    _write_row(kc, k.transpose(1, 2), cache_len, 2)
    _write_row(vc, v.transpose(1, 2), cache_len, 2)
    s_max = kc.shape[2]
    g = cfg.n_heads // cfg.n_kv_heads
    qg = split_dim(q[:, 0], 1, cfg.n_kv_heads, g)   # [B, Hkv, G, D]
    valid = torch.arange(s_max, device=x.device) <= cache_len
    out = per_head(_gqa_decode_core, qg, (qg, (0, 1)), (kc, (0, 1)),
                   (vc, (0, 1)), (valid, (None, None)))
    out = out.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
    return out @ params["wo"].to(x.dtype), (kc, vc)


# ======================================================================
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2)
# ======================================================================
def mla_init(gen: torch.Generator, cfg: AttnConfig) -> Params:
    d, hd, r = cfg.d_model, cfg.head_dim, cfg.rope_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        # q: d -> q_lora -> heads*(nope+rope)
        "wq_a": dense_init(gen, d, qr),
        "q_a_norm": norm_init(qr, gen.device),
        "wq_b": dense_init(gen, qr, cfg.n_heads * (hd + r)),
        # kv: d -> kv_lora (+ shared k_rope)
        "wkv_a": dense_init(gen, d, kvr + r),
        "kv_a_norm": norm_init(kvr, gen.device),
        # up-projections from the latent
        "wk_b": dense_init(gen, kvr, cfg.n_heads * hd),
        "wv_b": dense_init(gen, kvr, cfg.n_heads * hd),
        "wo": dense_init(gen, cfg.n_heads * hd, d),
    }


def _mla_qkv_full(params: Params, cfg: AttnConfig, x: torch.Tensor,
                  positions: torch.Tensor):
    b, s, _ = x.shape
    hd, r, kvr = cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    qa = rms_norm(x @ params["wq_a"].to(x.dtype),
                  params["q_a_norm"]["scale"])
    q = split_dim(qa @ params["wq_b"].to(x.dtype), -1, cfg.n_heads, hd + r)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ params["wkv_a"].to(x.dtype)                      # [B,S,kvr+r]
    c_kv = rms_norm(kv[..., :kvr], params["kv_a_norm"]["scale"])
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)                        # [B,S,1,r]
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(params: Params, cfg: AttnConfig, x: torch.Tensor,
              positions: "torch.Tensor | None" = None) -> torch.Tensor:
    """Full-sequence MLA: expand the latent to per-head K/V, then the
    block scan over heads of hd + r (v zero-padded to that width)."""
    b, s, _ = x.shape
    hd, r = cfg.head_dim, cfg.rope_head_dim
    if positions is None:
        positions = _positions(s, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_full(params, cfg, x, positions)
    k_nope = split_dim(c_kv @ params["wk_b"].to(x.dtype), -1, cfg.n_heads, hd)
    v = split_dim(c_kv @ params["wv_b"].to(x.dtype), -1, cfg.n_heads, hd)
    # fold the decoupled rope part into the head dim (shared k_rope per head)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, cfg.n_heads, r)], dim=-1)
    v_pad = zero_pad(v, -1, 0, r)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v_pad.transpose(1, 2), causal=cfg.causal,
                          block_kv=cfg.block_kv)
    out = merge_heads(out.transpose(1, 2)[..., :hd])
    return out @ params["wo"].to(x.dtype)


def mla_prefill(params: Params, cfg: AttnConfig, x: torch.Tensor,
                positions: "torch.Tensor | None" = None):
    """Cache only the latent (c_kv) + shared rope key — MLA's memory win.
    The projections run twice (once inside ``mla_apply``), as in JAX."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(s, x.device)
    out = mla_apply(params, cfg, x, positions)
    _, _, c_kv, k_rope = _mla_qkv_full(params, cfg, x, positions)
    return out, (c_kv, k_rope[:, :, 0, :])


def _mla_decode_core(q_nope_h, q_rope_h, c_cache, r_cache, wk_b, wv_b,
                     valid, *, scale, hd, absorb):
    """MLA's scores, softmax and output for [B, H, *] queries against
    the latent cache, in f32 (see ``mla_decode``)."""
    h = q_nope_h.shape[1]
    kvr = c_cache.shape[-1]
    c32, r32 = c_cache.float(), r_cache.float()
    s_rope = q_rope_h @ r32.transpose(1, 2)        # [B, H, S]
    if absorb:
        wk = wk_b.float().reshape(kvr, h, hd)
        q_lat = torch.einsum("bhd,khd->bhk", q_nope_h, wk)    # [B,H,kvr]
        s_lat = q_lat @ c32.transpose(1, 2)                   # [B,H,S]
        scores = (s_lat + s_rope) * scale
        scores = torch.where(valid, scores, -math.inf)
        w = torch.softmax(scores, dim=-1)
        ctx_lat = w @ c32                                     # [B,H,kvr]
        wv = wv_b.float().reshape(kvr, h, hd)
        return torch.einsum("bhk,khd->bhd", ctx_lat, wv)
    k_nope = (c32 @ wk_b.float()).unflatten(-1, (h, hd))
    v_full = (c32 @ wv_b.float()).unflatten(-1, (h, hd))
    s_nope = torch.einsum("bhd,bshd->bhs", q_nope_h, k_nope)
    scores = (s_nope + s_rope) * scale
    scores = torch.where(valid, scores, -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", w, v_full)


def mla_decode(params: Params, cfg: AttnConfig, x: torch.Tensor,
               cache: "tuple[torch.Tensor, torch.Tensor]",
               cache_len: torch.Tensor, absorb: bool = False):
    """One-token MLA decode against the latent cache (c_kv [B,S,kvr],
    k_rope [B,S,r]), both written in place at ``cache_len``.

    absorb=False (baseline): expand the latent to per-head K/V each step.
    absorb=True: score and accumulate in latent space (the W_UK/W_UV
    absorption); O(S*kvr) instead of O(S*H*hd) bytes.
    """
    b = x.shape[0]
    hd, r = cfg.head_dim, cfg.rope_head_dim
    h = cfg.n_heads
    positions = cache_len.reshape(1).to(torch.int32)
    q_nope, q_rope, c_new, k_rope_new = _mla_qkv_full(params, cfg, x,
                                                      positions)
    c_cache, r_cache = cache
    _write_row(c_cache, c_new, cache_len, 1)
    _write_row(r_cache, k_rope_new[:, :, 0, :], cache_len, 1)
    s_max = c_cache.shape[1]
    valid = torch.arange(s_max, device=x.device) <= cache_len

    q_nope_h = q_nope[:, 0].float()               # [B, H, hd]
    q_rope_h = q_rope[:, 0].float()               # [B, H, r]
    core = partial(_mla_decode_core, scale=_inv_sqrt_f32(hd + r), hd=hd,
                   absorb=absorb)
    out = per_head(core, q_nope_h, (q_nope_h, (0, 1)), (q_rope_h, (0, 1)),
                   (c_cache, (0, None)), (r_cache, (0, None)),
                   (params["wk_b"], (None, 1)), (params["wv_b"], (None, 1)),
                   (valid, (None, None)))
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return out @ params["wo"].to(x.dtype), (c_cache, r_cache)
