"""Language-model assembly — the ``ssm`` family (Mamba2) of
``src/repro/models/lm.py``.

Public entry points (the JAX package's, without its runtime config,
which only carries mesh and remat hooks):
  init_model(seed, arch, policy, device)          -> params
  forward(params, arch, batch, policy)            -> (logits, aux)
  make_cache(arch, seq_len, batch, policy, device) -> decode cache
  prefill(params, arch, batch, cache_len, policy) -> (logits, cache)
  decode_step(params, arch, cache, tokens, policy) -> (logits, cache)

Layers are stacked on a leading [L, ...] axis, as in the JAX params
pytree, and a Python loop over ``l`` indexes them.  Every other family
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import (DTypePolicy, Params, dense_init,
                                       norm_init, rms_norm, tree_map,
                                       truncated_normal_init)
from repro_torch.models.ssm import (SSMConfig, mamba2_apply, mamba2_decode,
                                    mamba2_init)

def _require_ssm(arch: ArchConfig) -> None:
    if arch.family != "ssm":
        raise NotImplementedError(
            f"{arch.name}: family {arch.family!r} is not ported yet; it "
            "waits for ROADMAP A9 (attention, MLP and MoE modules)")


def ssm_config(arch: ArchConfig) -> SSMConfig:
    return SSMConfig(
        d_model=arch.d_model, d_state=arch.ssm_state,
        head_dim=arch.ssm_head_dim, expand=arch.ssm_expand,
        chunk=arch.ssm_chunk,
    )


def _ssm_layer_init(gen: torch.Generator, arch: ArchConfig) -> Params:
    return {"mamba": mamba2_init(gen, ssm_config(arch)),
            "ln": norm_init(arch.d_model, gen.device)}


def _layer(blocks: Params, l: int) -> Params:
    """Layer ``l`` of the stacked block params."""
    return tree_map(lambda t: t[l], blocks)


def init_model(seed: int, arch: ArchConfig,
               policy: DTypePolicy | None = None,
               device: "str | torch.device | None" = None) -> Params:
    """Random params from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the CUDA device when None), with the JAX initializer's
    distributions and pytree layout (not its values: carry JAX params
    across with ``convert.params_from_numpy``)."""
    _require_ssm(arch)
    policy = policy or DTypePolicy.standard()
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d = arch.d_model
    params: Params = {
        "embed": truncated_normal_init(gen, (arch.padded_vocab, d), 1.0),
        "final_norm": norm_init(d, gen.device),
    }
    if not arch.tie_embeddings:
        params["head"] = dense_init(gen, d, arch.padded_vocab)
    layers = [_ssm_layer_init(gen, arch) for _ in range(arch.n_layers)]
    params["blocks"] = _stack(layers)
    return tree_map(lambda t: t.to(policy.params)
                    if t.dtype == torch.float32 else t, params)


def _stack(trees: "list[Params]") -> Params:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _cast_blocks(blocks: Params, dtype: torch.dtype) -> Params:
    """Stacked f32 weights of two or more dims (every stacked leaf) to
    the compute dtype, as the JAX forward does once before its layer
    scan."""
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
    (logits [B, S, V], aux loss 0)."""
    _require_ssm(arch)
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    h = embed_tokens(params, arch, batch["tokens"], cd)
    blocks = _cast_blocks(params["blocks"], cd)
    scfg = ssm_config(arch)
    for l in range(arch.n_layers):
        bp = _layer(blocks, l)
        x = rms_norm(h, bp["ln"]["scale"])
        h = h + mamba2_apply(bp["mamba"], scfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, h, cd), aux


def make_cache(arch: ArchConfig, seq_len: int, batch: int,
               policy: DTypePolicy | None = None,
               device: "str | torch.device | None" = None) -> Params:
    """The decode cache of the ssm family: the SSM state per layer (f32)
    and the last W-1 pre-conv projections per layer (compute dtype).
    ``seq_len`` is the capacity; the family keeps no per-position
    state."""
    _require_ssm(arch)
    policy = policy or DTypePolicy.standard()
    dev = resolve_device(device)
    scfg = ssm_config(arch)
    L, B = arch.n_layers, batch
    return {
        "len": torch.zeros((), dtype=torch.int32, device=dev),
        "ssm_h": torch.zeros((L, B, scfg.n_heads, scfg.head_dim,
                              scfg.d_state), dtype=torch.float32,
                             device=dev),
        "ssm_conv": torch.zeros((L, B, scfg.conv_width - 1,
                                 scfg.conv_channels), dtype=policy.compute,
                                device=dev),
    }


def prefill(params: Params, arch: ArchConfig,
            batch: "dict[str, torch.Tensor]", cache_len: int,
            policy: DTypePolicy | None = None
            ) -> "tuple[torch.Tensor, Params]":
    """Run the full-sequence forward and fill a decode cache of capacity
    ``cache_len`` (>= prompt length).  Returns (logits of the last
    position [B, 1, V], cache)."""
    _require_ssm(arch)
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = make_cache(arch, cache_len, b, policy, tokens.device)
    h = embed_tokens(params, arch, tokens, cd)
    scfg = ssm_config(arch)
    for l in range(arch.n_layers):
        bp = _layer(params["blocks"], l)
        xn = rms_norm(h, bp["ln"]["scale"])
        o, (hf, conv_tail) = mamba2_apply(bp["mamba"], scfg, xn,
                                          return_state=True)
        h = h + o
        cache["ssm_h"][l] = hf
        cache["ssm_conv"][l] = conv_tail.to(cd)
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return _logits(params, h[:, -1:, :], cd), cache


def decode_step(params: Params, arch: ArchConfig, cache: Params,
                tokens: torch.Tensor, policy: DTypePolicy | None = None
                ) -> "tuple[torch.Tensor, Params]":
    """One decode step.  tokens: [B, 1] new token ids.  Returns (logits
    [B, 1, V], a new cache with ``len`` one higher)."""
    _require_ssm(arch)
    policy = policy or DTypePolicy.standard()
    cd = policy.compute
    h = embed_tokens(params, arch, tokens, cd)
    scfg = ssm_config(arch)
    hs, convs = [], []
    for l in range(arch.n_layers):
        bp = _layer(params["blocks"], l)
        xn = rms_norm(h, bp["ln"]["scale"])
        o, (hc, cc) = mamba2_decode(bp["mamba"], scfg, xn,
                                    (cache["ssm_h"][l], cache["ssm_conv"][l]))
        h = h + o
        hs.append(hc)
        convs.append(cc)
    cache = {**cache, "ssm_h": torch.stack(hs), "ssm_conv": torch.stack(convs),
             "len": cache["len"] + 1}
    return _logits(params, h, cd), cache
