"""Dense PyTorch oracles for the kernels (tests compare kernel and
plain versions against them across shape and dtype sweeps)."""
from __future__ import annotations

import torch


def amm_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: [V, D]; idx: [N] -> [N, D]."""
    return table[idx.long()]


def kv_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Masked dense reference.  q: [B, Hq, D]; k/v: [B, Hkv, S, D];
    lengths: [B] per-row valid lengths -> [B, Hq, D].

    Positions ``>= lengths[b]`` are excluded from the softmax, so padded
    K/V content never reaches the output; a row of length 0 decodes to
    zeros (softmax over -inf would otherwise be NaN)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) / d ** 0.5
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, None, :] < lengths[:, None, None, None]
    scores = torch.where(valid, scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(
        scores - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    w = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v.float())
    return out.reshape(b, hq, d).to(q.dtype)
