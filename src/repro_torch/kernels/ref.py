"""Dense PyTorch oracles for the kernels (tests compare kernel and
plain versions against them across shape and dtype sweeps)."""
from __future__ import annotations

import torch

from repro_torch.core.amm.replay import init_flat, replay_batched
from repro_torch.core.amm.spec import AMMSpec


def amm_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: [V, D]; idx: [N] -> [N, D]."""
    return table[idx.long()]


def amm_gather_replay_ref(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Replay-backed oracle for ``amm_gather``: the gather is an op trace
    on the H-NTX-Rd *functional model* (``repro_torch.core.amm.replay``),
    one AMM instance per payload column on the batch axis, all replaying
    the same request stream, on the table's device.

    Requests are paired two per cycle (the kernel's 2 read ports): even
    slots decode through the direct path, odd slots through the
    XOR-reconstruction (parity) path, exactly like the kernel's
    conflict-free second port.  table: [V, D] of 2- or 4-byte words (the
    bits are what is gathered); idx: [N] -> [N, D].
    """
    v, d = table.shape
    size = table.element_size()
    if size == 4:
        cols = table.view(torch.int32)
    elif size == 2:
        cols = table.view(torch.int16).to(torch.int32) & 0xFFFF
    else:
        raise ValueError(f"no word type for {table.dtype}")
    spec = AMMSpec("h_ntx_rd", n_read=2, n_write=1, depth=v)
    dev = table.device
    states = init_flat(spec, cols.T, dev)                 # [D, 3, V / 2]

    n = idx.shape[0]
    padded = torch.cat([idx.long(), torch.zeros(n % 2, dtype=torch.int64,
                                                device=dev)])
    cycles = padded.shape[0] // 2
    ra = padded.view(cycles, 2)
    wa = torch.zeros((cycles, 1), dtype=torch.int64, device=dev)
    wv = torch.zeros((cycles, 1), dtype=torch.int32, device=dev)
    wm = torch.zeros((cycles, 1), dtype=torch.bool, device=dev)
    _, result = replay_batched(spec, states, ra, wa, wv, wm,
                               share_trace=True, device=dev)

    # [D, T, 2]: keep direct reads from even slots, parity from odd slots
    slots = torch.stack([result.read_vals[..., 0],
                         result.parity_vals[..., 1]], dim=-1)
    flat = slots.reshape(d, cycles * 2)[:, :n].T.contiguous()   # [N, D]
    if size == 2:
        flat = torch.where(flat >= 1 << 15, flat - (1 << 16),
                           flat).to(torch.int16)
    return flat.view(table.dtype)


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


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, h_in: torch.Tensor
                  ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Same contract as ``ssd_scan.ssd_chunk_step``, dense einsums in
    f32 (no rounding of y or h_out through the inputs' dtypes)."""
    x, dt, cum = x.float(), dt.float(), cum.float()
    B, C, h_in = B.float(), C.float(), h_in.float()
    pos = torch.arange(cum.shape[-1], device=cum.device)
    la = torch.where(pos[:, None] >= pos[None, :],
                     cum[..., :, None] - cum[..., None, :], -1e30)
    decay = torch.exp(la)                                      # [b,h,i,j]
    scores = torch.einsum("bin,bjn->bij", C, B)[:, None] * decay
    y = torch.einsum("bhij,bhj,bhjp->bhip", scores, dt, x)
    y = y + torch.einsum("bin,bhi,bhpn->bhip", C, torch.exp(cum), h_in)
    tail = torch.exp(cum[..., -1:] - cum) * dt                 # [b,h,q]
    h_out = torch.exp(cum[..., -1])[..., None, None] * h_in + torch.einsum(
        "bhj,bhjp,bjn->bhpn", tail, x, B)
    return y, h_out
