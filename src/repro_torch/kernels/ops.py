"""Public wrappers around the kernels (``cycle_lanes``, the batched
timing backend's lane loop, is its own wrapper: see ``cycle_lanes.py``).

Dispatch is by the tensor's device only: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the kernel's plain
PyTorch version.  There is no mode switch and no fallback.

``ssd_chunk`` is differentiable on both devices (``ssd_scan.SSDChunk``:
the kernel's forward, the plain version's backward).  ``amm_gather``
and ``kv_decode`` serve and have no backward: on CUDA, an input that
would carry a gradient raises rather than being cut off.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.amm_gather import amm_gather_u32
from repro_torch.kernels.banked_kv_decode import banked_kv_decode
from repro_torch.kernels.cycle_lanes import cycle_lanes  # noqa: F401
from repro_torch.kernels.ssd_scan import SSDChunk

_WORD_FOR = {2: torch.int16, 4: torch.int32}


def _no_backward(what: str, *tensors: torch.Tensor) -> None:
    """Raise on CUDA when grad mode is on and an input requires grad:
    the kernel has no backward, and its output would silently carry
    none."""
    if (_build.dispatch(*tensors) == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise RuntimeError(
            f"{what} has no backward on CUDA: its kernel writes outputs "
            "that carry no gradient; call it under torch.no_grad() or on "
            "tensors that do not require grad")


def pack_amm_banks(table: torch.Tensor, n_banks: int
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Depth-partition [V, D] into XOR banks [NB, V/NB, D] + parity, as
    int16/int32 bit patterns of the table's 2- or 4-byte elements."""
    v, d = table.shape
    if v % n_banks:
        raise ValueError(f"table depth {v} does not divide into {n_banks} "
                         "banks")
    word = _WORD_FOR.get(table.element_size())
    if word is None:
        raise ValueError(f"no XOR word for dtype {table.dtype}")
    banks = table.contiguous().view(word).reshape(n_banks, v // n_banks, d)
    parity = banks[0].clone()
    for j in range(1, n_banks):
        parity ^= banks[j]
    return banks, parity


def amm_gather(table: torch.Tensor, idx: torch.Tensor, n_banks: int = 4
               ) -> torch.Tensor:
    """Conflict-free XOR-banked gather.  table: [V, D]; idx: [N] with
    ``0 <= idx < V`` -> [N, D] in the table's dtype.  No backward: on
    CUDA a ``table`` that requires grad raises under grad mode."""
    _no_backward("amm_gather", table, idx)
    banks, parity = pack_amm_banks(table, n_banks)
    out = amm_gather_u32(banks, parity, idx.to(torch.int32).contiguous())
    return out.view(table.dtype)


def kv_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor, n_banks: int = 8) -> torch.Tensor:
    """Flash-decode over a bank-partitioned KV cache.
    q: [B, Hq, D]; k/v: [B, Hkv, S, D]; lengths: [B] (per-row valid
    sequence lengths; rows with length 0 decode to zeros).  No backward:
    on CUDA an input that requires grad raises under grad mode."""
    _no_backward("kv_decode", q, k, v, lengths)
    b, hkv, s, d = k.shape
    if s % n_banks:
        raise ValueError(f"cache length {s} does not divide into {n_banks} "
                         "banks")
    kb = k.reshape(b, hkv, n_banks, s // n_banks, d)
    vb = v.reshape(b, hkv, n_banks, s // n_banks, d)
    return banked_kv_decode(q, kb, vb, lengths.to(torch.int32))


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, h_in: torch.Tensor
              ) -> "tuple[torch.Tensor, torch.Tensor]":
    """One SSD chunk step (see ssd_scan.py for the contract).
    x: [Bt, H, Q, P]; dt/cum: [Bt, H, Q]; B/C: [Bt, Q, N];
    h_in: [Bt, H, P, N] -> (y [Bt, H, Q, P], h_out [Bt, H, P, N]), f32.
    Differentiable in all six inputs (``SSDChunk``)."""
    return SSDChunk.apply(*(t.contiguous() for t in (x, dt, cum, B, C,
                                                     h_in)))

