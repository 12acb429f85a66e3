"""Public wrappers around the kernels (``cycle_lanes``, the batched
timing backend's lane loop, is its own wrapper: see ``cycle_lanes.py``).

Dispatch is by the tensor's device only: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the kernel's plain
PyTorch version.  There is no mode switch and no fallback.

``ssd_chunk`` is differentiable on both devices (``ssd_scan.SSDChunk``:
the kernel's forward, the plain version's backward).  ``amm_gather``
and ``kv_decode`` serve and have no backward: on CUDA, an input that
would carry a gradient raises rather than being cut off.

Under DTensor (a sharded program, ``launch/sharding.py``) a kernel takes
raw pointers, so no DTensor may reach it.  ``ssd_chunk`` runs through
``local_map`` (``dtensor_ops.per_head``): the chunk is independent per batch row and per head, so
a ``Shard`` on Bt or on H stays local (B and C, shared across heads,
are then replicated over the head-sharding mesh dims), and any other
placement is first redistributed to one of those; ``SSDChunk``'s
autograd rule holds through the map.  ``amm_gather`` and ``kv_decode``
are not on a sharded path, and raise on DTensor inputs.
"""
from __future__ import annotations

import torch

from repro_torch.dtensor_ops import no_dtensor, per_head
from repro_torch.kernels import _build
from repro_torch.kernels.amm_gather import amm_gather_u32
from repro_torch.kernels.banked_kv_decode import banked_kv_decode
from repro_torch.kernels.cycle_lanes import cycle_lanes  # noqa: F401
from repro_torch.kernels.ssd_scan import SSDChunk, ssd_chunk_step_plain

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
    no_dtensor("amm_gather", table, idx)
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
    no_dtensor("kv_decode", q, k, v, lengths)
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
    Differentiable in all six inputs (``SSDChunk``).  DTensor inputs
    run through ``local_map`` (see the module docstring); a plain tensor
    among them counts as replicated."""
    return per_head(_ssd_local, x, (x, (0, 1)), (dt, (0, 1)), (cum, (0, 1)),
                    (B, (0, None)), (C, (0, None)), (h_in, (0, 1)),
                    outputs=2)


def _ssd_local(x, dt, cum, B, C, h_in):
    ins = tuple(t.contiguous() for t in (x, dt, cum, B, C, h_in))
    if all(t.is_meta for t in ins):
        # a dry run's shapes and nothing else (launch/dryrun.py): the
        # plain version's ops, which the run's counters count
        return ssd_chunk_step_plain(*ins)
    return SSDChunk.apply(*ins)
