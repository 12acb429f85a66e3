"""Banked KV cache: the AMM plan applied to decode attention.

The cache for one layer is [B, Hkv, S, D]; the plan's bank count
partitions S into independent banks.  ``decode_read`` is the multi-port
read burst of a decode step, served by the banked flash-decode kernel.
Unlike the JAX reference, whose arrays are immutable, ``append`` writes
the cache in place: a decode step would otherwise copy the whole cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import kv_decode
from repro_torch.memory.planner import StreamPlan


@dataclasses.dataclass
class BankedKVCache:
    k: torch.Tensor          # [B, Hkv, S, D]
    v: torch.Tensor
    length: torch.Tensor     # [B] int32 current lengths
    n_banks: int = 8

    @classmethod
    def create(cls, batch: int, n_kv_heads: int, max_len: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               plan: StreamPlan | None = None,
               device: "str | torch.device | None" = None
               ) -> "BankedKVCache":
        """An empty cache on ``device`` (the CUDA device when None; it
        raises when there is none)."""
        device = resolve_device(device)
        nb = plan.n_banks if (plan and plan.use_amm) else 8
        if nb <= 0:
            raise ValueError(f"plan.n_banks must be positive, got {nb}")
        nb = min(nb, max_len)
        # the kernel needs S divisible by the bank count: round down to
        # the largest divisor of max_len <= nb (a plain halving loop
        # collapses any non-power-of-two request, e.g. 6 banks over
        # S=64, all the way to a single bank)
        while max_len % nb:
            nb -= 1
        shape = (batch, n_kv_heads, max_len, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
            n_banks=nb,
        )

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor
               ) -> "BankedKVCache":
        """k/v_new: [B, Hkv, 1, D] written at each row's *own* current
        length — mixed-length batches place each row's token
        independently.  Writes k, v and length **in place** and returns
        this cache.

        Full-row contract: a row at capacity (``length == max_len``)
        drops the append — its k/v stay untouched and its length stays
        clamped at ``max_len``.  Torch indexing would raise on (or wrap)
        the out-of-range position, so full rows rewrite their last slot
        with its own contents instead."""
        b, _, max_len, _ = self.k.shape
        rows = torch.arange(b, device=self.k.device)
        pos = torch.clamp(self.length, max=max_len - 1).long()
        full = (self.length >= max_len)[:, None, None]
        for cache, new in ((self.k, k_new), (self.v, v_new)):
            cache[rows, :, pos] = torch.where(
                full, cache[rows, :, pos], new[:, :, 0].to(cache.dtype))
        self.length.copy_(torch.clamp(self.length + 1, max=max_len))
        return self

    def decode_read(self, q: torch.Tensor) -> torch.Tensor:
        """q: [B, Hq, D] -> attention output [B, Hq, D] via the banked
        flash-decode kernel."""
        return kv_decode(q, self.k, self.v, self.length,
                         n_banks=self.n_banks)
