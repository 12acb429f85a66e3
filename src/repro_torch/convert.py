"""Carry the JAX package's state across: numpy arrays (as
``np.asarray`` gives them from JAX arrays) to the port's tensors.

``torch.from_numpy`` refuses ml_dtypes' ``bfloat16``; such arrays go
through their ``uint16`` bits, an ``int16`` tensor and a bit view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.memory.kv_cache import BankedKVCache


def tensor_from_numpy(a: np.ndarray,
                      device: "str | torch.device | None" = None
                      ) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (the CUDA device when None)."""
    device = resolve_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def banked_kv_cache_from_numpy(k: np.ndarray, v: np.ndarray,
                               length: np.ndarray, n_banks: int,
                               device: "str | torch.device | None" = None
                               ) -> BankedKVCache:
    """The fields of a JAX ``BankedKVCache`` as the port's cache."""
    return BankedKVCache(k=tensor_from_numpy(k, device),
                         v=tensor_from_numpy(v, device),
                         length=tensor_from_numpy(
                             np.asarray(length, np.int32), device),
                         n_banks=int(n_banks))


def params_from_numpy(tree: dict,
                      device: "str | torch.device | None" = None) -> dict:
    """A nested dict of numpy arrays (a JAX params pytree after
    ``jax.tree.map(np.asarray, ...)``) as the port's params: the same
    keys, stacked layers kept on their leading [L, ...] axis."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else tensor_from_numpy(np.asarray(v), device)
            for k, v in tree.items()}
