"""Carry the JAX package's state across: numpy arrays (as
``np.asarray`` gives them from JAX arrays) to the port's tensors.

``torch.from_numpy`` refuses ml_dtypes' ``bfloat16``; such arrays go
through their ``uint16`` bits, an ``int16`` tensor and a bit view.  The
AMM replay's ``uint32`` words go through a bit view to ``int32``
(:func:`flat_state_from_numpy`, :func:`fault_mask_from_numpy`), and come
back through the same view (:func:`words_to_numpy`,
:func:`flat_state_to_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.amm.replay import (STEERING_KEYS, FaultMask,
                                         FlatState, words)
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


def flat_state_from_numpy(flat: dict,
                          device: "str | torch.device | None" = None
                          ) -> FlatState:
    """A JAX ``FlatState`` (after ``np.asarray`` of each array) as the
    port's: ``uint32`` words as int32 bits, int32 tables as they are.
    A leading batch axis, if any, stays."""
    dev = resolve_device(device)
    return {k: words(v, dev) if v.dtype == np.uint32
            else tensor_from_numpy(v, dev) for k, v in flat.items()}


def fault_mask_from_numpy(fm, device: "str | torch.device | None" = None
                          ) -> FaultMask:
    """A JAX ``FaultMask`` (after ``np.asarray`` of each array) as the
    port's."""
    dev = resolve_device(device)
    return FaultMask(tensor_from_numpy(np.asarray(fm.cycle, np.int32), dev),
                     *(flat_state_from_numpy(d, dev) for d in fm[1:]))


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word bits back to numpy ``uint32`` (the same view)."""
    return t.detach().cpu().numpy().view(np.uint32)


def flat_state_to_numpy(flat: FlatState) -> dict:
    """The port's flat state in the JAX package's dtypes: words as
    ``uint32``, the steering tables as int32."""
    return {k: v.cpu().numpy() if k in STEERING_KEYS else words_to_numpy(v)
            for k, v in flat.items()}
