"""Weinberg spatial-locality metric (paper eq. 1): a numpy form and a
PyTorch form that computes on the device (they agree to rounding).

    L_spatial = sum_{stride=1..inf} P(stride) / stride

where *stride* is the difference between consecutive addresses of a
load/store stream (Weinberg et al., SC'05).  Negative strides count
with their magnitude; stride 0 (the same address again) is temporal,
not spatial, locality and contributes nothing, but still counts as a
transition.  The planner scores its streams with it, and
``trace_locality`` gives each benchmark trace its Fig-5 scalar.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def spatial_locality_np(addrs_bytes: np.ndarray) -> float:
    """Weinberg L_spatial over a dynamic byte-address reference stream."""
    a = np.asarray(addrs_bytes, dtype=np.int64)
    if a.size < 2:
        return 0.0
    strides = np.abs(np.diff(a))
    strides = strides[strides > 0]
    if strides.size == 0:
        return 0.0
    # P(stride)/stride summed over the empirical distribution ==
    # mean over references of 1/stride.
    total = np.sum(1.0 / strides.astype(np.float64))
    # Normalize by the number of *transitions* (incl. stride-0 ones), so
    # temporally-repeated references dilute spatial locality as in Weinberg.
    return float(total / (a.size - 1))


def spatial_locality_torch(addrs_bytes, *, device=None) -> float:
    """:func:`spatial_locality_np` computed by PyTorch on a device (the
    counterpart of the JAX package's ``spatial_locality_jax``).

    ``addrs_bytes`` is a tensor, computed on its own device unless
    ``device`` names another, or an array, moved to ``device`` (``None``:
    the CUDA device).  The strides are differences of int64 addresses, so
    addresses above 2**31 keep their exact strides; their reciprocals
    are float64.  Returns a Python float.
    """
    if isinstance(addrs_bytes, torch.Tensor) and device is None:
        dev = addrs_bytes.device
    else:
        dev = resolve_device(device)
    a = torch.as_tensor(addrs_bytes).to(dev, torch.int64).reshape(-1)
    if a.numel() < 2:
        return 0.0
    strides = torch.diff(a).abs()
    contrib = torch.where(strides > 0,
                          1.0 / strides.clamp_min(1).to(torch.float64), 0.0)
    # normalised by the number of transitions, stride-0 ones included
    return float(contrib.sum() / (a.numel() - 1))


def per_array_locality(addrs_bytes: np.ndarray,
                       array_ids: np.ndarray) -> dict[int, float]:
    """L_spatial per logical array, as Aladdin partitions per array."""
    out: dict[int, float] = {}
    for aid in np.unique(array_ids):
        out[int(aid)] = spatial_locality_np(addrs_bytes[array_ids == aid])
    return out


def trace_locality(addrs_bytes: np.ndarray, array_ids: np.ndarray) -> float:
    """Access-weighted mean of per-array localities (the per-benchmark
    scalar plotted in the paper's Fig 5)."""
    ids = np.asarray(array_ids)
    total, weight = 0.0, 0
    for aid in np.unique(ids):
        m = ids == aid
        n = int(m.sum())
        total += spatial_locality_np(np.asarray(addrs_bytes)[m]) * n
        weight += n
    return total / max(weight, 1)
