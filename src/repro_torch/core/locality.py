"""Weinberg spatial-locality metric (paper eq. 1), numpy form.

    L_spatial = sum_{stride=1..inf} P(stride) / stride

where *stride* is the difference between consecutive addresses of a
load/store stream (Weinberg et al., SC'05).  Negative strides count
with their magnitude; stride 0 (the same address again) is temporal,
not spatial, locality and contributes nothing, but still counts as a
transition.  The planner scores its streams with it.
"""
from __future__ import annotations

import numpy as np


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
