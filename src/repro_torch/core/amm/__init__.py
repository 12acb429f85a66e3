"""Algorithmic multi-port memory design specifications."""
from __future__ import annotations

from repro_torch.core.amm.spec import AMM_KINDS, AMMSpec

__all__ = ["AMMSpec", "AMM_KINDS"]
