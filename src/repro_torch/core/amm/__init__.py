"""Algorithmic multi-port memories: design specifications and their
functional models.

``make_amm(spec, values, device)`` returns an :class:`AMMSim` wrapping the
design's state machine with a uniform interface:

    sim = make_amm(spec, init_values, device="cpu")
    sim.state, vals = sim.step(sim.state, read_addrs, w_addrs, w_vals, w_mask)
    logical = sim.peek(sim.state)          # full decoded logical array
    state, result = sim.replay(sim.state, ra[T], wa[T], wv[T], wm[T])

Whole traces replay through :mod:`repro_torch.core.amm.replay`, the
flat-state engine that batches design instances on a leading axis
(``init_flat`` / ``replay`` / ``replay_batched`` and the fault-injected
``replay_faulty*``).  Words are ``uint32`` carried as int32 bits.
"""
from __future__ import annotations

from repro_torch.core.amm.sim import AMMSim, make_amm
from repro_torch.core.amm.spec import AMM_KINDS, AMMSpec

__all__ = ["AMMSpec", "AMM_KINDS", "AMMSim", "make_amm"]
