"""Functional AMM models behind ``make_amm``: one uniform wrapper over
each design's step model and the whole-trace replay engine."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.amm import banked as _banked
from repro_torch.core.amm import lvt as _lvt
from repro_torch.core.amm import ntx as _ntx
from repro_torch.core.amm import replay as _replay
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.device import resolve_device

__all__ = ["AMMSim", "make_amm"]


@dataclasses.dataclass
class AMMSim:
    """Uniform wrapper over one design's state machine.

    Two simulation paths share the same state:

    * per-step — ``state, vals = sim.step(state, ra, wa, wv, wm)`` advances
      one cycle (tensors on the state's device: long addresses, int32
      words, bool masks);
    * whole-trace — ``state, result = sim.replay(state, ra[T], wa[T], wv[T],
      wm[T])`` replays T cycles (:mod:`repro_torch.core.amm.replay`),
      returning direct- and parity-path reads for every cycle.  Both
      paths are pinned equal.
    """

    spec: AMMSpec
    state: Any
    read: Callable
    read_parity: Callable
    step: Callable
    peek: Callable
    replay: Callable
    replay_faulty: Callable


def _make_replay(spec: AMMSpec, device: torch.device) -> Callable:
    """Whole-trace replay operating on the step-path (pytree) state."""
    def run(state, read_addrs, write_addrs, write_vals, write_mask):
        flat = _replay.flatten_state(spec, state)
        flat, result = _replay.replay(spec, flat, read_addrs, write_addrs,
                                      write_vals, write_mask, device)
        return _replay.unflatten_state(spec, flat), result
    return run


def _make_replay_faulty(spec: AMMSpec, device: torch.device) -> Callable:
    """Whole-trace fault-injected replay on the step-path (pytree) state.

    ``fault`` is a :class:`repro_torch.core.amm.replay.FaultMask`; zero
    masks reproduce the clean replay exactly.
    """
    def run(state, fault, read_addrs, write_addrs, write_vals, write_mask):
        flat = _replay.flatten_state(spec, state)
        flat, result = _replay.replay_faulty(
            spec, flat, fault, read_addrs, write_addrs, write_vals,
            write_mask, device)
        return _replay.unflatten_state(spec, flat), result
    return run


def make_amm(spec: AMMSpec, values=None,
             device: "str | torch.device | None" = None) -> AMMSim:
    """The design's simulator holding ``values`` (numpy ``uint32`` or
    int32 bits; zeros if None) on ``device`` (CUDA when None)."""
    dev = resolve_device(device)
    if values is None:
        values = torch.zeros((spec.depth,), dtype=torch.int32, device=dev)
    values = _replay.words(values, dev)
    if tuple(values.shape) != (spec.depth,):
        raise ValueError(f"init values must be [{spec.depth}]")

    run = _make_replay(spec, dev)
    run_faulty = _make_replay_faulty(spec, dev)
    if spec.kind in ("h_ntx_rd", "b_ntx_wr", "hb_ntx"):
        state, fns = _ntx.make_ntx(spec, values)
        return AMMSim(spec, state, fns["read"], fns["read_parity"],
                      fns["step"], fns["peek"], run, run_faulty)
    if spec.kind == "lvt":
        state = _lvt.lvt_init(spec, values)
        return AMMSim(spec, state, _lvt.lvt_read, _lvt.lvt_read,
                      _lvt.lvt_step, _lvt.lvt_peek, run, run_faulty)
    if spec.kind == "remap":
        state = _lvt.remap_init(spec, values)
        return AMMSim(spec, state, _lvt.remap_read, _lvt.remap_read,
                      _lvt.remap_step, _lvt.remap_peek, run, run_faulty)
    if spec.kind in ("ideal", "banked", "multipump"):
        state = _banked.ideal_init(spec, values)
        return AMMSim(spec, state, _banked.ideal_read, _banked.ideal_read,
                      _banked.ideal_step, _banked.ideal_peek, run, run_faulty)
    raise ValueError(f"unknown design kind: {spec.kind}")
