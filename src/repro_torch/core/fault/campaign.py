"""Seeded fault-injection campaigns and the per-design resilience checker.

A campaign replays one seeded op trace through a design twice: once
clean (golden) and once per injected fault (batched over the fault
population with ``replay_faulty_batched``).  Every post-injection read
is then classified against the golden values using *only* the
redundancy the design actually has:

* ``h_ntx_rd`` / ``hb_ntx`` (cover ``parity``) — the replay exposes
  both the direct-path and the XOR-reconstruction-path value per read.
  A single physical fault lives in exactly one leaf, and an address's
  parity path never contains its direct leaf, so at most one of the two
  paths is corrupt: the other reconstructs the golden word (corrected).
  Both-paths-corrupt can only arise from accumulated write-invariant
  damage; disagreeing paths are a detected error, agreeing-but-wrong
  paths are SDC.
* ``lvt`` (cover ``replica``) — the hardware keeps ``n_read`` physical
  replicas of every write bank.  A single fault lands in one replica;
  the other ``n_read - 1`` replicas return the golden value.  With >= 3
  replicas a majority vote corrects; with exactly 2 a mismatch is
  detected but not attributable; with 1 a corrupt read is silent.
* everything else (cover ``none``) — banked/ideal/multipump have a
  single copy, ``remap``'s spare bank holds stale (not redundant) data,
  and ``b_ntx_wr``'s Ref plane is *write-bandwidth* redundancy with no
  disagreement signal on the read path.  Any wrong read is SDC.

The replays run on the device (CUDA unless the caller passes
``device="cpu"``); the draws and the classification are numpy, the same
as the JAX package's, so a campaign reproduces its goldens exactly.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.amm import replay as rp
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.dse.sweep import _spec_for
from repro_torch.core.fault.metrics import (COVER, Resilience,
                                            resilience_fields)
from repro_torch.core.fault.model import (FAULT_KINDS, FaultSpec,
                                          build_masks, sample_faults,
                                          tile_states)
from repro_torch.device import resolve_device

__all__ = ["FaultConfig", "CampaignResult", "campaign_draws",
           "replay_campaign",
           "run_campaign", "design_resilience", "attach_resilience"]


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One campaign's shape: population size, trace length, seed.

    Hashable so :func:`design_resilience` can memoise per
    ``(design, depth, width, config, device)``.
    """

    n_faults: int = 32
    n_cycles: int = 128
    seed: int = 0
    kinds: tuple[str, ...] = FAULT_KINDS
    write_prob: float = 0.35


@dataclasses.dataclass(frozen=True)
class CampaignResult:
    """A classified campaign: the injected population, each fault's
    worst observed outcome, and the aggregate record."""

    spec_label: str
    faults: tuple[FaultSpec, ...]
    outcomes: tuple[str, ...]      # worst per fault: benign<corrected<detected<sdc
    resilience: Resilience


_SEVERITY = ("benign", "corrected", "detected", "sdc")


def _classify(cover: str, n_read: int, golden: np.ndarray, f_vals: np.ndarray,
              f_par: np.ndarray) -> tuple[np.ndarray, ...]:
    """Per-read boolean masks [F, T, R]: (benign, corrected, detected, sdc).

    ``golden`` [T, R]; ``f_vals``/``f_par`` [F, T, R].
    """
    d_bad = f_vals != golden[None]
    if cover == "parity":
        p_bad = f_par != golden[None]
        benign = ~d_bad & ~p_bad
        corrected = d_bad ^ p_bad           # exactly one path corrupt
        both = d_bad & p_bad
        detected = both & (f_vals != f_par)
        sdc = both & (f_vals == f_par)
    elif cover == "replica":
        # one replica faulty, n_read - 1 healthy replicas read golden
        benign = ~d_bad
        if n_read >= 3:
            corrected, detected, sdc = d_bad, ~d_bad & False, d_bad & False
        elif n_read == 2:
            corrected, detected, sdc = d_bad & False, d_bad, d_bad & False
        else:
            corrected, detected, sdc = d_bad & False, d_bad & False, d_bad
    else:
        benign = ~d_bad
        corrected = detected = d_bad & False
        sdc = d_bad
    return benign, corrected, detected, sdc


def _host_words(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


def campaign_draws(spec: AMMSpec, cfg: FaultConfig = FaultConfig()
                   ) -> tuple[np.ndarray, tuple, list[FaultSpec]]:
    """A campaign's seeded draws, in the reference's order: the initial
    words [depth] ``uint32``, the op trace (``make_trace`` layout) and the
    fault population."""
    rng = np.random.default_rng(
        [cfg.seed, rp.spec_seed(spec, salt="campaign")])
    ops = rp.make_trace(spec, cfg.n_cycles, rng=rng,
                        write_prob=cfg.write_prob)
    values = rng.integers(0, 1 << 32, spec.depth, dtype=np.uint32)
    faults = sample_faults(spec, cfg.n_faults, cfg.seed, cfg.n_cycles,
                           cfg.kinds)
    return values, ops, faults


def replay_campaign(spec: AMMSpec, cfg: FaultConfig = FaultConfig(),
                    device: "str | torch.device | None" = None
                    ) -> tuple[list[FaultSpec], rp.ReplayResult,
                               rp.ReplayResult]:
    """A campaign's fault population and its two replays on ``device``:
    the clean (golden) replay [T, R] and the batched fault-injected
    replay [F, T, R]."""
    dev = resolve_device(device)
    values, ops, faults = campaign_draws(spec, cfg)
    _, golden = rp.replay(spec, rp.init_flat(spec, values, dev), *ops,
                          device=dev)
    _, faulty = rp.replay_faulty_batched(
        spec, tile_states(spec, values, len(faults), dev),
        build_masks(spec, faults, dev), *ops, share_trace=True, device=dev)
    return faults, golden, faulty


def run_campaign(spec: AMMSpec, cfg: FaultConfig = FaultConfig(),
                 device: "str | torch.device | None" = None
                 ) -> CampaignResult:
    """Inject ``cfg.n_faults`` seeded faults into ``spec`` and classify
    every post-injection read.  Fully deterministic per ``(spec, cfg)``,
    and the same on every device."""
    cover = COVER[spec.kind]
    faults, g, res = replay_campaign(spec, cfg, device)
    golden = _host_words(g.read_vals)
    f_vals = _host_words(res.read_vals)
    f_par = _host_words(res.parity_vals)

    benign, corrected, detected, sdc = _classify(
        cover, spec.n_read, golden, f_vals, f_par)

    # only reads at/after each fault's injection cycle count as observations
    cycles = np.arange(cfg.n_cycles)[None, :, None]                 # [1,T,1]
    live = cycles >= np.asarray([f.cycle for f in faults])[:, None, None]
    n_ports = golden.shape[1]
    n_reads = int(round(live.sum() * n_ports / max(len(faults), 1)))

    counts = {}
    for name, m in (("benign", benign), ("corrected", corrected),
                    ("detected", detected), ("sdc", sdc)):
        counts[name] = int((m & live).sum())

    # detection latency: first observable (corrected|detected) read per fault
    observable = (corrected | detected) & live
    lat = []
    outcomes = []
    for i, f in enumerate(faults):
        tr_hit = observable[i].any(axis=1)
        if tr_hit.any():
            lat.append(int(np.argmax(tr_hit)) - f.cycle)
        worst = 0
        for j, m in enumerate((benign, corrected, detected, sdc)):
            if (m[i] & live[i]).any():
                worst = j
        outcomes.append(_SEVERITY[worst])
    det_latency = float(np.mean(lat)) if lat else -1.0

    resilience = Resilience(
        cover=cover, n_faults=len(faults), n_reads=n_reads,
        benign=counts["benign"], corrected=counts["corrected"],
        detected=counts["detected"], sdc=counts["sdc"],
        det_latency=det_latency)
    return CampaignResult(spec.describe(), tuple(faults), tuple(outcomes),
                          resilience)


@lru_cache(maxsize=None)
def _design_resilience(dp, depth: int, width_bits: int, cfg: FaultConfig,
                       device: str) -> Resilience:
    return run_campaign(_spec_for(dp, depth, width_bits), cfg,
                        device).resilience


def design_resilience(dp, depth: int, width_bits: int,
                      cfg: FaultConfig = FaultConfig(),
                      device: "str | torch.device | None" = None
                      ) -> Resilience:
    """Campaign record for one DSE design template at a given geometry.

    ``dp`` is a :class:`repro_torch.core.dse.sweep.DesignPoint` (any
    object with its fields and ``label``).  Memoised per ``(dp, depth,
    width_bits, cfg, device)``: a sweep shares one campaign across
    benches and unrolls, since resilience is a property of the design,
    not of the workload trace.
    """
    return _design_resilience(dp, depth, width_bits, cfg,
                              str(resolve_device(device)))


def attach_resilience(points: Sequence, designs: Sequence,
                      depth: int = 256, width_bits: int = 32,
                      cfg: FaultConfig = FaultConfig(),
                      device: "str | torch.device | None" = None) -> list:
    """Return ``points`` (dataclasses with a ``design`` label and the
    ``res_*`` fields) with ``res_*`` filled from per-design campaigns.

    Runs *after* sweep caching: cached timing points stay fault-agnostic
    and the campaign is evaluated once per distinct design label.
    """
    by_label = {d.label: d for d in designs}
    out = []
    for p in points:
        d = by_label.get(p.design)
        if d is None:
            out.append(p)
            continue
        rec = design_resilience(d, depth, width_bits, cfg, device)
        out.append(dataclasses.replace(p, **resilience_fields(rec)))
    return out
