"""Batched timing backend: every design lane of a DSE grid in one
``cycle_lanes`` call (the port of the JAX package's
``core/sim/jax_cycle.py``).

The port-constrained list scheduler is evaluated for many designs over
the *same* trace at once: ``schedule_batched`` builds the same per-lane
inputs as the reference (descriptor rows, FU budgets, NTX leaf-path
tables, padded to power-of-two buckets), moves them and the trace's
``DeviceViews`` to the device once, makes one
:func:`repro_torch.kernels.ops.cycle_lanes` call — on the card one
kernel launch, one CTA per lane — and folds the results into
:class:`ScheduleResult`/:class:`EventLog` exactly as the reference does.

Exactness contract (as the reference's): ready nodes are scanned in
exact heap order per resource class (``DeviceViews.perm``); the per-kind
arbitration rules follow the ``ArbDescriptor`` fields and the
``ntx_tables`` geometry; deferral-scan caps, first-deferral stall
attribution and the idle-cycle jump are unchanged.  The port is held to
``tests/golden_schedule.json`` and to the reference's C loop.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.sim.arbiter import (N_FIELDS, STALL_KEYS,
                                          compile_descriptors,
                                          descriptor_device_tables,
                                          descriptor_matrix, device_limits)
from repro_torch.core.sim.events import EventLog
from repro_torch.core.sim.prepared import FU_ORDER, _next_pow2, prepare_trace
from repro_torch.core.sim.scheduler import ScheduleConfig, ScheduleResult
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.cycle_lanes import (ERR_DEADLOCK, ERR_MAX_CYCLES,
                                             ERR_UNCONFIGURED, INT32_INF,
                                             _steer)


@dataclasses.dataclass(frozen=True)
class StaticCfg:
    """The padded dimensions of one batched call (a hashable key)."""

    n_pad: int
    n_preds_max: int
    a_pad: int                  # array-axis bucket
    scan_slots: int             # S: per-cycle candidate slots per array
    key_space: int              # U: NTX port-key ids per array
    bank_slots: int             # NB: bank-usage counters per array
    table_depth: int            # D: per-word state (NTX tables, remap map)
    parity_paths: int           # PP: widest NTX parity fan-out


def _bucket_limits(limits: "Sequence[tuple]"
                   ) -> tuple[int, int, int, int, int]:
    """Pow-2 buckets of the per-design device limits."""
    s, u, nb, d, pp = (max(col) for col in zip(*limits))
    return (_next_pow2(max(s, 1)), _next_pow2(max(u, 1)),
            _next_pow2(max(nb, 1)), _next_pow2(max(d, 1)),
            _next_pow2(max(pp, 1)))


def remap_write_step(live_map, ruse, wuse, addr: int, n_banks: int,
                     ppb: int):
    """One remap write-steering decision, the batched backend's rule.

    Single-array view of the lane loop's steering (the same ``_steer``
    core): scan the banks from the word's live bank and take the first
    one with no write this cycle and a port left.  Returns ``(issued,
    bank, live_map, ruse, wuse)``, with ``bank`` -1 and the state
    untouched when the write stalls."""
    live_map = torch.as_tensor(live_map, dtype=torch.int32).clone()
    ruse = torch.as_tensor(ruse, dtype=torch.int32).clone()
    wuse = torch.as_tensor(wuse, dtype=torch.int32).clone()
    order = (live_map[addr] + torch.arange(n_banks, dtype=torch.int32)) \
        % n_banks
    ok, pos = _steer(wuse[order.long()], ruse[order.long()],
                     torch.ones(n_banks, dtype=torch.bool), ppb)
    if not bool(ok):
        return False, -1, live_map, ruse, wuse
    bank = int(order[int(pos)])
    ruse[bank] += 1
    wuse[bank] = 1
    live_map[addr] = bank
    return True, bank, live_map, ruse, wuse


def _lane_inputs(pt, cfgs) -> "tuple[StaticCfg, dict]":
    """The reference's per-lane numpy inputs for ``cfgs`` over ``pt``."""
    dv = pt.device_views()
    all_descs = [compile_descriptors(c.mem, pt.n_arrays, c.ports_per_bank)
                 for c in cfgs]
    S, U, NB, D, PP = _bucket_limits([device_limits(d) for d in all_descs])
    A = dv.a_pad
    sc = StaticCfg(n_pad=dv.n_pad, n_preds_max=dv.n_preds_max, a_pad=A,
                   scan_slots=S, key_space=U, bank_slots=NB, table_depth=D,
                   parity_paths=PP)
    B = len(cfgs)
    ins = {"desc": np.zeros((B, A, N_FIELDS), np.int32),
           "fu_budgets": np.zeros((B, len(FU_ORDER)), np.int32),
           "mem_latency": np.zeros((B,), np.int32),
           "ppb": np.zeros((B,), np.int32),
           "max_cycles": np.zeros((B,), np.int32),
           "direct": np.zeros((B, A, D), np.int32),
           "offset": np.zeros((B, A, D), np.int32),
           "parity": np.zeros((B, A, D, PP), np.int32)}
    for b, (cfg, descs) in enumerate(zip(cfgs, all_descs)):
        mat = descriptor_matrix(descs)
        ins["desc"][b, :mat.shape[0]] = mat.astype(np.int32)
        (ins["direct"][b], ins["offset"][b],
         ins["parity"][b]) = descriptor_device_tables(descs, A, D, PP)
        ins["fu_budgets"][b] = [cfg.fu_counts.get(name, 1)
                                for name in FU_ORDER]
        ins["mem_latency"][b] = cfg.mem_latency
        ins["ppb"][b] = cfg.ports_per_bank
        ins["max_cycles"][b] = min(cfg.max_cycles, INT32_INF - 64)
    for name in ("preds_pad", "lat", "is_load", "word_idx", "perm",
                 "gid_perm", "seg_start"):
        ins[name] = getattr(dv, name)
    return sc, ins


def schedule_batched(tr, cfgs: "Sequence[ScheduleConfig]", *, device=None,
                     return_maps: bool = False,
                     collect_events: bool = False):
    """Run the cycle-accurate scheduler for many designs in one
    ``cycle_lanes`` call.

    Every ``cfg`` is one design point over the *same* trace (a ``Trace``
    or ``PreparedTrace``).  Returns ``list[ScheduleResult]`` in ``cfgs``
    order, each equal to what the reference scheduler computes for that
    config.  With ``return_maps=True`` also the final remap live maps
    ``[batch, a_pad, table_depth]``; with ``collect_events=True`` also a
    list of per-config :class:`EventLog` (the recording variant runs).
    ``device=None`` means the CUDA device."""
    dev = resolve_device(device)
    pt = prepare_trace(tr)
    cfgs = list(cfgs)
    if not cfgs:
        empty: tuple = ([],)
        if return_maps:
            empty = empty + (np.zeros((0, 0, 0), np.int32),)
        if collect_events:
            empty = empty + ([],)
        return empty if len(empty) > 1 else empty[0]

    sc, ins = _lane_inputs(pt, cfgs)
    t = {k: torch.from_numpy(v).to(dev) for k, v in ins.items()}
    out = ops.cycle_lanes(
        t["desc"], t["fu_budgets"], t["mem_latency"], t["ppb"],
        t["max_cycles"], t["direct"], t["offset"], t["parity"],
        pt.device_views().n_real, t["preds_pad"], t["lat"], t["is_load"],
        t["word_idx"], t["perm"], t["gid_perm"], t["seg_start"],
        scan_slots=sc.scan_slots, key_space=sc.key_space,
        bank_slots=sc.bank_slots, record=collect_events)
    cycles, cnt, per_array, err, maps = (o.cpu().numpy() for o in out[:5])
    ev = out[5].cpu().numpy() if collect_events else None

    for b, cfg in enumerate(cfgs):
        if err[b] == ERR_MAX_CYCLES:
            raise RuntimeError(
                f"scheduler exceeded {cfg.max_cycles} cycles")
        if err[b] == ERR_DEADLOCK:
            raise RuntimeError(
                "deadlock: nodes remain but nothing ready/inflight")
        if err[b] == ERR_UNCONFIGURED:
            raise KeyError(
                "memory op on array without a ScheduleConfig.mem spec")

    names = pt.trace.array_names
    results = [
        ScheduleResult(
            cycles=int(cycles[b]),
            issued=int(cnt[b, 0]),
            mem_issued=int(cnt[b, 1]),
            **{f"{k}_stalls": int(cnt[b, i])
               for k, i in zip(STALL_KEYS, (2, 3, 4))},
            parity_path_reads=int(cnt[b, 5]),
            write_pair_rmws=int(cnt[b, 6]),
            per_array_accesses={a: int(per_array[b, a]) for a in names},
            avg_mem_parallelism=int(cnt[b, 1]) / max(int(cnt[b, 7]), 1),
        )
        for b in range(len(cfgs))
    ]
    ret: tuple = (results,)
    if return_maps:
        ret = ret + (maps,)
    if collect_events:
        n = pt.trace.n_nodes
        ret = ret + ([EventLog(cycle=ev[b, 0, :n].astype(np.int64),
                               path=ev[b, 1, :n].astype(np.int64),
                               resource=ev[b, 2, :n].astype(np.int64),
                               slot=ev[b, 3, :n].astype(np.int64))
                      for b in range(len(cfgs))],)
    return ret if len(ret) > 1 else ret[0]


def schedule_one(tr, cfg: ScheduleConfig, *, device=None) -> ScheduleResult:
    """Single-design convenience wrapper over :func:`schedule_batched`."""
    return schedule_batched(tr, [cfg], device=device)[0]
