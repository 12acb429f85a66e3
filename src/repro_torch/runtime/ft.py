"""Fault-tolerance runtime: heartbeat/straggler monitoring, elastic
re-meshing after chip loss, and int8 gradient compression with error
feedback, as ``src/repro/runtime/ft.py`` has them.

The monitor and the mesh arithmetic are host code (numpy); the
compression runs on the gradients' device.  A gradient tree is a
nested dict of tensors (or one tensor), as the port's params are.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch


# ======================================================================
# Straggler / heartbeat monitoring
# ======================================================================
@dataclasses.dataclass
class StragglerPolicy:
    window: int = 16               # step-time history per worker
    threshold: float = 2.5         # x median -> straggler
    min_history: int = 4
    max_drop_frac: float = 0.125   # never drop more than this many workers


class HeartbeatMonitor:
    """Tracks per-worker step times; flags stragglers and dead workers.
    Driven by recorded step times (tests inject synthetic delays)."""

    def __init__(self, n_workers: int, policy: StragglerPolicy | None = None,
                 dead_after_s: float = 60.0) -> None:
        self.n = n_workers
        self.policy = policy or StragglerPolicy()
        self.dead_after_s = dead_after_s
        self._hist: list[list[float]] = [[] for _ in range(n_workers)]
        self._last_seen = [time.monotonic()] * n_workers

    def report(self, worker: int, step_time_s: float,
               now: float | None = None) -> None:
        h = self._hist[worker]
        h.append(step_time_s)
        if len(h) > self.policy.window:
            h.pop(0)
        self._last_seen[worker] = now if now is not None else time.monotonic()

    def stragglers(self) -> list[int]:
        med = np.median([np.median(h) for h in self._hist
                         if len(h) >= self.policy.min_history] or [0.0])
        if med <= 0:
            return []
        out = [w for w, h in enumerate(self._hist)
               if len(h) >= self.policy.min_history
               and np.median(h) > self.policy.threshold * med]
        cap = max(1, int(self.n * self.policy.max_drop_frac))
        return sorted(out, key=lambda w: -np.median(self._hist[w]))[:cap]

    def dead(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [w for w, t in enumerate(self._last_seen)
                if now - t > self.dead_after_s]


# ======================================================================
# Elastic re-meshing
# ======================================================================
def elastic_mesh_shape(n_devices: int, model_parallel: int = 16,
                       multi_pod_threshold: int = 512
                       ) -> dict[str, Any]:
    """Best mesh for the devices that survive a failure: TP ("model")
    at the largest power of two <= requested that divides the device
    count, the rest on data (and pod when >= threshold)."""
    m = model_parallel
    while m > 1 and n_devices % m:
        m //= 2
    rest = n_devices // m
    if rest >= (multi_pod_threshold // m) and rest % 2 == 0:
        return {"shape": (2, rest // 2, m), "axes": ("pod", "data", "model")}
    return {"shape": (rest, m), "axes": ("data", "model")}


@dataclasses.dataclass
class ElasticPlan:
    old_devices: int
    new_devices: int
    mesh: dict[str, Any]
    batch_ratio: float      # global batch kept constant -> more accum steps

    @property
    def extra_accum_factor(self) -> int:
        return max(1, int(round(self.batch_ratio)))


def plan_rescale(old_devices: int, new_devices: int,
                 model_parallel: int = 16) -> ElasticPlan:
    mesh = elastic_mesh_shape(new_devices, model_parallel)
    return ElasticPlan(old_devices, new_devices, mesh,
                       batch_ratio=old_devices / max(new_devices, 1))


# ======================================================================
# Gradient compression (int8 + error feedback)
# ======================================================================
def compress_int8(g: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Per-tensor symmetric int8 quantization -> (q, scale); rounds half
    to even, as ``jnp.round``."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def compressed_grad_tree(grads: Any, error_state: Any | None = None
                         ) -> "tuple[Any, Any]":
    """Quantize a gradient tree with error feedback: the quantization
    residual is carried and added back next step, so compression error
    does not bias the optimizer.  Returns (the dequantized gradients in
    their own dtype, the new f32 error state)."""
    if error_state is None:
        error_state = _map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                           grads)

    def one(g, e):
        corrected = g.float() + e
        deq = decompress_int8(*compress_int8(corrected))
        return deq.to(g.dtype), corrected - deq

    pairs = _map(one, grads, error_state)
    return _map(lambda t: t[0], pairs), _map(lambda t: t[1], pairs)
