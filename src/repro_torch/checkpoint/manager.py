"""Checkpointing: one ``.npy`` a leaf with a JSON manifest, atomic
renames, optional async writes and keep-last-k GC, in the on-disk
layout of ``src/repro/checkpoint/manager.py``, so a checkpoint written
by either package restores in the other:

  <directory>/ckpt_{step:08d}/manifest.json
      {"step": s, "leaves": [{"name", "file", "shape", "dtype"}, ...]}
  <directory>/ckpt_{step:08d}/<sha1(name)[:16]>.npy

A leaf's name is its dict keys joined by "/", leaves in sorted key
order (JAX's).  A bf16 leaf is stored as its ``uint16`` bits with the
logical dtype "bfloat16"; restore maps that name itself (uint16 bits ->
int16 tensor -> bf16 view), since numpy knows no bfloat16 without
ml_dtypes.  A write goes to ``ckpt_*.tmp`` and is renamed when whole.
``restore`` puts every leaf on its template's device and dtype, or,
given ``shardings`` (a tree of ``launch.sharding.NamedPlacement``),
places it as a DTensor on that mesh: the saving mesh does not matter
(elastic re-sharding).  A tree of DTensors is saved whole: every rank
gathers each leaf (a collective, so every rank calls ``save``) and
global rank 0 writes it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.common import named_leaves

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _flatten(tree: Any) -> "list[tuple[str, Any]]":
    """(name, leaf) in JAX's order: dict keys sorted at every level."""
    return [("/".join(path), t) for path, t in named_leaves(tree)]


def _unflatten(template: Any, leaves: "dict[str, Any]",
               prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    return leaves[prefix[:-1]]


def _to_host(t: torch.Tensor) -> "tuple[np.ndarray, str]":
    """A copy of ``t`` (the whole tensor of a DTensor) as numpy and its
    logical dtype name."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), _BF16
    arr = np.array(t.numpy(), copy=True)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = arr.view(want)            # undo a uint storage view
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3
    async_save: bool = False

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("ckpt_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool | None = None) -> str:
        """Atomic save of a nested dict of tensors; returns the
        checkpoint path.  The leaves are copied to the host before it
        returns, so a non-blocking save writes the values of the call."""
        leaves = _flatten(tree)
        host = [(n, *_to_host(x)) for n, x in leaves]
        if any(isinstance(x, DTensor) for _, x in leaves) and \
                dist.get_rank() != 0:
            return self._step_dir(step)     # rank 0 writes the whole tree

        def write() -> None:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            for name, arr, logical in host:
                fname = hashlib.sha1(name.encode()).hexdigest()[:16] + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append({
                    "name": name, "file": fname,
                    "shape": list(arr.shape), "dtype": logical,
                })
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking is None:
            blocking = not self.async_save
        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return self._step_dir(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template: Any, step: int | None = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``template`` (the latest step
        when ``step`` is None), each leaf in its template's dtype: on the
        template's device, or, with ``shardings`` (a tree of
        ``NamedPlacement`` of the template's structure), as a DTensor
        placed on its mesh, each rank keeping its shard."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        placed = dict(_flatten(shardings)) if shardings is not None else {}
        out = {}
        for name, tmpl in _flatten(template):
            if name not in by_name:
                raise KeyError(f"checkpoint {d} missing leaf {name!r}")
            leaf = by_name[name]
            t = _from_host(np.load(os.path.join(d, leaf["file"])),
                           leaf["dtype"])
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"leaf {name}: saved {tuple(t.shape)} != "
                                 f"template {tuple(tmpl.shape)}")
            if name in placed:
                where = placed[name]
                out[name] = distribute_tensor(
                    t.to(device=where.mesh.device_type, dtype=tmpl.dtype),
                    where.mesh, where.placements, src_data_rank=None)
            else:
                out[name] = t.to(device=tmpl.device, dtype=tmpl.dtype)
        return _unflatten(template, out)
