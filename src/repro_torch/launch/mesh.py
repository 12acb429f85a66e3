"""Production mesh construction over ``torch.distributed``, as
``src/repro/launch/mesh.py``: a ``DeviceMesh`` of named axes over the
first ranks of the initialised process group.

A function, not a module constant, so that importing this module makes
no process group.  The reference forces fake host devices
(``--xla_force_host_platform_device_count``) for its dry run; the
counterpart here is ``fake_world(n)``, the ``"fake"`` backend of
``torch.distributed`` for rank 0 of ``n``: collectives return at once
and move nothing, so a 256- or 512-rank mesh can be built in one host
process (``launch/dryrun.py``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _mesh(shape: "tuple[int, ...]", axes: "tuple[str, ...]",
          device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks, have {have}: "
            f"run under `with fake_world({n}):` (see launch/dryrun.py) or "
            f"`torchrun --nproc-per-node {n}`")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 ranks a pod over ("data", "model"); multi-pod adds a
    leading pod = 2 axis."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return _mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)


def make_test_mesh(shape: "tuple[int, ...]" = (2, 2),
                   axes: "tuple[str, ...]" = ("data", "model"),
                   device_type: str = "cuda") -> DeviceMesh:
    """A small mesh for tests and the card's one-rank runs."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def axis_sizes(mesh) -> "dict[str, int]":
    """{axis name: size} of a ``DeviceMesh``, of anything with a
    ``.shape`` mapping (the reference's rules read only that), or of a
    mapping itself."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


class fake_world:
    """``with fake_world(n):`` initialises the ``"fake"`` process group
    as rank 0 of ``n`` and destroys it on exit.  Host-only by nature:
    its collectives move nothing and return tensors of the right
    shapes, so only shapes, counts and placements mean anything in it."""

    def __init__(self, n: int) -> None:
        self.n = n

    def __enter__(self) -> "fake_world":
        # importing the module registers the backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.n)
        return self

    def __exit__(self, *exc) -> None:
        dist.destroy_process_group()
