"""Roofline terms of a sharded step, counted per device on the host.

Three terms per (arch x shape x mesh), in seconds per step, as in
``src/repro/launch/roofline.py``:

  compute    = flops_per_device / peak_flops
  memory     = bytes_per_device / hbm_bw
  collective = collective_bytes_per_device / link_bw

The reference reads these from the partitioned HLO text (a trip-count
aware walk over XLA's post-optimisation module).  There is no HLO here:
``DeviceCounters`` is a ``TorchDispatchMode`` that sees the step's ops
as one device runs them.  It lets DTensor ops pass (it returns
``NotImplemented`` for them, as ``CommDebugMode`` does), so DTensor
desugars each into its local ops and the collectives its redistributions
need, and those reach the mode on the local shards.  (DTensor also runs
an op once on ``FakeTensor``s at its global shapes to learn its output,
the first time it meets a sharding; the mode counts no op on fake
tensors.)

  * flops: each local op that ``torch.utils.flop_counter`` has a formula
    for (the matmul family, convolutions, fused attention), at its local
    shapes; on one device and a plain step this is exactly
    ``FlopCounterMode``'s count;
  * memory: operand + result bytes of every local matmul, plus twice the
    result bytes of gathers and index reads, scatters, sorts and
    reductions (the reference's rule: what cannot fuse away); the
    launcher adds the optimiser update's traffic on top for train cells;
  * collective: the payload bytes of every collective that actually runs
    (a ``Partial`` reduced, a ``Shard`` gathered or re-split, a send),
    by kind, times the reference's ring factor (an all-reduce moves
    about twice its payload a device; gather, scatter, all-to-all and
    sends once).  Payloads count in their real dtypes: the reference's
    f32-counted-as-bf16 correction for XLA:CPU's legalised dots is not
    carried over.

Hardware model, one NVIDIA H100 SXM (the card this port runs on reads
"NVIDIA H100 80GB HBM3, 700.00 W" from ``nvidia-smi --query-gpu=
name,power.limit --format=csv,noheader``): 989 TFLOP/s dense bf16 on the
tensor cores and 3.35 TB/s of HBM3 over 80 GB (NVIDIA's H100 data
sheet, SXM part, at the 700 W limit).  A 16 x 16 mesh is 32 hosts of 8
cards, so both of its axes cross hosts: ``link_bw`` models the link out
of the host, one 400 Gb/s InfiniBand NDR port per card (the DGX H100's
eight ConnectX-7 ports, NVIDIA's DGX H100 data sheet), 50 GB/s each
way; NVLink inside a host (450 GB/s each way) is not the bound.
"""
from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

HW = {
    "peak_flops": 989e12,
    "hbm_bw": 3.35e12,
    "link_bw": 50e9,
    "hbm_bytes": 80e9,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# per-device ring traffic per byte of payload
_RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}

_aten = torch.ops.aten
_DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
_GATHERS = {_aten.embedding, _aten.index, _aten.gather, _aten.index_select}
_SCATTER_SORT_REDUCE = {
    _aten.scatter, _aten.scatter_add, _aten.index_add, _aten.index_put,
    _aten.sort, _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max,
    _aten.min, _aten.prod, _aten.logsumexp}

# collectives by op name: the functional ones DTensor issues (payload:
# the result) and the c10d ones torch.distributed issues (payload: the
# first argument, the output buffers; a send counts, its recv does not)
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "broadcast_": "broadcast"}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) structure, in its dtype."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class DeviceCounters(TorchDispatchMode):
    """``with DeviceCounters() as c:`` counts what one device runs:
    ``c.flops``, ``c.bytes`` (matmul operands and results, gathers,
    scatters, sorts, reductions), ``c.collectives`` (ring-weighted bytes
    by kind), ``c.payload`` (raw payload bytes by kind) and
    ``c.collective_bytes`` (their ring-weighted sum)."""

    supports_higher_order_operators = True

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.payload = {k: 0 for k in COLLECTIVES}
        self.collectives = {k: 0.0 for k in COLLECTIVES}

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def _collective(self, kind: str, n: int) -> None:
        self.payload[kind] += n
        self.collectives[kind] += _RING_FACTOR[kind] * n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor desugar it first
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out                  # DTensor's shape propagation
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in _DOTS:
            ops = args[1:3] if packet in (_aten.addmm, _aten.baddbmm) \
                else args[:2]
            self.bytes += tensor_bytes(ops) + tensor_bytes(out)
        elif packet in _GATHERS or packet in _SCATTER_SORT_REDUCE:
            self.bytes += 2 * tensor_bytes(out)
        ns, name = packet._qualified_op_name.split("::")
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            self._collective(_FUNCTIONAL[name], tensor_bytes(out))
        elif ns == "c10d" and name in _C10D:
            self._collective(_C10D[name], tensor_bytes(args[0]))
        return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    collectives: "dict[str, float]"
    model_flops_global: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / HW["peak_flops"]

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HW["hbm_bw"]

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / HW["link_bw"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s, 1e-12)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops x chips): remat/redundancy waste."""
        hw = self.flops_per_device * self.chips
        return self.model_flops_global / hw if hw else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline-bound step time."""
        denom = self.step_s * self.chips * HW["peak_flops"]
        return self.model_flops_global / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu,
            "collectives": self.collectives,
        }


def model_flops(arch_params: int, tokens: int, kind: str,
                active_params: "int | None" = None) -> float:
    """6*N*D for training, 2*N_active per generated token otherwise."""
    n = active_params or arch_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
