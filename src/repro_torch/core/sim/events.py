"""Issue-event log of the scheduler (copy of the JAX package's
``core/sim/events.py``).

The batched timing backend (``core/sim/batched_cycle.py``, the
``cycle_lanes`` kernel and its plain version) can record, for every
issued op, *where* the access landed and *how*: the cycle it issued,
the per-class port slot it occupied, the bank/leaf it touched and the
path kind it took.  The log is the raw material of the reference's
independent legality checker (``core/verify``), which re-derives what
each event was *allowed* to do straight from the :class:`AMMSpec`.

Because the list scheduler issues every trace op exactly once, the log
is node-indexed fixed-shape arrays rather than an append stream: entry
``i`` describes node ``i``.  The port's logs are held equal to the
reference loops' logs by ``tests/test_torch_schedule.py``.

Path kinds (the same codes as the reference's C loop):

=================  ====================================================
``PATH_COMPUTE``   functional-unit op (no memory resource)
``PATH_DIRECT``    plain access: ideal/multipump port, banked bank,
                   NTX direct leaf, LVT read, remap live-bank read,
                   NTX plain (first-per-half / dedicated-port) write
``PATH_PARITY``    NTX read served by the full 2**k parity path
``PATH_STEERED``   remap write steered to a conflict-free bank
``PATH_PAIR_RMW``  B/HB-NTX same-half write pair through the Ref unit
``PATH_BROADCAST`` LVT write replicated into every read-port bank
=================  ====================================================

``resource`` is the structure the event occupied: the bank index for
banked accesses, the live/steered bank for remap, the packed
``(tree * n_leaves + leaf) * sub + sub_offset`` port key for NTX
direct reads, and ``-1`` where the kind has no single arbitrated
resource (ideal/LVT/multipump ports, parity fan-outs, pair RMWs —
their resource *sets* are re-derived by the checker).  ``slot`` is the
0-based issue ordinal within the op's resource class that cycle.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# path-kind codes, as in the reference (and csrc/cycle_lanes.cu)
PATH_COMPUTE = 0
PATH_DIRECT = 1
PATH_PARITY = 2
PATH_STEERED = 3
PATH_PAIR_RMW = 4
PATH_BROADCAST = 5

PATH_NAMES: dict[int, str] = {
    PATH_COMPUTE: "compute",
    PATH_DIRECT: "direct",
    PATH_PARITY: "parity",
    PATH_STEERED: "steered",
    PATH_PAIR_RMW: "pair_rmw",
    PATH_BROADCAST: "broadcast",
}


@dataclasses.dataclass
class EventLog:
    """Node-indexed issue events of one schedule run.

    All arrays have length ``n_nodes``; un-issued slots (only possible
    in a corrupted log) hold ``-1`` everywhere.
    """

    cycle: np.ndarray       # [n] int64 issue cycle
    path: np.ndarray        # [n] int64 PATH_* code
    resource: np.ndarray    # [n] int64 bank / leaf key, -1 if n/a
    slot: np.ndarray        # [n] int64 per-class issue ordinal in-cycle

    @classmethod
    def empty(cls, n: int) -> "EventLog":
        return cls(cycle=np.full(n, -1, np.int64),
                   path=np.full(n, -1, np.int64),
                   resource=np.full(n, -1, np.int64),
                   slot=np.full(n, -1, np.int64))

    @classmethod
    def from_packed(cls, packed: np.ndarray) -> "EventLog":
        """From the C loop's ``[n, 4]`` (cycle, path, resource, slot)."""
        packed = packed.reshape(-1, 4)
        return cls(cycle=packed[:, 0].copy(), path=packed[:, 1].copy(),
                   resource=packed[:, 2].copy(), slot=packed[:, 3].copy())

    @property
    def n_nodes(self) -> int:
        return int(self.cycle.shape[0])

    def copy(self) -> "EventLog":
        return EventLog(self.cycle.copy(), self.path.copy(),
                        self.resource.copy(), self.slot.copy())

    def __eq__(self, other) -> bool:
        if not isinstance(other, EventLog):
            return NotImplemented
        return (np.array_equal(self.cycle, other.cycle)
                and np.array_equal(self.path, other.path)
                and np.array_equal(self.resource, other.resource)
                and np.array_equal(self.slot, other.slot))
