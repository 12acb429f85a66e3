"""Frozen work counts and the card's peaks: the yardstick of the
roofline metrics.

The bytes are counted from the trace and the grid alone, never from how
the program lays its inputs out, so that a redesign of the kernel
leaves the count right.  The least data a schedule of ``lanes`` design
points over one trace must move:

* the trace, read once: a node's op kind (1 byte), its array (2 bytes)
  and its word address (4 bytes); each dependence edge (4 bytes) and
  each node's edge offset (4 bytes);
* each lane's design, read once: memory kind, read and write ports,
  banks, unroll and load latency (6 x 4 bytes);
* each lane's result, written once: cycles, the three stall counts,
  accesses issued and cycles with an access (6 x 4 bytes).

A schedule moves far more than this (its ready sets, its in-flight
nodes); the count is the floor any implementation pays, so a share of
it is a true share of the roofline.
"""
from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12

NODE_BYTES = 1 + 2 + 4
EDGE_BYTES = 4
OFFSET_BYTES = 4
DESIGN_BYTES = 6 * 4
RESULT_BYTES = 6 * 4


def schedule_bytes(n_nodes: int, n_edges: int, lanes: int) -> int:
    """The bytes one launch scheduling ``lanes`` points must move."""
    trace = n_nodes * (NODE_BYTES + OFFSET_BYTES) + n_edges * EDGE_BYTES
    return trace + lanes * (DESIGN_BYTES + RESULT_BYTES)


def least_seconds(n_bytes: int) -> float:
    """The least time the card's memory needs to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S
