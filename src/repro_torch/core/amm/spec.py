"""AMM design specifications and structural formulas.

An :class:`AMMSpec` names one point in the paper's memory design space:
a design kind (ideal / banked / multipump / NTX-family / LVT / remap),
a read/write port configuration, a logical depth and word width, and a
banking factor.  The structural formulas here (leaf-bank counts, storage
overhead, table bits) are consumed by the cost models in
``repro_torch.core.cost`` (and, in the JAX reference package, by the
port-constrained scheduler in ``repro.core.sim``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

DesignKind = Literal[
    "ideal",      # true multiport RAM (oracle; circuit-level baseline)
    "banked",     # array-partitioned banking (conflicts serialize)
    "multipump",  # internally double-clocked 2-port macro
    "h_ntx_rd",   # non-table XOR, hierarchical read scaling  (paper II-A)
    "b_ntx_wr",   # non-table XOR, write pairing              (paper II-A)
    "hb_ntx",     # HB-NTX-RdWr combined flow                 (paper II-A, Fig 2)
    "lvt",        # live-value-table                          (paper II-B)
    "remap",      # table-based remap                         (paper II-B)
]

AMM_KINDS: tuple[str, ...] = ("h_ntx_rd", "b_ntx_wr", "hb_ntx", "lvt", "remap")


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class AMMSpec:
    """One memory design point.

    Attributes:
      kind: design family.
      n_read: read ports exposed to the datapath.
      n_write: write ports exposed to the datapath.
      depth: logical number of words.
      width: word width in bits.
      n_banks: banking-structure factor.  For kind=="banked" it is the
        array-partitioning factor.  For AMM kinds the *leaf* structure is
        implied by the port config and ``n_banks`` is the additional leaf
        sub-banking factor (paper Sec. III: depth x port config x
        banking): every leaf macro is split into ``n_banks``
        word-interleaved sub-banks — smaller/faster macros in the cost
        model, finer conflict granularity in the NTX arbitration.
    """

    kind: DesignKind
    n_read: int = 1
    n_write: int = 1
    depth: int = 1024
    width: int = 32
    n_banks: int = 1

    def __post_init__(self) -> None:
        if self.depth <= 0 or self.width <= 0:
            raise ValueError(f"bad geometry {self.depth}x{self.width}")
        if self.n_read < 1 or self.n_write < 1:
            raise ValueError("need at least 1R1W")
        if self.kind == "h_ntx_rd":
            if not _is_pow2(self.n_read):
                raise ValueError("h_ntx_rd read ports must be a power of two")
            if self.n_write != 1:
                raise ValueError("h_ntx_rd supports a single write port")
            if self.depth % self.n_read != 0:
                raise ValueError("depth must divide by read ports")
        if self.kind == "b_ntx_wr":
            if self.n_write != 2:
                raise ValueError("b_ntx_wr provides exactly 2 write ports")
            if self.depth % 2 != 0:
                raise ValueError("depth must be even")
        if self.kind == "hb_ntx":
            if not _is_pow2(self.n_read):
                raise ValueError("hb_ntx read ports must be a power of two")
            if self.n_write != 2:
                raise ValueError("hb_ntx provides exactly 2 write ports (paper flow)")
            if self.depth % (2 * max(self.n_read, 1)) != 0:
                raise ValueError("depth must divide by 2*n_read")
        if self.kind == "banked" and self.n_banks < 1:
            raise ValueError("banked needs >=1 bank")
        if self.kind in AMM_KINDS:
            if not _is_pow2(self.n_banks):
                raise ValueError(
                    "AMM leaf sub-banking must be a power of two")
            if self.n_banks > self.leaf_banks()[1]:
                raise ValueError("leaf sub-banking exceeds leaf depth")

    # ------------------------------------------------------------------
    # Structural formulas (feed the cost model).
    # ------------------------------------------------------------------
    @property
    def read_tree_levels(self) -> int:
        """k such that n_read == 2**k for the hierarchical XOR read tree."""
        return int(math.log2(self.n_read)) if self.n_read > 1 else 0

    def leaf_banks(self) -> tuple[int, int]:
        """(number of physical leaf SRAM banks, depth of each leaf bank).

        h_ntx_rd with 2**k read ports is a ternary tree of XOR parity:
        3**k leaves of depth N/2**k  -> storage overhead (3/2)**k.
        b_ntx_wr triples the top level: 3 structures of depth N/2.
        hb_ntx composes both: 3 * 3**k leaves of depth N/(2*2**k).
        lvt replicates: n_write banks x n_read replicas, full depth.
        remap: n_write+1 full-depth banks.
        banked: n_banks of depth N/n_banks.
        """
        n, k = self.depth, self.read_tree_levels
        if self.kind == "h_ntx_rd":
            return 3**k, n // (2**k)
        if self.kind == "b_ntx_wr":
            return 3, n // 2
        if self.kind == "hb_ntx":
            return 3 * 3**k, n // (2 * 2**k)
        if self.kind == "lvt":
            return self.n_write * max(self.n_read, 1), n
        if self.kind == "remap":
            return self.n_write + 1, n
        if self.kind == "banked":
            return self.n_banks, -(-n // self.n_banks)
        if self.kind == "multipump":
            return 1, n
        return 1, n  # ideal

    def storage_bits(self) -> int:
        banks, bank_depth = self.leaf_banks()
        return banks * bank_depth * self.width

    def table_bits(self) -> int:
        """Lookup-table state (registers/LUT) for table-based designs."""
        if self.kind == "lvt":
            return self.depth * max(1, math.ceil(math.log2(max(self.n_write, 2))))
        if self.kind == "remap":
            return self.depth * max(1, math.ceil(math.log2(self.n_write + 1)))
        return 0

    @property
    def conflict_free(self) -> bool:
        """Architecturally conflict-free port guarantee (any nR+nW issue
        in one cycle when the design's structural rules are met).  The
        cycle-level arbitration layer (the reference's
        ``repro.core.sim.arbiter``) still models the internal mechanics
        — parity-path fan-out, write pairing, live-bank steering — that
        deliver the guarantee."""
        return self.kind in ("ideal", "h_ntx_rd", "b_ntx_wr", "hb_ntx", "lvt", "remap")

    @property
    def frequency_factor(self) -> float:
        """External clock degradation (1.0 = full speed). Paper I: multi-pumping
        degrades max external operating frequency."""
        return 0.5 if self.kind == "multipump" else 1.0

    def describe(self) -> str:
        return (
            f"{self.kind}[{self.n_read}R{self.n_write}W {self.depth}x{self.width}b"
            + (f" banks={self.n_banks}" if self.kind == "banked" else "")
            + (f" sub={self.n_banks}"
               if self.kind in AMM_KINDS and self.n_banks > 1 else "")
            + "]"
        )
