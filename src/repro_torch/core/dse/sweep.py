"""Design-space sweep: the memory design templates and their geometry.

For now this module holds copies of the JAX package's
``core/dse/sweep.py`` names that the fault campaigns need:
:class:`DesignPoint`, :data:`DEFAULT_DESIGNS` and :func:`_spec_for`
(``tests/test_torch_fault.py`` holds them equal to the reference).  The
rest of the sweep — ``DSEPoint``, ``evaluate_point``, ``sweep`` — comes
with the port of the batched timing backend.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.amm.spec import AMMSpec

__all__ = ["DesignPoint", "DEFAULT_DESIGNS"]


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """A memory design template, instantiated per array.

    ``n_banks`` is the banking-structure axis (paper Sec. III: depth x
    port config x banking): the partitioning factor for ``banked`` and
    the *leaf sub-banking* factor for AMM kinds (each internal leaf
    macro split into ``n_banks`` word-interleaved sub-banks).
    """
    kind: str
    n_read: int = 1
    n_write: int = 1
    n_banks: int = 1

    @property
    def label(self) -> str:
        if self.kind == "banked":
            return f"banked{self.n_banks}"
        base = f"{self.kind}-{self.n_read}R{self.n_write}W"
        if self.is_amm and self.n_banks > 1:
            return f"{base}-b{self.n_banks}"
        return base

    @property
    def is_amm(self) -> bool:
        return self.kind in ("h_ntx_rd", "b_ntx_wr", "hb_ntx", "lvt", "remap")


DEFAULT_DESIGNS: tuple[DesignPoint, ...] = (
    DesignPoint("banked", n_banks=1),
    DesignPoint("banked", n_banks=2),
    DesignPoint("banked", n_banks=4),
    DesignPoint("banked", n_banks=8),
    DesignPoint("banked", n_banks=16),
    DesignPoint("banked", n_banks=32),
    DesignPoint("multipump", 2, 2),
    DesignPoint("h_ntx_rd", 2, 1),
    DesignPoint("h_ntx_rd", 4, 1),
    DesignPoint("b_ntx_wr", 1, 2),
    DesignPoint("hb_ntx", 2, 2),
    DesignPoint("hb_ntx", 4, 2),
    DesignPoint("lvt", 2, 2),
    DesignPoint("lvt", 4, 2),
    DesignPoint("remap", 2, 2),
    DesignPoint("remap", 4, 2),
    # banking-structure axis: AMM internal leaf sub-banking
    DesignPoint("h_ntx_rd", 4, 1, n_banks=4),
    DesignPoint("hb_ntx", 4, 2, n_banks=4),
    DesignPoint("lvt", 4, 2, n_banks=4),
    DesignPoint("remap", 4, 2, n_banks=4),
)


def _spec_for(dp: DesignPoint, depth: int, width_bits: int) -> AMMSpec:
    if dp.kind == "banked":
        nb = min(dp.n_banks, max(depth // 4, 1))
        return AMMSpec("banked", n_read=2 * nb, n_write=2 * nb,
                       depth=depth, width=width_bits, n_banks=nb)
    depth = max(depth, 4 * max(dp.n_read, dp.n_write, 1))
    sub = 1
    if dp.is_amm and dp.n_banks > 1:
        # clamp leaf sub-banking to the leaf depth (pow2, like banked's
        # depth//4 clamp) so tiny arrays never over-partition
        leaf_depth = AMMSpec(dp.kind, dp.n_read, dp.n_write, depth,
                             width_bits).leaf_banks()[1]
        sub = min(dp.n_banks, 1 << max(leaf_depth.bit_length() - 1, 0))
    return AMMSpec(dp.kind, dp.n_read, dp.n_write, depth, width_bits,
                   n_banks=sub)
