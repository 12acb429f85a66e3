"""Independent re-derivation of the per-kind memory geometry (copy of
the JAX package's ``core/verify/geometry.py``).

The legality checker must not trust the arbitration layer it checks, so
this module re-derives every structural fact straight from the
:class:`~repro_torch.core.amm.spec.AMMSpec` — deliberately *not*
importing ``arbiter.compile_spec`` / ``arbiter.ntx_tables`` and
deliberately using a different construction style (scalar recursion +
``itertools.product`` instead of the arbiter's vectorized bit loops).
A bug in the shared leaf-path formula therefore shows up as a
divergence here instead of being reproduced.

NTX geometry recap (paper Sec. II): a ``2**k``-read tree halves the
address space ``k`` times; at each level a word lives in one child
(its *direct* branch) while the third, *ref* branch stores the XOR of
the two children.  Labelling branches base-3 (0 = low half, 1 = high
half, 2 = ref), the direct leaf of a word is the base-3 number of its
half-choices, and a word is reconstructible from any leaf set obtained
by swapping, per level, the direct digit for {opposite-half, ref} —
the checker enumerates those ``2**k`` parity alternatives explicitly
as a cartesian product.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from itertools import product

from repro_torch.core.amm.spec import AMMSpec

# base-3 branch digits
_LOW, _HIGH, _REF = 0, 1, 2


def _digits_to_leaf(digits: "tuple[int, ...]") -> int:
    leaf = 0
    for d in digits:
        leaf = leaf * 3 + d
    return leaf


@lru_cache(maxsize=None)
def leaf_paths(tree_depth: int, k: int
               ) -> "tuple[tuple[int, int, tuple[int, ...]], ...]":
    """Per-address ``(direct_leaf, leaf_offset, parity_leaves)`` of one
    NTX tree with ``k`` split levels over ``tree_depth`` words.

    ``parity_leaves`` is the full XOR path: per level the word's direct
    digit is replaced by one of {opposite half, ref}, so the path is
    the cartesian product of those two choices over all levels
    (``2**k`` leaves; for ``k == 0`` the path degenerates to the single
    root leaf, i.e. parity offers no alternative to the direct port).
    """
    out = []
    for addr in range(tree_depth):
        digits: list[int] = []
        off, span = addr, tree_depth
        for _ in range(k):
            span //= 2
            if off >= span:
                digits.append(_HIGH)
                off -= span
            else:
                digits.append(_LOW)
        direct = _digits_to_leaf(tuple(digits))
        # per level the parity path may use the opposite data half
        # (1 - digit) or the ref branch — every combination is a leaf
        # whose XOR chain reconstructs the word
        alts = [(1 - d, _REF) for d in digits]
        parity = tuple(sorted(_digits_to_leaf(c) for c in product(*alts)))
        out.append((direct, off, parity))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ArrayRules:
    """Declarative legality facts for one array's memory design.

    Everything is re-derived from the AMMSpec fields (kinds' structure
    per the paper), not read out of an ``ArbDescriptor``.
    """

    kind: str
    rd: int                     # loads issuable per cycle
    wr: int                     # stores issuable per cycle
    depth: int                  # words addressed (word % depth)
    slot_cap: "int | None"      # multipump: pumped total-access cap
    n_banks: int                # banked / remap internal banks
    lvt_broadcast: bool         # writes must be replica broadcasts
    # NTX structure (zeros/empty for other kinds)
    is_ntx: bool = False
    has_ref: bool = False       # b/hb: Ref tree twins every data access
    k: int = 0                  # read-tree split levels
    n_leaves: int = 1           # 3**k leaf banks per tree
    sub: int = 1                # word-interleaved sub-banks per leaf
    tree_depth: int = 1         # words per data tree
    half: int = 0               # b/hb top-level split point

    def key(self, tree: int, leaf: int, sub_off: int) -> int:
        """Pack one (tree, leaf, sub-bank) read-port id."""
        return (tree * self.n_leaves + leaf) * self.sub + sub_off


def compile_rules(spec: AMMSpec, ports_per_bank: int) -> ArrayRules:
    """Compile one AMMSpec into its declarative legality rules."""
    kind = spec.kind
    common = dict(kind=kind, rd=spec.n_read, wr=spec.n_write,
                  depth=spec.depth, slot_cap=None, n_banks=1,
                  lvt_broadcast=False)
    if kind == "multipump":
        # the advertised ports come from an internally double-clocked
        # dual-port macro: ports_per_bank accesses per internal cycle
        common["slot_cap"] = ports_per_bank * 2
    elif kind == "banked":
        common["n_banks"] = spec.n_banks
    elif kind == "remap":
        # one spare bank beyond the write ports makes steering total
        common["n_banks"] = spec.n_write + 1
    elif kind == "lvt":
        common["lvt_broadcast"] = True
    elif kind == "h_ntx_rd":
        k = spec.read_tree_levels
        return ArrayRules(**common, is_ntx=True, has_ref=False, k=k,
                          n_leaves=3 ** k, sub=max(spec.n_banks, 1),
                          tree_depth=spec.depth, half=0)
    elif kind in ("b_ntx_wr", "hb_ntx"):
        k = spec.read_tree_levels if kind == "hb_ntx" else 0
        return ArrayRules(**common, is_ntx=True, has_ref=True, k=k,
                          n_leaves=3 ** k, sub=max(spec.n_banks, 1),
                          tree_depth=spec.depth // 2, half=spec.depth // 2)
    elif kind != "ideal":
        raise ValueError(f"unknown AMM kind {kind!r}")
    return ArrayRules(**common)
