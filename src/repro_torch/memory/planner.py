"""MemoryPlanner — the paper's DSE loop applied to LM-serving memories.

For each memory-bound access stream of an (arch x shape) workload —
embedding-table gathers, KV-cache decode reads, MoE expert dispatch —
the planner:

  1. synthesizes the dynamic address trace (same role as Aladdin's LLVM
     trace; token ids are zipfian over the vocabulary, the router
     distribution generates expert streams),
  2. computes Weinberg spatial locality (paper eq. 1) at *element*
     granularity — on an accelerator the transfer unit is a table row /
     KV page / expert bank, not a byte, so streams are scored on unit
     indices,
  3. applies the paper's empirical law: true-multiport (AMM) layouts pay
     off below L < 0.3; stride-friendly streams stay banked,
  4. runs the cost model over candidate configs and picks the cheapest
     conflict-free one, which parameterizes the kernels
     (n_banks for amm_gather / kv_decode) and the cluster-level shard
     layout (bank = shard).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.cost import memory_cost
from repro_torch.core.locality import spatial_locality_np

AMM_LOCALITY_THRESHOLD = 0.3   # paper IV-C


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    stream: str
    locality: float
    use_amm: bool
    n_banks: int
    n_read_ports: int
    est_area_mm2: float
    note: str = ""


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    arch: str
    shape: str
    streams: tuple[StreamPlan, ...]

    def for_stream(self, name: str) -> StreamPlan | None:
        for s in self.streams:
            if s.stream == name:
                return s
        return None


# ----------------------------------------------------------------------
# Trace synthesis per stream
# ----------------------------------------------------------------------
def embedding_stream(arch: ArchConfig, n: int = 8192,
                     zipf_alpha: float = 1.2, seed: int = 0) -> np.ndarray:
    """Token-id gather addresses into the (sharded) embedding table."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, arch.padded_vocab + 1, dtype=np.float64)
    p = ranks ** (-zipf_alpha)
    p /= p.sum()
    ids = rng.choice(arch.padded_vocab, size=n, p=p)
    return ids.astype(np.int64)                 # unit = one table row


def expert_stream(arch: ArchConfig, n: int = 8192, seed: int = 1
                  ) -> np.ndarray | None:
    if arch.n_experts == 0:
        return None
    rng = np.random.default_rng(seed)
    # router skew: realistic MoE routing is mildly zipfian over experts
    ranks = np.arange(1, arch.n_experts + 1, dtype=np.float64)
    p = ranks ** -0.7
    p /= p.sum()
    e = rng.choice(arch.n_experts, size=n, p=p)
    return e.astype(np.int64)                   # unit = one expert bank


def kv_stream(arch: ArchConfig, shape: ShapeConfig, n: int = 8192,
              page: int = 16, seed: int = 2) -> np.ndarray | None:
    """Paged-KV read stream at decode: each step walks every page of a
    random subset of sequences (continuous batching makes the page walk
    interleave across sequences -> low spatial locality)."""
    if not arch.has_attention or not shape.is_decode:
        return None
    rng = np.random.default_rng(seed)
    n_pages = max(shape.seq_len // page, 1)
    seqs = rng.integers(0, max(shape.global_batch, 1), size=n)
    pages = rng.integers(0, n_pages, size=n)   # pages allocated non-contig
    return (seqs * n_pages + pages).astype(np.int64)  # unit = one KV page


# ----------------------------------------------------------------------
def _choose(stream: str, addrs: np.ndarray, depth: int,
            width_bits: int) -> StreamPlan:
    L = spatial_locality_np(addrs)
    use_amm = L < AMM_LOCALITY_THRESHOLD
    depth = max(64, 1 << (int(depth) - 1).bit_length())
    if use_amm:
        candidates = [AMMSpec("hb_ntx", r, 2, depth, width_bits)
                      for r in (2, 4)] + \
                     [AMMSpec("lvt", r, 2, depth, width_bits) for r in (2, 4)]
        costed = sorted(candidates, key=lambda s: memory_cost(s).area_mm2)
        best = costed[0]
        nb = best.leaf_banks()[0]
        return StreamPlan(stream, float(L), True, nb, best.n_read,
                          memory_cost(best).area_mm2,
                          f"AMM {best.kind} (L={L:.3f} < 0.3)")
    nb = 8
    spec = AMMSpec("banked", 2 * nb, 2 * nb, depth, width_bits, n_banks=nb)
    return StreamPlan(stream, float(L), False, nb, 2 * nb,
                      memory_cost(spec).area_mm2,
                      f"banked (L={L:.3f} >= 0.3)")


def plan_memory(arch: ArchConfig, shape: ShapeConfig) -> MemoryPlan:
    streams: list[StreamPlan] = []
    emb = embedding_stream(arch)
    streams.append(_choose("embedding", emb, arch.padded_vocab, 64))
    es = expert_stream(arch)
    if es is not None:
        streams.append(_choose("moe_experts", es, max(arch.n_experts, 64), 64))
    ks = kv_stream(arch, shape)
    if ks is not None:
        streams.append(_choose("kv_pages", ks,
                               shape.global_batch * shape.seq_len // 16, 64))
    if arch.family in ("ssm", "hybrid"):
        # SSM state walk is dense/stride-1: locality ~ 1 -> banking; the
        # paper's technique is *inapplicable in its benefit regime* here.
        addrs = np.arange(4096, dtype=np.int64)  # unit-stride state walk
        sp = _choose("ssm_state", addrs, 4096, 32)
        streams.append(dataclasses.replace(
            sp, note=sp.note + "; AMM inapplicable for stride-1 state walks"))
    return MemoryPlan(arch.name, shape.name, tuple(streams))
