"""PyTorch + CUDA port of the AMM reproduction, for one NVIDIA Hopper
card.

It mirrors ``src/repro/`` (the JAX reference) module by module.  This
package holds the serving-memory path: the planner scores each LM
serving stream with the paper's locality law (``memory.planner``), the
embedding gather runs through the hand-written H-NTX-Rd XOR-banked
gather (``kernels.amm_gather``) and the KV decode read through the
banked flash-decode kernel (``kernels.banked_kv_decode``).  It also
serves Mamba2 (``launch.serve`` -> ``models.lm`` -> ``models.ssm``),
whose chunked SSD scan runs every chunk through the hand-written chunk
kernel (``kernels.ssd_scan``).  Kernel sources live in ``csrc/`` and
are built with nvcc on first use.

It also holds the paper's functional AMM models: the whole-trace replay
engine (``core.amm.replay``: every design kind's flat state, batched on
a leading lane axis, with fault injection), the per-step models behind
``core.amm.make_amm``, and the fault layer (``core.fault``: seeded
campaigns of bit flips, stuck-at bits and bank losses, classified by
each design's own redundancy), which fills the DSE points' ``res_*``
fields.  ``kernels.ref.amm_gather_replay_ref`` runs the gather as a
replay of the H-NTX-Rd model, the oracle the gather kernel is held to.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a kernel wrapper given a CPU tensor takes the
kernel's plain PyTorch version, and given a CUDA tensor launches the
kernel or raises.
"""
