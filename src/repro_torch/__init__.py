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

And it holds the DSE's timing path: the benchmark traces
(``core.bench``), their one-time analysis (``core.sim.prepared``), and
the batched timing backend (``core.sim.batched_cycle``), which
schedules every design lane of a grid in one launch of the hand-written
lane-loop kernel (``kernels.cycle_lanes``, one CTA a lane); the sweep
costs the schedules and reduces them to Pareto fronts (``core.dse``).

And it trains (``launch.train``): the train step (``launch.steps``:
loss, autograd, AdamW from ``optim``, with microbatch accumulation),
the synthetic corpus (``data``), checkpoints in the JAX package's
on-disk layout (``checkpoint``) and the fault-tolerance runtime
(``runtime``).  The SSD chunk kernel's forward runs in the train step
and its backward is the plain version's, under autograd
(``kernels.ssd_scan.SSDChunk``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a kernel wrapper given a CPU tensor takes the
kernel's plain PyTorch version, and given a CUDA tensor launches the
kernel or raises.
"""
