#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA Hopper card
(sm_90a) and nvcc.  Phases, each of which fails the run if a check
fails:

1. card and build: the card's name and power limit, then nvcc builds
   every kernel of ``src/repro_torch/csrc/`` into ``build/`` (set-up);
2. ``amm_gather`` at qwen3-1.7b's width: a [151936, 2048] bf16 table,
   65536 token ids from the planner's embedding stream, 8 banks; the
   kernel is bit-equal to its plain version, and so is a small int32
   case whose parity plane is not the XOR of its banks; its bound counts
   the rows the reconstruction path reads; then the bytes the call moves
   at the L2 (one row an even slot, NB an odd one, one written a slot)
   and their rate, its time with the L2 flushed before each run, and
   nvcc's ``-Xptxas -v`` lines for the gather kernels, which must show
   no spill;
3. ``kv_decode`` at decode_32k and qwen3-1.7b's width (Hq 16, Hkv 8,
   D 128, S 32768, batch 128, bf16) with the planner's KV bank plan;
   ragged lengths with one empty and one full row; within one bf16
   rounding of the plain version (see ``BF16_ATOL``), the empty row
   exactly 0; an f32 case at S 32768 (32 splits a row) within 1e-5;
   then the split-bank design's numbers: tile, split and CTA counts,
   achieved GB/s and share of the bound, the split and combine kernels'
   device times from one profiled call, and nvcc's ``-Xptxas -v`` lines
   for the decode kernels, which must show no spill;
4. the slice end to end: 4 decode steps, each an embedding lookup
   through ``banked_embedding_lookup``, an ``append`` and a
   ``decode_read``, held against the same steps on the plain versions;
   both kernels' launch counts must rise in this run;
5. ``ssd_chunk`` at mamba2-130m's chunk (Bt 8, H 24, Q 256, P 64,
   N 128, f32), an odd shape (Bt 2, H 3, Q 12, P 8, N 6) and bf16 x:
   the kernel within atol 1e-4 + rtol 1e-5 of its plain version (y of
   bf16 x within one bf16 step, rtol 2**-7, since both round it once);
   then its route (split-TF32 on the tensor cores) with its bound and
   the f32 CUDA-core bound, the device time and CTA count of each of its
   three kernels (C B^T, y, h_out) from one profiled call, and the
   ``-Xptxas -v`` lines, which must show no spill;
6. Mamba2 serving at full width (24 layers, bf16 compute, random
   weights from seed 0): ``repro_torch.launch.serve.main`` with batch 8,
   prompt 4096 and 16 greedy decode steps must launch the SSD kernel
   24 x 16 = 384 times; then, with the same weights (layer weights
   rounded through bf16), prefill-then-decode must equal ``forward``
   over t+1 tokens within 2e-2 in bf16 (the reference's own limit) and
   1e-3 in f32, and an f32 prefill on the card (kernel) must equal the
   port's prefill on the CPU (plain versions) within 1e-3; last the
   prefill and decode times and the prefill's device-time split;
7. the AMM replay engine and the fault campaigns: (a) the 8 campaigns of
   ``tests/golden_faults.json`` (``FaultConfig(32, 96, seed=7)`` at
   256 x 32 b) run on the card and must equal their golden rows in every
   count, rate, latency and outcome; (b) the same 8 designs at the
   largest campaign the repo documents (128 faults x 256 cycles, seed 7)
   on the card and on the CPU, which must agree on the resilience
   record, the outcomes and the faulty batch's direct and parity reads
   bit for bit; per design the campaign's wall time on each, the device
   kernels a cycle of the faulty replay launches (``torch.profiler``)
   and the device's busy share of that replay; (c) the replay-backed
   gather oracle at qwen3-1.7b's width (a [151936, 2048] bf16 table, the
   first 4096 ids of phase 2's stream: 2048 H-NTX-Rd 2R1W instances,
   one a column, 2048 two-read cycles) bit-equal to the CUDA gather (8
   banks) and to ``table[idx]``, with its time and launches;
8. the batched timing backend (``cycle_lanes``, one CTA a design lane):
   (a) the 390 TINY rows of ``tests/golden_schedule.json``, one launch a
   benchmark, equal row for row, and their event logs legal under the
   port's legality checker (``core/verify``: 0 violations); (b) the
   path: the full-size DSE matrix, 15 benchmarks x 20 designs x unrolls
   1, 2, 4, 8 through ``schedule_batched``, one launch of 80 lanes a
   benchmark, equal to ``tests/golden_schedule_full.json`` row for row,
   with each launch's device time (CUDA events around the wrapper), the
   most cycles a lane simulated and the time a simulated cycle; the
   byte bound and the serial floor (the most cycles of each launch times
   the card's time for one barrier of a 512-thread CTA, measured here);
   then, for each benchmark, the profiling instantiation's split of its
   slowest lane's SM clocks over the kernel's phases (retire, rank, FU
   issue and candidates, deferral scan, clock); (c) on bfs_queue at full
   size, the kernel equal to its plain version on the host CPU in
   results, remap maps and event logs, with the plain version's time
   and the kernel's on the same inputs (``plain_inputs_ms`` in the
   ``kernels`` line: ``ms`` is the whole matrix of (b)), its 80 event
   logs legal, and sort_merge's 80 lanes recorded on the card, equal to
   their golden rows, their event logs legal;
   (d) ``evaluate_points`` over the grid on the card for paged_kv: its
   ``DSEPoint``s and Pareto fronts equal to those of the golden rows
   through ``point_from_schedule``; (e) the kernels' ``-Xptxas -v``
   lines, which must show no spill;
9. the DSE's own entry point and Fig 5: (a) the cold pass,
   ``run_sweep_bench(name, full=True)`` for the 15 benchmarks over a
   fresh cache under ``build/`` (the grid of ``benchmarks/run.py --only
   fig5_locality --full``), one ``cycle_lanes`` launch a benchmark
   (counted from 0 just before the pass), every point equal to its golden
   row of ``tests/golden_schedule_full.json`` folded through
   ``point_from_schedule``, with each benchmark's host wall time; (b) the
   warm pass, the same calls: the manifest's fast path on every
   benchmark, 1200 hits and 0 misses, no trace generated and no launch;
   (c) Fig 5: each benchmark's ``L_spatial``, performance ratio,
   expansion, nodes and memory operations, and the Spearman rho of
   locality against the ratio and against the expansion, each equal to
   the same numbers computed from the golden rows' points, and the
   card's ``spatial_locality_torch`` over every array's address stream,
   weighted as ``trace_locality`` weights it, within 1e-9 of the trace's
   locality; (d) ``run_sweep(check=True)`` on full-size bfs_queue and
   paged_kv (0 legality violations), and a cache entry whose cycles were
   edited, its sha256 recomputed, caught by the audit (``LegalityError``);
   (e) ``python -m repro_torch.core.dse.runner --bench md_knn --full
   --check`` in a subprocess: its CSV rows equal to the points of (a),
   its ``#`` lines printed; (f) every benchmark's ``run_torch`` on the
   card at ``Params()`` against its numpy reference
   (``tests/_torch_bench_calls.py``), with its device time;
10. the attention families at full width, random weights from seed 0,
   with every kernel's launch count set to 0 before each path and read
   after it (the attention path runs none of the port's kernels, and
   each count must stay 0): (a) qwen3-1.7b (28 layers, d_model 2048,
   Hq 16, Hkv 8, head dim 128, vocab 151936, nothing cut) through
   ``repro_torch.launch.serve.main`` with batch 8, prompt 4096 and 16
   greedy steps; then, with the same weights, the prefill and decode
   times (host clock, fenced) beside their bounds (the prefill's bf16
   products at the bf16 peak plus its f32 block-scan attention, every
   block computed, at the f32 peak; the decode step's f32 params and
   bf16 K/V at the HBM rate), the decode step's and the prefill's busy
   share and top device operations (``torch.profiler``); with the layer
   weights rounded through bf16, prefill-then-decode against ``forward``
   over t+1 tokens at B 2 x S 512 within 2e-2 in bf16 (the absolute term
   relative to the logits' scale, ``hold_logits``) and 1e-3 in f32,
   and an f32 prefill plus three decode steps on the card against the
   port on the CPU at B 1 x S 32 within 1e-3, the third at
   ``cache_len == S_max``, then the K/V caches; (b) minicpm3-4b (MLA, 62
   layers) served with ``--mla-absorb`` at batch 4, prompt 1024, 8
   steps, then decoded 8 steps with and without the absorption from
   clones of one prefill's cache (the same tokens fed): bf16 logits
   within 2e-2, one f32 step within 1e-4, both step times; (c)
   moonshot-v1-16b-a3b (MoE, 64 experts, top-6) at full width with 4 of
   its 48 layers (48 would not fit the card): prefill and decode times
   at batch 4, prompt 1024, 8 steps; a finite ``aux`` from ``forward``;
   prefill-then-decode against ``forward`` at B 2 x S 256 within 2e-2
   in bf16 and 1e-3 in f32 at a capacity that drops nothing, and, for
   the record, the gap at the published capacity, where the forward
   drops choices that the decode keeps;
11. the hybrid, vlm and audio families at full width, random weights
   from seed 0, every kernel's launch count set to 0 before each path
   and read after it (``ssd_chunk`` runs in zamba2's prefills and
   forwards only, and must launch once a chunk of each Mamba2 layer
   there; every other count must stay 0): (a) zamba2-2.7b (54 Mamba2
   layers, d_model 2560, 80 SSD heads of 64, state 64, chunk 256; the
   shared attention block every 6 layers, 32 heads of 80; vocab 32000,
   tied; nothing cut) through ``serve.main`` with batch 8, prompt 4096
   and 16 steps, which decodes from an empty cache as the JAX
   package's serve.py does (no SSD chunk); then the prefill at B 8 x S 4096, which must
   launch ``ssd_chunk`` 54 x 16 = 864 times, and 16 decode steps from
   its cache, timed (host clock, fenced) beside their bounds, with their
   busy shares and top device operations; the SSD kernel at zamba2's
   chunk (Bt 8, H 80, Q 256, P 64, N 64) within atol 1e-4 + rtol 1e-5
   of its plain version, with its time and split-TF32 bound; with the
   layer weights rounded through bf16, 256 decode steps from an empty
   cache against ``forward`` over the 256 tokens at every position, B 2,
   within 1e-3 in f32, and in bf16 within 1.25 x the bf16 forward's own
   distance from the f32 forward (at this depth bf16 rounding alone
   exceeds the 2e-2 limit; the share of it is printed), since the
   hybrid's prefill skips the shared block, as the reference's does, so
   prefill-then-decode is not an identity; an f32 prefill plus three
   decode steps on the card against the port on the CPU at B 1 x S 32
   within 1e-3, then ``ssm_h``, ``ssm_conv``, ``shared_k`` and
   ``shared_v``; (b) internvl2-1b (24 layers, d_model 896, 14 query and
   2 KV heads of 64, vocab 151655, 256 patches of 1024; nothing cut)
   served with its patches at batch 8, prompt 4096, 16 steps, its
   prefill and decode timed as (a)'s; ``forward`` and ``loss_fn`` with
   the 256 patches at B 1 on the card and on the CPU in f32 within
   1e-3; prefill-then-decode against ``forward`` with no patches
   ([B, 0, 1024]) at B 2 x S 512 within phase 10's limits; (c)
   seamless-m4t-medium (12 encoder and 12 decoder layers, d_model 1024,
   16 heads of 64, gelu MLP without a gate, vocab 256206, untied head;
   nothing cut) served against a zero cross cache as the JAX
   package's serve.py does, then a prefill with frames [8, 512, 1024] at prompt 4096 and
   16 decode steps timed as (a)'s; prefill-then-decode against
   ``forward`` at B 2 x S 512 with 64 frames (all of which the cross
   cache holds) within phase 10's limits; an f32 prefill over 24 frames
   (16 of them cached) plus three decode steps on the card against the
   CPU within 1e-3, then the self and cross K/V caches;
12. training, every kernel's launch count set to 0 before each path and
   read after it (only mamba2-130m's steps launch ``ssd_chunk``, once
   a chunk of each layer in the forward; the backward is the plain
   version's, under autograd): (a) mamba2-130m at full width (24
   layers, d_model 768, 24 SSD heads of 64, state 128, chunk 256, vocab
   50280; nothing cut) through ``repro_torch.launch.train.main`` at
   batch 8, seq 1024, 20 steps, remat none, accum 1: the loss must fall
   and ``ssd_chunk`` launch 24 x 4 = 96 times a step; (b) one
   ``make_train_step`` step of it at B 1 x S 512 under an f32 policy,
   from one set of weights and one ``SyntheticCorpus`` batch, on the
   card (the kernel's forward) and on the CPU (the plain version): the
   loss and ``grad_norm`` within 1e-3 relative, every gradient leaf
   finite and nonzero on the card and within 1e-3 relative L2 of the
   CPU's, the updated params moving the same way but on at most 1e-3 of
   their entries (at step 1 an update is lr x sign(g)) and by at most
   2 lr + 1e-6 anywhere; (c) m100 through ``train.main`` (12 layers,
   d_model 640, vocab 16384; nothing cut) at the reference's defaults
   (batch 8, seq 128, 50 steps) must learn, a 16-step
   ``--simulate-failure 8`` run restore and finish, a 20-step
   ``--compress-grads`` run learn; its checkpoint restores bit-equal on
   the card and the CPU, and a state
   written from the card (a bf16 leaf among it) restores on the CPU
   bit-equal; (d) for (a)'s shape and m100: the step's host-clock ms
   (fenced, median of 3) and ``train.main``'s steady step, tokens/s, the
   device's busy share of a profiled step, the peak memory, and a bound
   of 6 x params x tokens at the bf16 peak plus, for mamba2, 3
   (split-TF32) x (forward + 2 x forward for the backward) x the SSD
   chunks' flops at the TF32 peak; the SSD kernel's forward launches
   and device ms in the step; (a)'s step split by ``torch.profiler``
   into forward, backward and AdamW; the plain backward of one chunk at
   (a)'s shape.
13. the surrogate-pruned sweep, every kernel's launch count set to 0
   before (a) and read after it: (a) ``run_sweep_bench(name, full=True,
   prune="surrogate")`` for the 15 benchmarks over a fresh cache under
   ``build/``, exactly 15 ``cycle_lanes`` launches (the 12 calibrated
   benchmarks' bands under the front cap, the 3 serving benchmarks'
   exhaustive fallbacks), each band the port's ``select_band`` of the
   grid, the returned points exactly those the cap's rule
   (``batched_cycle.front_capped``) keeps on the band's golden cycles
   (301 of 340, and the 240 fallback points), every point equal to its golden
   row, the time/area front that of the 80 golden points; per benchmark
   the band, the points kept and capped, the launch's kernel ms against
   phase 8's 80-lane launch, its slowest lane (profiling instantiation)
   and the time/power front's equality (information only), and the cold
   pass's host seconds against phase 9's; (b) ``check=True`` on one pruned
   benchmark, 0 legality violations; (c) ``python -m
   repro_torch.core.dse.runner --bench md_knn --full --front-only``
   with and without ``--prune surrogate`` in subprocesses, each with a
   fresh ``--cache-dir`` and one shared, fresh ``REPRO_CACHE_DIR``: the
   same CSV rows, the second run reading its trace from the file the
   first wrote.  (The whole smoke keeps its traces under
   ``build/trace_cache``.)
14. the mesh, on a one-rank NCCL process group: (a) mamba2-130m at full
   width (B 8 x S 1024, remat none) trained 3 steps as a sharded
   program: params and AdamW state DTensors placed by ``param_pspecs``
   on a (1, 1) ("data", "model") mesh, the batch by ``input_pspecs``,
   the step under ``activation_sharding``; the SSD kernel reached through
   DTensor and ``local_map``, exactly 24 x 4 = 96 launches a step (the
   counts set to 0 before each step and read after it); the sharded
   step's host-clock ms beside the plain step's; an f32 step and its
   gradients at B 1 x S 512, sharded against plain on the card, within
   phase 12's gates (loss and grad_norm 1e-3 relative, every gradient
   leaf 1e-3 relative L2, at most 1e-3 of the updates flipped); (b)
   ``pipeline_apply`` at P 1 on a "pod" mesh: 4 microbatches of B 2 x
   S 4096 through the 24 blocks equal the model's own block loop within
   1e-5 relative, in exactly 24 x 16 x 4 = 1536 SSD launches; (c)
   ``compressed_pod_mean`` of (a)'s gradients on a one-rank "pod" group:
   each tensor within half its int8 step (plus 1e-4 of a step for the
   f32 scale), and the payload the counters read
   at most 0.6x the bf16 all-reduce's; (d) ``python -m
   repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
   --both-meshes`` in a subprocess on the host (a fake world of 256 and
   512 ranks): both rows ``ok``, ``state_bytes_per_device`` equal to
   ``DRYRUN_STATE_BYTES``, the reference dry run's values, which
   ``tests/test_torch_sharding.py`` holds these constants to; the
   dominant term and the trace seconds printed.
15. the autotuner: ``autotune.tune`` over ``standard_problems`` (the
   reference's six small shapes and the main path's four: the gather of
   phase 2, the decode of phase 3, the SSD chunk of phase 5 and
   zamba2-2.7b's) into a dict, never into the repo's table; every
   candidate's output held against the plain version before its time
   counts; per problem the candidate count, the default's and the
   chosen configuration's us.  The checked-in table must have an entry
   for each main-path problem under this card's name, phases 2, 3 and 5
   must have launched with the table's configuration, which must read
   no slower than the default by more than 3% in this run, and no
   kernel instantiation may spill.
16. the port's copies of the repo's scripts, each loaded by path and its
   ``main`` called in this process with every kernel's launch count set
   to 0 before the call and read after it: (a)
   ``examples/quickstart_torch.py`` on the card (two ``cycle_lanes``
   launches, one a sweep) and with ``--device cpu``, both stdouts equal
   to ``examples/quickstart.py``'s (``QUICKSTART_STDOUT``) byte for
   byte; (b) ``examples/dse_machsuite_torch.py md_knn --full`` over a
   fresh ``--cache-dir`` under ``build/``: one launch, the 80 points
   equal to md_knn's rows of ``tests/golden_schedule_full.json``, the
   banked and AMM fronts, the expansion and the ratio those of the
   golden points; run again: 80 cache hits, no launch, the same
   stdout; (c) ``tools/check_legality_torch.py`` over the 390 TINY
   golden rows: one launch a benchmark, 0 violations, the static bounds
   tight on 68 rows (as ``tools/check_legality.py --backends c``
   finds), exit status 0; (d) ``examples/serve_lm_torch.py`` with its
   defaults (qwen3-1.7b, tiny: no kernel) and with ``--arch
   mamba2-130m`` (the SSD kernel once a chunk of each layer of the
   64-token prefill, 2 x 4 = 8): 4 x 32 tokens each; (e)
   ``examples/train_lm_torch.py --steps 160`` from an empty checkpoint
   directory: the simulated failure at step 150 recovered, 160 steps,
   the loss falling, no kernel.  Each sub-phase's seconds are printed.

Every time is a median of device time between CUDA events (see
``time_ms``).  It then prints the ``kernels`` JSON line (kernel, plain,
library and bound times; for the three tuned kernels the launch
``config`` and, where it is not the default, the default's time in this
run, ``default_ms``; phase 16's launches by script,
``scripts_launches``), and last ``{"ok": true, "device": {...}}``.  It exits
non-zero, printing no result, when there is no CUDA device or the
package is missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
SPIN_CYCLES = 35_000_000      # ~20 ms at the H100's 1.755 GHz boost clock
L2_BYTES = 50 * 2**20         # H100 L2 cache
ARCH = "qwen3-1.7b"
SHAPE = "decode_32k"
GATHER_IDS = 65536
GATHER_BANKS = 8              # the planner asks for 9, see phase 2
DECODE_STEPS = 4
# kv_decode in bf16, kernel against plain version.  Both sum in f32 and
# round once to bf16, so they differ by at most one bf16 step of the
# output (at most 2**-7 of it) plus the f32 order difference, far below
# 1e-4.  At S 32768 the outputs are softmax means of about 16k positions
# (typically 0.01-0.02), so the reference's 4e-2, set at S <= 128, would
# pass a kernel whose error is as large as its outputs.
BF16_ATOL = 1e-4
BF16_RTOL = 2.0 ** -7
SSM_ARCH = "mamba2-130m"
SERVE_BATCH = 8
SERVE_PROMPT = 4096           # 16 chunks of 256
SERVE_GEN = 16
# SSD chunk, kernel against plain: the reference's SSD tolerance (1e-4)
# plus an f32 order term
SSD_ATOL = 1e-4
SSD_RTOL = 1e-5
# prefill-then-decode against forward in bf16: tests/test_models.py's
# limit
E2E_TOL = 2e-2
# the same in f32, and an f32 prefill on the card against the CPU: 24
# layers of f32 sums taken in another order
F32_MODEL_TOL = 1e-3
F32_BATCH, F32_PROMPT = 2, 512
# phase 7: the golden campaigns' shape and the fault_campaign --full one
GOLDEN_FAULTS = pathlib.Path(__file__).resolve().parent / "tests" \
    / "golden_faults.json"
CAMPAIGN_DEPTH, CAMPAIGN_WIDTH = 256, 32
FULL_FAULTS, FULL_CYCLES, CAMPAIGN_SEED = 128, 256, 7
REPLAY_IDS = 4096             # 2048 two-read cycles of the gather oracle
# phase 8: the golden schedule files; the TINY matrix's designs and
# configurations come from tests/_torch_sched_util.py
REPO = pathlib.Path(__file__).resolve().parent
TESTS_DIR = REPO / "tests"
GOLDEN_SCHEDULE = TESTS_DIR / "golden_schedule.json"
GOLDEN_SCHEDULE_FULL = TESTS_DIR / "golden_schedule_full.json"
SCHEDULE_FIELDS = ("cycles", "issued", "mem_issued", "bank_conflict_stalls",
                   "parity_fanout_stalls", "write_pair_stalls",
                   "parity_path_reads", "write_pair_rmws")
PLAIN_BENCH = "bfs_queue"     # the smallest full trace: kernel vs plain
SWEEP_BENCH = "paged_kv"      # evaluate_points on the card
CHECK_BENCH = "sort_merge"    # the largest full trace: its logs checked
# phase 9: the benchmarks audited with event logs, and the CLI's
AUDIT_BENCHES = ("bfs_queue", "paged_kv")
CLI_BENCH = "md_knn"
# phase 13: the surrogate-pruned sweep; the benchmark its audit re-runs
PRUNE_AUDIT_BENCH = "spmv_crs"
# phase 10: the attention families, each at full width
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
ATTN_BATCH, ATTN_PROMPT, ATTN_GEN = 8, 4096, 16      # qwen3-1.7b
CHECK_BATCH, CHECK_PROMPT = 2, 512    # prefill-then-decode vs forward
CPU_BATCH, CPU_PROMPT = 1, 32         # the card against the CPU, f32
MLA_ARCH = "minicpm3-4b"
MLA_BATCH, MLA_PROMPT, MLA_GEN = 4, 1024, 8
# absorbed against expanded MLA decode in f32: tests/test_models.py's
# limit for the two modes
MLA_F32_TOL = 1e-4
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 4                # of 48: 553.6 M expert params a layer
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 1024, 8
MOE_CHECK_PROMPT = 256
# phase 11: the hybrid, vlm and audio families, each at full width, at
# phase 10's batch, prompt and check shapes
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_CHECK_T = 256          # decode steps from an empty cache: a chunk
VLM_ARCH = "internvl2-1b"
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_FRAMES = 512           # the served prefill's encoder frames
ENCDEC_CHECK_FRAMES = 64      # max(513 // 8, 16): every frame is cached
CPU_FRAMES = 24               # more than the 16 positions cached at S 35
# zamba2's bf16 decode against the f32 forward, at most this multiple of
# the bf16 forward's own distance from it (see phase 11a)
BF16_DEPTH_MARGIN = 1.25
# phase 12: training mamba2-130m at full width, 4 chunks a sequence
TRAIN_ARCH = "mamba2-130m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 20
GRAD_SEQ = 512                # the f32 card-vs-CPU step, B 1
# card against CPU in f32, per gradient leaf (relative L2), loss and
# grad_norm (relative): the SSD chunk's 1e-4 gate over 24 layers
GRAD_TOL = 1e-3
# the share of updated entries that may move the other way: at step 1 an
# update is lr * sign(g) (+ decay), which flips where g is near 0
FLIP_SHARE = 1e-3
# phase 14: the mesh; the sharded train step at phase 12's shape, the
# pipeline's microbatches, the dry run's cell and its time limit
MESH_STEPS = 3
PIPE_MB, PIPE_B, PIPE_S = 4, 2, 4096
PIPE_TOL = 1e-5
DRYRUN_ARGS = ("--arch", "qwen3-1.7b", "--shape", "train_4k",
               "--both-meshes")
DRYRUN_TIMEOUT = 300
# its state bytes a device on each mesh: the reference dry run's value
# (its _tree_bytes_sharded), which tests/test_torch_sharding.py holds
# these numbers to
DRYRUN_STATE_BYTES = {"pod16x16": 82132992, "pod2x16x16": 82132992}
# phase 16: the port's copies of the repo's scripts, loaded by path
SCRIPTS = {"quickstart": "examples/quickstart_torch.py",
           "dse_machsuite": "examples/dse_machsuite_torch.py",
           "check_legality": "tools/check_legality_torch.py",
           "serve_lm": "examples/serve_lm_torch.py",
           "train_lm": "examples/train_lm_torch.py"}
# examples/quickstart.py's whole stdout (the JAX package on the CPU)
QUICKSTART_STDOUT = (
    '4 parallel reads  : [  0   1 128 255]\n'
    'conflicting writes: 111 222 (via XOR ref re-pointing)\n'
    'parity-path read  : 222 (reconstructed from the other bank + Ref)\n'
    'built from 27 two-port banks of depth 32 (storage overhead 3.38x)\n'
    '1024-cycle replay vs RAM oracle: OK; parity path agrees: True\n'
    '\n'
    'kmp      L_spatial = 0.615\n'
    'md_knn   L_spatial = 0.084\n'
    'kmp      perf-ratio (banked area / AMM area, geomean) = 0.72  '
    '-> banking wins\n'
    'md_knn   perf-ratio (banked area / AMM area, geomean) = 0.75  '
    '-> banking wins\n'
    '\n'
    "The paper's law: AMM pays off when L_spatial < 0.3 (low locality).\n"
)
SCRIPT_BENCH = "md_knn"          # dse_machsuite --full
TINY_GOLDEN_ROWS = 390
TIGHT_ROWS = 68                  # tools/check_legality.py --backends c
SCRIPT_PROMPT = 64               # examples/serve_lm.py's --prompt-len
SCRIPT_BATCH, SCRIPT_GEN = 4, 32
TRAIN_LM_STEPS = 160             # past examples/train_lm.py's failure at 150
TRAIN_LM_FAILURE = 150


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int = 10, warmup: int = 2, before=None) -> float:
    """Median device time of ``fn`` in ms, each run fenced by CUDA
    events after a warm-up; ``before``, if given, runs before each run,
    outside its events.  The card first spins for about 20 ms, so the
    host queues every timed run before the first starts: the host's own
    time between runs (the Python wrapper around a kernel shorter than
    it) is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    pairs = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def hold_close(got: torch.Tensor, want: torch.Tensor, atol: float,
               rtol: float, what: str) -> "tuple[float, float, float]":
    """Check ``|got - want| <= atol + rtol * |want|`` everywhere; return
    the largest error, the largest ``|want|`` and the largest share of
    the limit that an element used."""
    err = (got.float() - want.float()).abs()
    share = (err / (atol + rtol * want.float().abs())).max().item()
    check(share <= 1.0, f"{what}: error {err.max().item():.3g} beyond "
          f"atol {atol:g} + rtol {rtol:g} * |want|")
    return err.max().item(), want.float().abs().max().item(), share


def hold_logits(got: torch.Tensor, want: torch.Tensor, tol: float,
                what: str) -> "tuple[float, float, float, float]":
    """``hold_close`` for bf16 logits, its absolute term taken relative
    to the logits' scale: ``|got - want| <= tol * max(1, max|want|) +
    tol * |want|``.  bf16 roundings upstream move every logit of a
    vector by about the same amount, a bf16 step of its largest
    entries: at moonshot's logits (magnitude ~4, an untied head) one
    step is 0.031, above a 2e-2 floor, on entries of every size.  At
    scales up to 1 this is ``hold_close``.  Returns its numbers, the
    absolute term, and for the record the share of the limit that a flat
    ``tol`` absolute term would give."""
    atol = tol * max(1.0, want.float().abs().max().item())
    flat = ((got.float() - want.float()).abs()
            / (tol + tol * want.float().abs())).max().item()
    return hold_close(got, want, atol, tol, what) + (atol, flat)


def bound_ms(n_bytes: float, n_flops: float = 0.0,
             flops_per_s: float = F32_FLOPS_PER_S) -> "tuple[float, str]":
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_spills(report: "list[dict]", names: "tuple[str, ...]",
                 what: str) -> None:
    """Print the ``-Xptxas -v`` record of every kernel in ``report``
    whose symbol holds one of ``names``; fail if there is none or one
    spills."""
    rows = [r for r in report if any(n in r["name"] for n in names)]
    for r in rows:
        print(f"ptxas {r['name']}: {r['registers']} registers, "
              f"{r['smem']} bytes static smem, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
    check(len(rows) > 0, f"no -Xptxas -v lines for the {what} kernels")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
              for r in rows), f"a {what} kernel spills registers")


def device_events(fn, tries: int = 5, expect: "tuple[str, ...]" = ()
                  ) -> "tuple[dict[str, tuple[int, float]], float]":
    """Run ``fn`` once under ``torch.profiler``: the launches and device
    ms of each device kernel (copies and fills included) by name, and
    the host-clock ms of the run.  Now and then the profiler records no
    device activity at all for a short run (one SSD chunk call, once in
    four smokes on the H100), or only some of its kernels (the SSD
    chunk's C B^T kernel missing, once in two smokes).  A run with no
    events, or with no kernel whose name holds one of ``expect``, is
    profiled again, up to ``tries`` times, and the callers' checks fail
    if it stays so."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            n, ms = events.get(e.key, (0, 0.0))
            events[e.key] = (n + e.count, ms + us / 1e3)
        missing = [x for x in expect if not any(x in k for k in events)]
        if events and not missing:
            break
        print(f"profiler: no device events recorded for {missing or 'any'} "
              f"kernel (try {attempt} of {tries})")
    return events, wall


def device_profile(fn, expect: "tuple[str, ...]" = ()
                   ) -> "tuple[dict[str, float], float]":
    """Device ms by kernel name of one run of ``fn``, and its host ms."""
    events, wall = device_events(fn, expect=expect)
    return {k: ms for k, (_, ms) in events.items()}, wall


def device_counts(fn) -> "tuple[int, int, float]":
    """One profiled run of ``fn``: its device kernel launches, their
    distinct names and their summed device ms."""
    events, _ = device_events(fn)
    total = sum(ms for _, ms in events.values())
    check(total > 0, "the profiler recorded no device time")
    return sum(n for n, _ in events.values()), len(events), total


def event_timed(fn, spans: list):
    """``fn`` with each call fenced by a pair of CUDA events, appended to
    ``spans`` (read them after a ``synchronize``)."""
    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out
    return timed


def wall_ms(fn, reps: int = 3):
    """Median host-clock ms of ``fn`` over ``reps`` runs, each fenced by
    ``torch.cuda.synchronize()``, and the last run's result."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def ssd_inputs(gen: torch.Generator, bt: int, h: int, q: int, p: int,
               n: int) -> tuple:
    """One SSD chunk's inputs on ``gen``'s device: dt in [1e-3, 1e-1],
    A = -linspace(1, 16, h) as the model's A_log gives it, cum =
    cumsum(dt A); normal x, B, C and h_in."""
    dev = gen.device
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((bt, h, q), generator=gen,
                                            device=dev)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    cum = torch.cumsum(dt * A[None, :, None], dim=-1)
    return (torch.randn((bt, h, q, p), generator=gen, device=dev), dt,
            cum, torch.randn((bt, q, n), generator=gen, device=dev),
            torch.randn((bt, q, n), generator=gen, device=dev),
            torch.randn((bt, h, p, n), generator=gen, device=dev))


def hold_ssd(ins: tuple, what: str, y_rtol: float = SSD_RTOL) -> tuple:
    """The SSD chunk kernel against its plain version on ``ins``: y
    within atol ``SSD_ATOL`` + rtol ``y_rtol``, h_out within ``SSD_ATOL``
    + ``SSD_RTOL``.  Returns (y, the larger max error)."""
    from repro_torch.kernels import ssd_chunk
    from repro_torch.kernels.ssd_scan import ssd_chunk_step_plain
    y, h_out = ssd_chunk(*ins)
    want_y, want_h = ssd_chunk_step_plain(*ins)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all() and torch.isfinite(h_out).all()),
          f"{what}: output not finite")
    ey = hold_close(y, want_y, SSD_ATOL, y_rtol, f"{what} y")
    eh = hold_close(h_out, want_h, SSD_ATOL, SSD_RTOL, f"{what} h_out")
    print(f"ssd {what}: y max err {ey[0]:.3g} (max |y| {ey[1]:.3g}, "
          f"{ey[2]:.3g} of the limit), h_out max err {eh[0]:.3g} (max "
          f"|h| {eh[1]:.3g}, {eh[2]:.3g} of the limit)")
    return y, max(ey[0], eh[0])


def ssd_work(bt: int, h: int, q: int, p: int, n: int
             ) -> "tuple[float, float]":
    """An SSD chunk's flops and bytes.  Flops are counted causally: the
    kernel skips j > i, whose terms are exactly 0.  The kernel's route
    runs every product as three TF32 tensor-core products (split
    precision), so its bound is 3x the flops at the TF32 rate; on f32
    CUDA cores it would be 1x at the f32 rate."""
    tri = q * (q + 1) / 2
    flops = bt * (2 * tri * n + h * (2 * tri * p + 4 * q * n * p))
    n_bytes = 4 * (2 * bt * h * q * p + 2 * bt * h * p * n
                   + 2 * bt * q * n + 2 * bt * h * q)
    return flops, n_bytes


def campaign_row(design: str, res) -> dict:
    """A campaign in ``tests/golden_faults.json``'s row layout (rates
    rounded to 9 places, as the file holds them)."""
    r = res.resilience
    return {"design": design, "spec": res.spec_label, "cover": r.cover,
            "n_faults": r.n_faults, "n_reads": r.n_reads,
            "benign": r.benign, "corrected": r.corrected,
            "detected": r.detected, "sdc": r.sdc,
            "sdc_rate": round(r.sdc_rate, 9),
            "corrected_frac": round(r.corrected_frac, 9),
            "detected_frac": round(r.detected_frac, 9),
            "det_latency": round(r.det_latency, 9),
            "outcomes": list(res.outcomes)}


def print_profile(what: str, by_kernel: "dict[str, float]", wall: float,
                  step_ms: float, top: int = 6) -> "tuple[float, float]":
    """Print a run's kernel time, idle share and largest kernels; return
    the SSD kernels' ms and all kernels' ms.  The idle share is 1 minus
    the profiled kernel time over ``step_ms``, the same step's time
    without the profiler, whose own cost would count as idle time."""
    total = sum(by_kernel.values())
    ssd = sum(ms for k, ms in by_kernel.items() if "ssd_" in k)
    if total == 0:
        print(f"{what}: the profiler recorded no device time")
        return ssd, total
    print(f"{what} (profiler, device): ssd_scan {ssd:.3f} ms of {total:.3f} "
          f"ms kernel time ({ssd / total:.1%}), rest {total - ssd:.3f} ms; "
          f"profiled wall {wall:.3f} ms, unprofiled step {step_ms:.3f} ms, "
          f"device idle {1 - total / step_ms:.1%} of the unprofiled step")
    for k, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.3f} ms  {k[:90]}")
    return ssd, total


def replay_and_faults(dev: torch.device, gen: torch.Generator,
                      ids: torch.Tensor, vocab: int, width: int) -> None:
    """Phase 7: the golden campaigns on the card, the largest documented
    campaigns on the card against the CPU, and the replay-backed gather
    oracle at a [vocab, width] bf16 table over ``ids``."""
    from repro_torch.core.amm import replay as rp
    from repro_torch.core.dse.sweep import DEFAULT_DESIGNS, _spec_for
    from repro_torch.core.fault import (FaultConfig, build_masks,
                                        campaign_draws, replay_campaign,
                                        run_campaign, tile_states)
    from repro_torch.kernels import amm_gather
    from repro_torch.kernels.ref import amm_gather_replay_ref

    by_label = {d.label: d for d in DEFAULT_DESIGNS}
    golden_rows = json.loads(GOLDEN_FAULTS.read_text())
    for row in golden_rows:
        spec = _spec_for(by_label[row["design"]], CAMPAIGN_DEPTH,
                         CAMPAIGN_WIDTH)
        res = run_campaign(spec, FaultConfig(32, 96, seed=CAMPAIGN_SEED),
                           device=dev)
        got = campaign_row(row["design"], res)
        check(got == row, f"golden campaign {row['design']} on the card: "
              f"{ {k: v for k, v in got.items() if row.get(k) != v} } "
              f"against {row}")
    print(f"campaigns: the {len(golden_rows)} golden campaigns (32 faults x "
          "96 cycles, seed 7, 256 x 32 b) equal tests/golden_faults.json "
          "on the card in every count, rate, latency and outcome")

    full = FaultConfig(FULL_FAULTS, FULL_CYCLES, seed=CAMPAIGN_SEED)
    for row in golden_rows:
        spec = _spec_for(by_label[row["design"]], CAMPAIGN_DEPTH,
                         CAMPAIGN_WIDTH)
        card_ms, card_res = wall_ms(lambda: run_campaign(spec, full, dev))
        cpu_ms, cpu_res = wall_ms(lambda: run_campaign(spec, full, "cpu"), 1)
        check(card_res == cpu_res, f"{row['design']}: the campaign on the "
              f"card {card_res} != on the CPU {cpu_res}")
        card_rep, cpu_rep = (replay_campaign(spec, full, d)[2]
                             for d in (dev, "cpu"))
        check(torch.equal(card_rep.read_vals.cpu(), cpu_rep.read_vals)
              and torch.equal(card_rep.parity_vals.cpu(),
                              cpu_rep.parity_vals),
              f"{row['design']}: faulty reads on the card != on the CPU")
        # the faulty replay alone, every input already on the card
        values, (ra, wa, wv, wm), faults = campaign_draws(spec, full)
        states = tile_states(spec, values, len(faults), dev)
        masks = build_masks(spec, faults, dev)
        trace = (torch.from_numpy(ra).to(dev), torch.from_numpy(wa).to(dev),
                 rp.words(wv, dev), torch.from_numpy(wm).to(dev))

        def faulty_replay():
            return rp.replay_faulty_batched(spec, states, masks, *trace,
                                            device=dev)

        replay_ms, _ = wall_ms(faulty_replay)
        n_ops, n_names, kernel_ms = device_counts(faulty_replay)
        r = card_res.resilience
        print(f"campaign {row['design']} ({spec.describe()}, {FULL_FAULTS} "
              f"faults x {FULL_CYCLES} cycles): card {card_ms:.3f} ms, cpu "
              f"{cpu_ms:.3f} ms (wall, whole campaign); equal on both, "
              f"faulty reads bit-equal; cover {r.cover}, sdc_rate "
              f"{r.sdc_rate:.6f}, corrected {r.corrected_frac:.6f}, "
              f"detected {r.detected_frac:.6f}, latency "
              f"{r.det_latency:.4f}")
        print(f"campaign {row['design']} faulty replay on the card: "
              f"{replay_ms:.3f} ms wall, {n_ops} device kernels "
              f"({n_ops / FULL_CYCLES:.1f} a cycle, {n_names} distinct), "
              f"{kernel_ms:.3f} ms of kernel time: device busy "
              f"{kernel_ms / replay_ms:.1%} of the unprofiled replay")
        del states, masks, trace, card_rep, cpu_rep

    torch.cuda.empty_cache()
    r_table = torch.randn((vocab, width), generator=gen, device=dev,
                          dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    oracle_ms, oracle = wall_ms(lambda: amm_gather_replay_ref(r_table,
                                                              ids), 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gathered = amm_gather(r_table, ids, n_banks=GATHER_BANKS)
    torch.cuda.synchronize()
    check(torch.equal(oracle.view(torch.int16), gathered.view(torch.int16)),
          "replay oracle != the CUDA gather")
    check(torch.equal(oracle.view(torch.int16),
                      r_table[ids.long()].view(torch.int16)),
          "replay oracle != table[idx]")
    del oracle
    n_oracle, _, oracle_kernel_ms = device_counts(
        lambda: amm_gather_replay_ref(r_table, ids))
    state_gb = width * 3 * (vocab // 2) * 4 / 1e9
    print(f"replay oracle [{vocab}, {width}] bf16, {len(ids)} ids: "
          f"{width} H-NTX-Rd 2R1W instances of depth {vocab} "
          f"({state_gb:.3f} GB of state), {len(ids) // 2} cycles; bit-equal "
          f"to the CUDA gather ({GATHER_BANKS} banks) and to table[idx]; "
          f"{oracle_ms:.3f} ms wall, {n_oracle} device kernels "
          f"({n_oracle / (len(ids) // 2):.1f} a cycle), "
          f"{oracle_kernel_ms:.3f} ms of kernel time (device busy "
          f"{oracle_kernel_ms / oracle_ms:.1%} of the unprofiled call), peak "
          f"{peak_gb:.3f} GB allocated")
    del r_table, gathered
    torch.cuda.empty_cache()


def schedule_row_matches(res, row: dict) -> bool:
    """A schedule result equals a golden row: every counter exactly,
    avg_mem_parallelism within the file's 1e-9."""
    return (all(getattr(res, f) == row[f] for f in SCHEDULE_FIELDS)
            and abs(res.avg_mem_parallelism - row["avg_mem_parallelism"])
            < 1e-9)


def golden_points(pt, full: list) -> list:
    """The full-size golden rows of ``pt``'s benchmark (the default
    designs x unrolls 1, 2, 4, 8, designs-major) folded into DSEPoints by
    ``point_from_schedule``, as the runner folds a schedule."""
    from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                            point_from_schedule,
                                            schedule_config_for)
    from repro_torch.core.sim import ScheduleResult
    grid = [(dp, u) for dp in DEFAULT_DESIGNS for u in DEFAULT_UNROLLS]
    rows = [g for g in full if g["bench"] == pt.trace.name]
    check([(g["design"], g["unroll"]) for g in rows]
          == [(dp.label, u) for dp, u in grid],
          f"{pt.trace.name}: golden rows out of the grid's order")
    return [point_from_schedule(
        pt, dp, u, schedule_config_for(pt, dp, u), ScheduleResult(
            per_array_accesses={},
            **{k: v for k, v in g.items()
               if k not in ("bench", "design", "unroll")}))
        for (dp, u), g in zip(grid, rows)]


def same_points(got: list, want: list) -> bool:
    """Equal DSEPoints, ``avg_mem_parallelism`` within 1e-9 (the golden
    file rounds it to 9 places)."""
    def same(a, b) -> bool:
        ra, rb = a.row(), b.row()
        return (abs(ra.pop("avg_mem_parallelism")
                    - rb.pop("avg_mem_parallelism")) < 1e-9 and ra == rb)
    return len(got) == len(want) and all(map(same, got, want))


def legal_logs(pt, cfgs, results, logs, what: str) -> float:
    """Check every event log with the port's legality checker
    (``core/verify``: the paper's arbitration rules re-derived from the
    specs, and the static cycle bounds); fail on any violation.  Returns
    the seconds the check took."""
    from repro_torch.core.verify import verify_result
    t0 = time.perf_counter()
    for lane, (cfg, res, ev) in enumerate(zip(cfgs, results, logs)):
        rep = verify_result(pt, cfg, res, ev, backend="cuda")
        check(rep.ok, f"{what} lane {lane}: {len(rep.violations)} "
              f"violations, first {rep.violations[:3]}")
    return time.perf_counter() - t0


def timing_backend(dev: torch.device) -> dict:
    """Phase 8: the batched timing backend.  (a) the TINY golden rows on
    the card, one launch a benchmark; (b) the full-size DSE matrix (the
    path: every benchmark's 80 design lanes in one ``schedule_batched``
    launch), equal to tests/golden_schedule_full.json; (c) kernel against
    plain at full width on bfs_queue, events and maps included; (d)
    ``evaluate_points`` over the grid on the card against the golden rows
    folded through ``point_from_schedule``; (e) no spill.  Returns the
    kernel's entry of the ``kernels`` line."""
    from repro_torch.core.bench import BENCHMARKS, get_trace
    from repro_torch.core.dse import pareto_front
    from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                            evaluate_points,
                                            schedule_config_for)
    from repro_torch.core.sim import prepare_trace
    from repro_torch.core.sim.batched_cycle import (LANE_PHASES,
                                                    profile_lanes,
                                                    schedule_batched)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.cycle_lanes import barrier_ms, cycle_lanes

    # (a) the 390 TINY golden rows, their event logs checked
    sys.path.insert(0, str(TESTS_DIR))
    from _torch_sched_util import golden_configs
    golden = json.loads(GOLDEN_SCHEDULE.read_text())
    t0 = time.perf_counter()
    check_s = 0.0
    for bench in BENCHMARKS:
        pt, rows, cfgs = golden_configs(bench)
        results, logs = schedule_batched(pt, cfgs, device=dev,
                                         collect_events=True)
        for g, res in zip(rows, results):
            check(schedule_row_matches(res, g),
                  f"TINY golden row {g} on the card: {res}")
        check_s += legal_logs(pt, cfgs, results, logs, f"TINY {bench}")
    print(f"schedule (a): the {len(golden)} TINY rows of "
          f"tests/golden_schedule.json equal on the card, one launch a "
          f"benchmark, and their {len(golden)} event logs legal: 0 "
          f"violations (core/verify; {check_s:.1f} s of "
          f"{time.perf_counter() - t0:.1f} s)")

    # (b) the path: the full-size matrix, one launch a benchmark
    full = json.loads(GOLDEN_SCHEDULE_FULL.read_text())
    grid = [(dp, u) for dp in DEFAULT_DESIGNS for u in DEFAULT_UNROLLS]
    prepared, configs = {}, {}
    t0 = time.perf_counter()
    for bench in BENCHMARKS:
        pt = prepared[bench] = prepare_trace(get_trace(bench, full=True))
        configs[bench] = [schedule_config_for(pt, dp, u) for dp, u in grid]
    prep_s = time.perf_counter() - t0
    # the kernel's device time: CUDA events around the wrapper's call
    spans = []
    wrapper = ops.cycle_lanes
    timed_cycle_lanes = event_timed(wrapper, spans)

    results, wall = {}, {}
    torch.cuda.synchronize()
    cycle_lanes.launches = 0
    ops.cycle_lanes = timed_cycle_lanes
    try:
        for bench in BENCHMARKS:
            t0 = time.perf_counter()
            results[bench] = schedule_batched(prepared[bench],
                                              configs[bench], device=dev)
            wall[bench] = time.perf_counter() - t0
    finally:
        ops.cycle_lanes = wrapper
    torch.cuda.synchronize()
    path_launches = cycle_lanes.launches
    check(path_launches == len(BENCHMARKS) == len(spans),
          f"cycle_lanes launched {path_launches} times for "
          f"{len(BENCHMARKS)} benchmarks")
    kernel_ms, most_cycles = {}, {}
    for (bench, res), (start, end) in zip(results.items(), spans):
        rows = [g for g in full if g["bench"] == bench]
        check(len(rows) == len(res) == len(grid),
              f"{bench}: {len(res)} results for {len(rows)} golden rows")
        for (dp, u), g, r in zip(grid, rows, res):
            check((g["design"], g["unroll"]) == (dp.label, u)
                  and schedule_row_matches(r, g),
                  f"full-size golden row {g} on the card: {r}")
        kernel_ms[bench] = start.elapsed_time(end)
        most = most_cycles[bench] = max(r.cycles for r in res)
        print(f"schedule (b) {bench}: {prepared[bench].n_nodes} nodes, "
              f"{len(res)} lanes, kernel {kernel_ms[bench]:.3f} ms, most "
              f"cycles a lane simulated {most}, "
              f"{kernel_ms[bench] * 1e6 / most:.1f} ns a simulated cycle, "
              f"schedule_batched {wall[bench] * 1e3:.1f} ms (host clock)")
    total_ms = sum(kernel_ms.values())
    # the serial floor: a lane's simulated cycles are a chain, and a
    # cycle of a CTA-wide lane costs at least one block barrier
    bar_ms, bar_clocks = barrier_ms(dev)
    floor_ms = bar_ms * sum(most_cycles.values())
    print(f"schedule (b): {len(full)} full-size rows of "
          f"tests/golden_schedule_full.json equal on the card; "
          f"{path_launches} launches, kernel {total_ms:.3f} ms in all; "
          f"traces and configs {prep_s:.1f} s (set-up); serial floor "
          f"{floor_ms:.3f} ms (the most cycles of each launch x "
          f"{bar_ms * 1e6:.2f} ns, {bar_clocks:.1f} SM clocks, for one "
          f"barrier of a 512-thread CTA; kernel "
          f"{total_ms / floor_ms:.3g}x the floor)")
    # where the slowest lane of each launch spends its cycles: the
    # profiling instantiation, launched outside the path's count
    for bench in BENCHMARKS:
        split = profile_lanes(prepared[bench], configs[bench], dev)
        dp, u = grid[split["lane"]]
        print(f"schedule (b) profile {bench}: slowest lane {split['lane']} "
              f"({dp.label} u{u}), {split['cycles']} cycles, "
              f"{split['visited']} visited, {split['clocks_per_visit']:.0f} "
              "SM clocks a visited cycle: "
              + ", ".join(f"{name} {share:.1%}" for name, share in
                          zip(LANE_PHASES, split["shares"]))
              + f"; scan {split['scan_pops']} pops in "
              f"{split['scan_rounds']} warp rounds; select "
              f"{split['select_words'] / split['visited']:.1f} bitmap words "
              f"a visit of {split['ready_words'] / split['visited']:.1f} "
              "non-empty; next slowest lanes "
              + ", ".join(f"{grid[r['lane']][0].label} u{grid[r['lane']][1]}"
                          f" ({r['clocks']} clocks)"
                          for r in split["slowest"][1:]))

    # (c) kernel against plain at full width, events and maps included
    pt, cfgs = prepared[PLAIN_BENCH], configs[PLAIN_BENCH]
    ops.cycle_lanes = timed_cycle_lanes
    try:
        card = schedule_batched(pt, cfgs, device=dev, return_maps=True,
                                collect_events=True)
    finally:
        ops.cycle_lanes = wrapper
    torch.cuda.synchronize()
    card_ms = spans[-1][0].elapsed_time(spans[-1][1])
    t0 = time.perf_counter()
    plain = schedule_batched(pt, cfgs, device="cpu", return_maps=True,
                             collect_events=True)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(card[0] == plain[0], f"{PLAIN_BENCH}: kernel results != plain")
    check(np.array_equal(card[1], plain[1]),
          f"{PLAIN_BENCH}: kernel remap maps != plain")
    check(all(a == b for a, b in zip(card[2], plain[2])),
          f"{PLAIN_BENCH}: kernel event logs != plain")
    err = max(max(abs(getattr(a, f) - getattr(b, f)) for f in SCHEDULE_FIELDS)
              for a, b in zip(card[0], plain[0]))
    check_s = legal_logs(pt, cfgs, card[0], card[2], PLAIN_BENCH)
    print(f"schedule (c) {PLAIN_BENCH} full, {len(cfgs)} lanes with events: "
          f"kernel == plain (results, {card[1].shape} remap maps, "
          f"{len(card[2])} event logs, legal: 0 violations, checked in "
          f"{check_s:.1f} s); on these inputs the kernel {card_ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms on the host CPU "
          f"({plain_ms / card_ms:.0f}x)")
    pt, cfgs = prepared[CHECK_BENCH], configs[CHECK_BENCH]
    results, logs = schedule_batched(pt, cfgs, device=dev,
                                     collect_events=True)
    check(all(schedule_row_matches(r, g) for r, g in zip(
        results, [g for g in full if g["bench"] == CHECK_BENCH])),
        f"{CHECK_BENCH}: recording run != the golden rows")
    check_s = legal_logs(pt, cfgs, results, logs, CHECK_BENCH)
    print(f"schedule (c) {CHECK_BENCH} full, {len(cfgs)} lanes with events: "
          f"equal to the golden rows; {len(logs)} event logs of "
          f"{pt.n_nodes} nodes legal: 0 violations (checked in "
          f"{check_s:.1f} s on the host CPU)")

    # (d) evaluate_points over the grid on the card against the golden
    # rows, folded
    pt = prepared[SWEEP_BENCH]
    points = evaluate_points(pt, [(dp, u) for dp in DEFAULT_DESIGNS
                                  for u in DEFAULT_UNROLLS], device=dev)
    want = golden_points(pt, full)
    check(same_points(points, want),
          f"{SWEEP_BENCH}: evaluate_points points != the golden rows' "
          "points")
    fronts = {}
    for family, keep in (("all", lambda p: True), ("amm", lambda p: p.is_amm),
                         ("banked", lambda p: not p.is_amm)):
        for cost, key in (("area", lambda p: p.area_mm2),
                          ("power", lambda p: p.power_mw)):
            got = pareto_front([p for p in points if keep(p)], key)
            ref = pareto_front([p for p in want if keep(p)], key)
            check([(p.design, p.unroll) for p in got]
                  == [(p.design, p.unroll) for p in ref],
                  f"{SWEEP_BENCH}: {family} {cost} front differs")
            fronts[f"{family}/{cost}"] = len(got)
    print(f"schedule (d) evaluate_points {SWEEP_BENCH} on the card: "
          f"{len(points)} DSEPoints and the Pareto fronts {fronts} equal "
          "to those of the golden rows")

    # (e) no spill
    check_spills(_build.ptxas_report("cycle_lanes"), ("cycle_lanes_kernel",),
                 "cycle_lanes")
    return {"name": "cycle_lanes", "route": "cuda",
            "source": "src/repro_torch/csrc/cycle_lanes.cu",
            "replaces": "src/repro/core/sim/jax_cycle.py:130 (_make_lane_fn; "
                        "lax.while_loop, not a Pallas kernel)",
            "launches": path_launches, "max_abs_err": float(err),
            "ms": total_ms, "kernel_ms": total_ms, "plain_ms": plain_ms,
            "plain_inputs_ms": card_ms, "launch_ms": kernel_ms,
            "serial_floor_ms": floor_ms,
            "library_ms": None}


def runner_and_fig5(dev: torch.device) -> dict:
    """Phase 9: the DSE's own entry point and Fig 5.  (a) the cold pass:
    ``run_sweep_bench`` for every benchmark at full size over a fresh
    cache, equal to the golden rows; (b) the warm pass, served from the
    cache with no trace generated and no launch; (c) the Fig-5 table and
    its rank correlations, equal to those of the golden rows' points,
    and the card's locality of every trace; (d) the audit, and an edited
    cache entry caught by it; (e) the CLI in a subprocess; (f) every
    benchmark's ``run_torch`` on the card against its numpy reference.
    Returns the launches of the cold pass and its times."""
    import os
    import shutil

    import repro_torch.core.bench as bench_mod
    from repro_torch.core.bench import BENCHMARKS, get_trace
    from repro_torch.core.dse import (design_space_expansion,
                                      performance_ratio, run_sweep,
                                      run_sweep_bench, spearman_rho)
    from repro_torch.core.dse.runner import SweepCache, point_key
    from repro_torch.core.dse.sweep import DEFAULT_DESIGNS, DEFAULT_UNROLLS
    from repro_torch.core.locality import spatial_locality_torch
    from repro_torch.core.sim import prepare_trace
    from repro_torch.core.verify import LegalityError
    from repro_torch.kernels.cycle_lanes import cycle_lanes
    sys.path.insert(0, str(TESTS_DIR))
    from _torch_bench_calls import bench_case, holds, max_abs_err

    full = json.loads(GOLDEN_SCHEDULE_FULL.read_text())
    n_points = len(DEFAULT_DESIGNS) * len(DEFAULT_UNROLLS)
    root = REPO / "build" / "dse_runner"
    shutil.rmtree(root, ignore_errors=True)
    cache_dir = root / "cache"
    # the golden rows' points (set-up; the traces are phase 8's, memoized)
    want = {b: golden_points(prepare_trace(get_trace(b, full=True)), full)
            for b in BENCHMARKS}

    # (a) the cold pass: every point a miss, one launch a benchmark
    cache = SweepCache(cache_dir)
    cold, cold_s = {}, {}
    torch.cuda.synchronize()
    cycle_lanes.launches = 0
    for bench in BENCHMARKS:
        t0 = time.perf_counter()
        cold[bench] = run_sweep_bench(bench, full=True, cache=cache,
                                      device=dev)
        cold_s[bench] = time.perf_counter() - t0
    launches = cycle_lanes.launches
    check(launches == len(BENCHMARKS),
          f"the cold pass launched cycle_lanes {launches} times for "
          f"{len(BENCHMARKS)} benchmarks")
    check((cache.hits, cache.misses) == (0, n_points * len(BENCHMARKS)),
          f"cold pass: {cache.hits} hits, {cache.misses} misses")
    for bench in BENCHMARKS:
        check(same_points(cold[bench], want[bench]),
              f"{bench}: run_sweep_bench's points != the golden rows'")
    print("runner (a) cold: " + ", ".join(
        f"{b} {s * 1e3:.1f}" for b, s in cold_s.items())
        + f" ms (host clock); {sum(cold_s.values()):.3f} s in all for "
        f"{cache.misses} points in {launches} launches of cycle_lanes, "
        "each point equal to its row of tests/golden_schedule_full.json "
        "(the traces were memoized by phase 8)")

    # (b) the warm pass: the manifest's fast path, no trace, no launch
    cache = SweepCache(cache_dir)
    traces = []
    real_get_trace = bench_mod.get_trace

    def counted_get_trace(*args, **kwargs):
        traces.append(args)
        return real_get_trace(*args, **kwargs)

    warm_s = {}
    cycle_lanes.launches = 0
    bench_mod.get_trace = counted_get_trace
    try:
        for bench in BENCHMARKS:
            stats: dict = {}
            t0 = time.perf_counter()
            pts = run_sweep_bench(bench, full=True, cache=cache, stats=stats,
                                  device=dev)
            warm_s[bench] = time.perf_counter() - t0
            check(stats == {"fast_path": True} and pts == cold[bench],
                  f"{bench}: the warm pass missed the fast path: {stats}")
    finally:
        bench_mod.get_trace = real_get_trace
    check((cache.hits, cache.misses) == (n_points * len(BENCHMARKS), 0)
          and not traces and cycle_lanes.launches == 0,
          f"warm pass: {cache.hits} hits, {cache.misses} misses, "
          f"{len(traces)} traces, {cycle_lanes.launches} launches")
    print(f"runner (b) warm: {sum(warm_s.values()):.3f} s in all (host "
          f"clock; {min(warm_s.values()) * 1e3:.1f}-"
          f"{max(warm_s.values()) * 1e3:.1f} ms a benchmark), "
          f"{cache.hits} hits, 0 misses, fast path on every benchmark, no "
          "trace generated, no launch")

    # (c) Fig 5: locality against the performance ratio
    table, golden_table = [], []
    loc_ms = 0.0
    for bench in sorted(BENCHMARKS):
        pt = prepare_trace(get_trace(bench, full=True))
        row = {"bench": bench, "nodes": pt.n_nodes,
               "mem_ops": pt.trace.n_mem, "L_spatial": pt.locality}
        for what, pts in (("port", cold[bench]), ("golden", want[bench])):
            r = dict(row, perf_ratio=performance_ratio(pts),
                     expansion=design_space_expansion(
                         [p for p in pts if not p.is_amm],
                         [p for p in pts if p.is_amm]))
            (table if what == "port" else golden_table).append(r)
        # the card's locality: each array's stream, weighted by accesses
        addrs, ids = pt.trace.mem_addrs_and_arrays()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, weight = 0.0, 0
        for aid in np.unique(ids):
            sel = ids == aid
            total += spatial_locality_torch(
                torch.from_numpy(addrs[sel]).to(dev)) * int(sel.sum())
            weight += int(sel.sum())
        loc_ms += (time.perf_counter() - t0) * 1e3
        card_l = total / max(weight, 1)
        check(abs(card_l - pt.locality) < 1e-9,
              f"{bench}: locality on the card {card_l!r} != "
              f"{pt.locality!r}")
        r = table[-1]
        print(f"fig5 {bench}: L_spatial {r['L_spatial']:.6f} (card "
              f"{card_l:.6f}), perf_ratio {r['perf_ratio']:.6f}, expansion "
              f"{r['expansion']:.6f}, nodes {r['nodes']}, mem_ops "
              f"{r['mem_ops']}")

    def same(a, b) -> bool:
        return a == b or (np.isnan(a) and np.isnan(b))

    check(all(same(a[k], b[k]) for a, b in zip(table, golden_table)
              for k in ("perf_ratio", "expansion")),
          "the Fig-5 numbers differ from the golden rows'")
    rhos = {}
    for what, t in (("port", table), ("golden", golden_table)):
        rhos[what] = (spearman_rho([r["L_spatial"] for r in t],
                                   [r["perf_ratio"] for r in t]),
                      spearman_rho([r["L_spatial"] for r in t],
                                   [r["expansion"] for r in t]))
    check(all(map(same, rhos["port"], rhos["golden"])),
          f"rho {rhos['port']} != the golden rows' {rhos['golden']}")
    rho, rho_exp = rhos["port"]
    n_ok = sum(np.isfinite(r["perf_ratio"]) for r in table)
    print(f"fig5: rho(L, perf_ratio) {rho:.6f}, rho(L, expansion) "
          f"{rho_exp:.6f} over {len(table)} benchmarks ({n_ok} finite "
          f"ratios); the paper's claim (rho < 0) holds: "
          f"{'indeterminate' if np.isnan(rho) else bool(rho < 0)}; equal "
          "to the golden rows' numbers; the card's locality of every "
          f"trace within 1e-9 of pt.locality ({loc_ms:.1f} ms host clock "
          f"for the {len(table)} traces' arrays)")

    # (d) the audit: re-scheduled with event logs, checked by core/verify
    for bench in AUDIT_BENCHES:
        pt = prepare_trace(get_trace(bench, full=True))
        cache = SweepCache(cache_dir)
        t0 = time.perf_counter()
        pts = run_sweep(pt, cache=cache, check=True, device=dev)
        check(pts == cold[bench] and cache.hits == n_points,
              f"{bench}: the audited sweep's points changed")
        print(f"runner (d) {bench}: run_sweep(check=True) over the cached "
              f"points: {len(pts)} event logs legal, 0 violations "
              f"({time.perf_counter() - t0:.2f} s host clock)")
    edited = root / "edited"
    pt = prepare_trace(get_trace("paged_kv", full=True))
    run_sweep(pt, cache_dir=edited, device=dev)
    dp, u = DEFAULT_DESIGNS[7], DEFAULT_UNROLLS[1]
    path = SweepCache(edited)._path(point_key(pt.fingerprint, dp, u, 2))
    entry = json.loads(path.read_text())
    entry["point"]["cycles"] += 1
    entry["sha256"] = SweepCache._digest(entry["point"])
    path.write_text(json.dumps(entry))
    try:
        run_sweep(pt, cache_dir=edited, check=True, device=dev)
        caught = ""
    except LegalityError as e:
        caught = str(e).splitlines()[1].strip()
    check("counter" in caught, "an edited cache entry passed the audit")
    print(f"runner (d) an entry of paged_kv ({dp.label} u{u}) with its "
          f"cycles edited and its sha256 recomputed: LegalityError, "
          f"{caught}")

    # (e) the CLI, in a process of its own
    cli_dir = root / "cli"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.dse.runner", "--bench",
         CLI_BENCH, "--full", "--check", "--cache-dir", str(cli_dir)],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the runner CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    rows = [ln for ln in lines if ln and not ln.startswith("#")]
    cols = [f.name for f in dataclasses.fields(cold[CLI_BENCH][0])]
    expect = [",".join(cols)] + [
        ",".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                 for v in (p.row()[c] for c in cols))
        for p in cold[CLI_BENCH]]
    check(rows == expect, "the CLI's CSV rows != the golden-equal points")
    print(f"runner (e) python -m repro_torch.core.dse.runner --bench "
          f"{CLI_BENCH} "
          f"--full --check: {len(rows) - 1} CSV rows equal to the points "
          f"of (a) ({cli_s:.1f} s host clock for the process)")
    for ln in lines:
        if ln.startswith("#"):
            print(f"runner (e) {ln}")

    # (f) every benchmark's run_torch on the card, at Params()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: gemm_ncubed's f32 product would use them")
    for bench in BENCHMARKS:
        call, ref = bench_case(bench, BENCHMARKS[bench].Params(), dev)
        got = call()
        torch.cuda.synchronize()
        check(all(g.device.type == dev.type for g in got)
              and holds(bench, got, ref),
              f"{bench}: run_torch on the card != its numpy reference "
              f"(largest error {max_abs_err(got, ref):.3g})")
        ms = time_ms(call, reps=5, warmup=1)
        print(f"run_torch {bench}: equal to its numpy reference (largest "
              f"error {max_abs_err(got, ref):.3g}), {ms:.3f} ms device "
              "time (for the record)")
    shutil.rmtree(root, ignore_errors=True)
    return {"runner_launches": launches,
            "runner_cold_s": sum(cold_s.values()),
            "runner_warm_s": sum(warm_s.values())}


def pruned_sweep(dev: torch.device, kernels: dict,
                 exhaustive_ms: "dict[str, float]", exhaustive_cold_s: float,
                 full: bool = True) -> dict:
    """Phase 13: the surrogate-pruned sweep.  (a) the cold pass,
    ``run_sweep_bench(name, full=True, prune="surrogate")`` for the 15
    benchmarks over a fresh cache, one ``cycle_lanes`` launch a benchmark
    (12 bands under the front cap, 3 exhaustive fallbacks): each band the
    port's ``select_band`` of the grid, the returned points exactly those
    the front cap's rule keeps on the golden cycles (301 of the 340 band
    points at full size), each equal to its golden row, the time/area
    front that of the 80 golden points; each band launch's kernel ms
    against phase 8's exhaustive launch, its slowest lane; (b) the audit
    of one pruned benchmark; (c) the CLI's ``--front-only`` rows with and
    without ``--prune surrogate``, the second run reading its trace from
    the on-disk cache.  Every kernel's launch count is set to 0 before
    (a) and read after it: ``cycle_lanes`` must launch once a benchmark,
    every other kernel never.  Returns the ``pruned`` record of the
    ``cycle_lanes`` entry.  ``full=False`` runs the TINY traces (a
    rehearsal on the CPU)."""
    import os
    import shutil

    import repro_torch.core.bench as bench_mod
    from repro_torch.core.bench import BENCHMARKS, get_trace
    from repro_torch.core.dse import (grid_predictions, pareto_front,
                                      run_sweep_bench, select_band)
    from repro_torch.core.dse.runner import SweepCache
    from repro_torch.core.dse.surrogate import CALIBRATED_BENCHES
    from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                            _point_static_cost,
                                            schedule_config_for)
    from repro_torch.core.sim import prepare_trace
    from repro_torch.core.sim.batched_cycle import (_lane_inputs,
                                                    front_capped,
                                                    front_eligible,
                                                    profile_lanes)
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    golden = json.loads(GOLDEN_SCHEDULE_FULL.read_text())
    root = REPO / "build" / "dse_pruned"
    shutil.rmtree(root, ignore_errors=True)
    grid = [(dp, u) for dp in DEFAULT_DESIGNS for u in DEFAULT_UNROLLS]
    pts = {b: prepare_trace(get_trace(b, full=full)) for b in BENCHMARKS}
    want = {b: golden_points(pts[b], golden) for b in BENCHMARKS}
    band = {}
    for b in BENCHMARKS:
        t0 = time.perf_counter()
        keep = select_band(grid_predictions(pts[b], DEFAULT_DESIGNS,
                                            DEFAULT_UNROLLS))
        rank_ms = (time.perf_counter() - t0) * 1e3
        band[b] = ([i for i, k in enumerate(keep) if k]
                   if b in CALIBRATED_BENCHES else list(range(len(grid))))
        print(f"pruned (a) {b}: surrogate band {sum(keep)} of {len(grid)} "
              f"({rank_ms:.1f} ms host clock to rank the grid)"
              + ("" if b in CALIBRATED_BENCHES else
                 "; not calibrated: the runner runs all 80"))
    # the front cap's order of each band (evaluate_points': stable
    # ascending area) and what its rule keeps on the golden cycles
    order, lanes, kept = {}, {}, {}
    for b in BENCHMARKS:
        if b not in CALIBRATED_BENCHES:
            kept[b] = band[b]
            continue
        stat = {i: _point_static_cost(schedule_config_for(pts[b], *grid[i]),
                                      grid[i][1]) for i in band[b]}
        order[b] = sorted(band[b], key=lambda i: stat[i][0])
        lanes[b] = [schedule_config_for(pts[b], *grid[i]) for i in order[b]]
        rule = front_capped([stat[i][0] for i in order[b]],
                            [stat[i][1] for i in order[b]],
                            [want[b][i].cycles for i in order[b]],
                            lanes[b][0].max_cycles,
                            front_eligible(lanes[b], _lane_inputs(
                                pts[b], lanes[b])[1]["desc"]))
        kept[b] = sorted(i for i, k in zip(order[b], rule) if k)
    n_cal_band = sum(len(band[b]) for b in order)
    n_cal_kept = sum(len(kept[b]) for b in order)
    if full:
        check((n_cal_kept, n_cal_band) == (301, 340),
              f"the front cap's rule keeps {n_cal_kept} of {n_cal_band} band "
              "points on the golden cycles, want 301 of 340")

    # (a) the cold pruned pass, each launch fenced by CUDA events
    spans = []
    wrapper = ops.cycle_lanes
    cache = SweepCache(root / "cache")
    got, cold_s = {}, {}
    torch.cuda.synchronize()
    zero_counts(kernels)
    ops.cycle_lanes = event_timed(wrapper, spans)
    try:
        for b in BENCHMARKS:
            t0 = time.perf_counter()
            got[b] = run_sweep_bench(b, full=full, prune="surrogate",
                                     cache=cache, device=dev)
            cold_s[b] = time.perf_counter() - t0
    finally:
        ops.cycle_lanes = wrapper
    torch.cuda.synchronize()
    launches = hold_counts(kernels, "pruned (a)",
                           {"cycle_lanes": len(BENCHMARKS)})["cycle_lanes"]
    check(len(spans) == launches, f"{len(spans)} timed launches")
    n_band = sum(len(i) for i in band.values())
    check((cache.hits, cache.misses) == (0, n_band),
          f"pruned pass: {cache.hits} hits, {cache.misses} misses for "
          f"{n_band} band points")
    kernel_ms, fronts = {}, {}
    for (b, pts_b), (start, end) in zip(got.items(), spans):
        expect = [want[b][i] for i in kept[b]]
        check([(p.design, p.unroll) for p in pts_b]
              == [(grid[i][0].label, grid[i][1]) for i in kept[b]],
              f"{b}: the pruned sweep's points are not those the front "
              "cap's rule keeps of its band")
        check(same_points(pts_b, expect),
              f"{b}: a pruned point differs from its golden row")
        for cost, key in (("area", lambda p: p.area_mm2),
                          ("power", lambda p: p.power_mw)):
            fronts[b, cost] = ([(p.design, p.unroll)
                                for p in pareto_front(pts_b, key)]
                               == [(p.design, p.unroll)
                                   for p in pareto_front(want[b], key)])
        check(fronts[b, "area"],
              f"{b}: the pruned time/area front != the golden rows' front")
        kernel_ms[b] = start.elapsed_time(end)
    # where each band launch's slowest lane spends its clocks: the
    # profiling instantiation, launched after the counts were read
    for b in BENCHMARKS:
        line = (f"pruned (a) {b}: {len(got[b])} points, kernel "
                f"{kernel_ms[b]:.3f} ms (phase 8's 80-lane launch "
                f"{exhaustive_ms[b]:.3f} ms, "
                f"{exhaustive_ms[b] / kernel_ms[b]:.2f}x), most cycles a "
                f"lane simulated {max(p.cycles for p in got[b])}, "
                f"run_sweep_bench {cold_s[b] * 1e3:.1f} ms (host clock); "
                f"time/area front equal to the 80 golden points'; "
                "time/power front "
                f"{'equal' if fronts[b, 'power'] else 'differs'} "
                "(information only)")
        if b in CALIBRATED_BENCHES:
            line += (f"; front cap: band {len(band[b])}, kept "
                     f"{len(kept[b])}, capped "
                     f"{len(band[b]) - len(kept[b])}")
            split = profile_lanes(pts[b], lanes[b], dev)
            i = order[b][split["lane"]]
            dp, u = grid[i]
            line += (f"; slowest lane {dp.label} u{u} "
                     f"({'kept' if i in kept[b] else 'capped'}), "
                     f"{split['cycles']} cycles, deferral scan and FU "
                     f"issue {split['shares'][3]:.1%} of its SM clocks, "
                     f"{split['scan_pops']} pops in "
                     f"{split['scan_rounds']} warp rounds")
        print(line)
    pruned_ms = sum(kernel_ms.values())
    n_cal = sum(b in CALIBRATED_BENCHES for b in BENCHMARKS)
    n_kept = sum(len(k) for k in kept.values())
    print(f"pruned (a): front cap: {n_cal_kept} of {n_cal_band} band points "
          f"kept, {n_cal_band - n_cal_kept} capped; the {n_cal} band "
          f"launches {sum(kernel_ms[b] for b in order):.3f} ms (the 15 "
          "launches before the cap, first measured on an H100 80GB HBM3 "
          "at 700 W: 2157.703 ms)")
    print(f"pruned (a): {launches} launches of cycle_lanes ({n_cal} bands, "
          f"{len(BENCHMARKS) - n_cal} exhaustive fallbacks), {n_kept} of "
          f"{n_band} points returned, each equal to its golden row; "
          f"kernel {pruned_ms:.3f} ms in all against phase 8's "
          f"{sum(exhaustive_ms.values()):.3f} ms; cold pass "
          f"{sum(cold_s.values()):.3f} s (host clock) against phase 9's "
          f"exhaustive {exhaustive_cold_s:.3f} s; time/power fronts equal "
          f"on {sum(fronts[b, 'power'] for b in BENCHMARKS)} of "
          f"{len(BENCHMARKS)}")

    # (b) the audit of one pruned benchmark, served from (a)'s cache
    cache = SweepCache(root / "cache")
    t0 = time.perf_counter()
    audited = run_sweep_bench(PRUNE_AUDIT_BENCH, full=full, prune="surrogate",
                              cache=cache, check=True, device=dev)
    check(audited == got[PRUNE_AUDIT_BENCH]
          and cache.hits == len(audited) and cache.misses == 0,
          f"{PRUNE_AUDIT_BENCH}: the audited pruned sweep changed")
    print(f"pruned (b) {PRUNE_AUDIT_BENCH}: run_sweep_bench(prune="
          f"'surrogate', check=True): {len(audited)} event logs legal, 0 "
          f"violations ({time.perf_counter() - t0:.2f} s host clock)")

    # (c) the CLI, with and without pruning, sharing one trace cache
    old_dir = os.environ.get("REPRO_CACHE_DIR")
    os.environ["REPRO_CACHE_DIR"] = str(root / "repro_cache")
    trace_file = bench_mod._disk_cache_path(
        CLI_BENCH, BENCHMARKS[CLI_BENCH].Params() if full
        else BENCHMARKS[CLI_BENCH].TINY)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))
    rows, stamp = {}, {}
    for what, extra in (("exhaustive", []),
                        ("pruned", ["--prune", "surrogate"])):
        stamp[what] = (trace_file.stat().st_ino, trace_file.stat().st_mtime_ns
                       ) if trace_file.is_file() else None
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.core.dse.runner", "--bench",
             CLI_BENCH, "--front-only", "--device", dev.type,
             "--cache-dir", str(root / f"cli_{what}")]
            + (["--full"] if full else []) + extra,
            capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"the {what} CLI exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        rows[what] = [ln for ln in proc.stdout.splitlines()
                      if ln and not ln.startswith("#")]
        print(f"pruned (c) {what} CLI --bench {CLI_BENCH} --front-only"
              f"{' ' + ' '.join(extra) if extra else ''}: "
              f"{len(rows[what]) - 1} front rows ({cli_s:.1f} s host clock "
              "for the process)")
        for ln in proc.stdout.splitlines():
            if ln.startswith("#"):
                print(f"pruned (c) {what} {ln}")
    if old_dir is None:
        del os.environ["REPRO_CACHE_DIR"]
    else:
        os.environ["REPRO_CACHE_DIR"] = old_dir
    check(len(rows["pruned"]) > 1 and rows["pruned"] == rows["exhaustive"],
          "the pruned CLI's --front-only rows != the exhaustive CLI's")
    check(stamp["exhaustive"] is None and stamp["pruned"] is not None
          and trace_file.is_file()
          and (trace_file.stat().st_ino, trace_file.stat().st_mtime_ns)
          == stamp["pruned"],
          f"the pruned CLI did not read its trace from {trace_file}")
    print(f"pruned (c): the two CLIs' front rows are identical; the first "
          f"wrote the trace, the second read it from {trace_file} "
          f"({trace_file.stat().st_size} bytes, unchanged)")
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "kernel_ms": kernel_ms,
            "band": {b: len(i) for b, i in band.items()},
            "kept": {b: len(i) for b, i in kept.items()},
            "cold_s": sum(cold_s.values())}


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def print_top(what: str, events: "dict[str, tuple[int, float]]",
              step_ms: float, top: int = 8) -> float:
    """Print a profiled run's device time, its busy share of the
    unprofiled ``step_ms`` and its largest device operations; return the
    device ms."""
    total = sum(ms for _, ms in events.values())
    check(total > 0, f"{what}: the profiler recorded no device time")
    print(f"{what} (profiler, device): {total:.3f} ms of device time in "
          f"{sum(n for n, _ in events.values())} launches, busy "
          f"{total / step_ms:.1%} of the unprofiled {step_ms:.3f} ms")
    for k, (n, ms) in sorted(events.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ms:9.3f} ms {n:6d}x  {k[:90]}")
    return total


def zero_counts(kernels: dict) -> None:
    for w in kernels.values():
        w.launches = 0


def hold_counts(kernels: dict, what: str, want: "dict | None" = None
                ) -> "dict[str, int]":
    """Print each kernel's launch count since ``zero_counts`` and check
    it against ``want`` (0 for every kernel ``want`` does not name)."""
    want = want or {}
    got = {k: w.launches for k, w in kernels.items()}
    print(f"{what}: kernel launches {got} (want "
          + (f"{want}, every other 0)" if want else "0 of every kernel)"))
    check(all(n == want.get(k, 0) for k, n in got.items()),
          f"{what} launched {got}, want {want or 'none'}")
    return got


def prompt(arch, b: int, s: int, dev: torch.device) -> torch.Tensor:
    """serve.main's prompts: np.random.default_rng(0)."""
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, arch.vocab, (b, s))).to(dev, torch.int32)


def serve_full(kernels: dict, name: str, b: int, s: int, g: int,
               extra=(), want: "dict | None" = None) -> None:
    """``serve.main`` at full width, its launches counted from 0."""
    from repro_torch.launch import serve
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve.main(["--arch", name, "--preset", "full", "--batch",
                      str(b), "--prompt-len", str(s), "--gen", str(g),
                      *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hold_counts(kernels, f"serve {name}", want)
    check(out["generated"].shape == (b, g),
          f"{name}: generated shape {out['generated'].shape}")
    print(f"serve {' '.join([name, *extra])} full B {b} S {s} gen {g}: "
          f"{wall:.1f} s in all (init, prefill, decode), "
          f"{out['tok_per_s']:.1f} tok/s in decode")


def round_blocks(params: dict) -> None:
    """The stacked layer weights rounded through bf16, as phase 6: the
    forward casts every stacked leaf to the compute dtype where prefill
    and decode cast at each product."""
    from repro_torch.models.common import tree_map
    params["blocks"] = tree_map(lambda t: t.to(torch.bfloat16).float(),
                                params["blocks"])


def decode_vs_forward(params, arch, toks, pol, extra=None):
    """Token t+1 (the prefill's greedy pick) decoded from the prefill of
    t tokens, and forward over the t+1, both given the batch's
    ``extra`` inputs (patches, frames): (decode, forward's last
    position, forward's aux)."""
    from repro_torch.models import decode_step, forward, prefill
    extra = extra or {}
    lg, c = prefill(params, arch, {"tokens": toks, **extra},
                    toks.shape[1] + 1, pol)
    nxt = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
    dec, _ = decode_step(params, arch, c, nxt, pol)
    del c
    full, aux = forward(params, arch,
                        {"tokens": torch.cat([toks, nxt], dim=1), **extra},
                        pol)
    torch.cuda.synchronize()
    return dec[:, 0], full[:, -1], aux


def hold_decode(params, arch, toks, pol, tol: float, what: str,
                extra=None):
    """``decode_vs_forward``'s logits held: bf16 by ``hold_logits``, f32
    by ``hold_close``.  Returns forward's aux."""
    dec, full, aux = decode_vs_forward(params, arch, toks, pol, extra)
    msg = f"{what} prefill-then-decode vs forward"
    if pol.compute == torch.bfloat16:
        err, scale, share, atol, flat = hold_logits(dec, full, tol, msg)
        note = f"; a flat atol {tol:g} would read {flat:.3g} of it"
    else:
        (err, scale, share), atol = hold_close(dec, full, tol, tol,
                                               msg), tol
        note = ""
    print(f"{msg} at t+1 = {toks.shape[1] + 1}, B {toks.shape[0]}: max "
          f"err {err:.3g} (max |logit| {scale:.3g}, {share:.3g} of the "
          f"limit atol {atol:.3g} + rtol {tol:g} * |logit|{note})")
    return aux


def attention_serving(dev: torch.device, kernels: dict) -> None:
    """Phase 10: the attention families served at full width with random
    weights from seed 0: (a) qwen3-1.7b (dense GQA) through
    ``serve.main``, its times, bounds and profiles, prefill-then-decode
    against forward, the card against the port on the CPU (f32) with a
    decode at ``cache_len == S_max``; (b) minicpm3-4b (MLA) served with
    ``--mla-absorb``, then decoded with and without the absorption from
    one prefill; (c) moonshot-v1-16b-a3b (MoE) with 4 of its 48 layers.
    ``kernels`` maps each kernel of the port to its wrapper: this path
    runs none of them, and each count must stay 0."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import (DTypePolicy, count_params, decode_step,
                                    init_model, prefill)
    from repro_torch.models.attention import AttnConfig
    from repro_torch.models.common import tree_map

    policy = DTypePolicy.standard()
    f32 = DTypePolicy(torch.float32, torch.float32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # ---- (a) qwen3-1.7b at full width -------------------------------
    arch = get_arch(ARCH)
    b, s, g = ATTN_BATCH, ATTN_PROMPT, ATTN_GEN
    serve_full(kernels, ARCH, b, s, g)
    params = init_model(0, arch, policy, dev)          # serve's weights
    n_params = count_params(params)
    tokens = prompt(arch, b, s, dev)
    prefill_step = make_prefill_step(arch, policy, s + g)
    decode = make_decode_step(arch, policy)
    zero_counts(kernels)
    prefill_ms, (logits, cache) = wall_ms(
        lambda: prefill_step(params, {"tokens": tokens}))
    check(bool(torch.isfinite(logits).all()), "qwen3 prefill not finite")
    last = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(g):
        last, logits, cache = decode(params, cache, last)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / g
    hold_counts(kernels, f"{ARCH} prefill and decode")
    check(bool(torch.isfinite(logits).all()), "qwen3 decode not finite")
    check(int(cache["len"]) == s + g, "qwen3 cache length")

    # bounds, from this run's shapes
    L, d, V = arch.n_layers, arch.d_model, arch.padded_vocab
    hq, hkv, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    per_layer = sum(t[0].numel() for t in _leaves(params["blocks"])
                    if t.ndim == 3)           # the layer's matrices
    blk = AttnConfig.block_kv
    bf16_flops = 2 * b * s * L * per_layer + 2 * b * d * V
    f32_flops = L * 2 * 2 * b * hq * s * (-(-s // blk) * blk) * hd
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    # the prefill's products run in bf16 and its attention in f32, each
    # at its own peak; it reads the params and writes the prompt's K/V
    pre_ops = (bf16_flops / BF16_FLOPS_PER_S
               + f32_flops / F32_FLOPS_PER_S) * 1e3
    pre_bytes = (n_params * 4 + kv_bytes * s / (s + g) + b * s * 4
                 + b * V * 2) / HBM_BYTES_PER_S * 1e3
    pre_bound, pre_by = max((pre_ops, "operations"), (pre_bytes, "bytes"))
    dec_bound, dec_by = bound_ms(n_params * 4 + kv_bytes,
                                 2 * b * n_params + 4 * b * hq * (s + g) * hd)
    print(f"serve {ARCH} B {b} S {s}, {n_params / 1e9:.3f} B params "
          f"({n_params * 4 / 1e9:.2f} GB f32): prefill {prefill_ms:.3f} ms "
          f"(host clock, fenced, median of 3), decode {decode_ms:.3f} ms a "
          f"token step (host clock, fenced, {g} steps)")
    print(f"{ARCH} prefill bound {pre_bound:.3f} ms ({pre_by}: "
          f"{bf16_flops / 1e12:.3f} TFLOP of bf16 products at "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s = "
          f"{bf16_flops / BF16_FLOPS_PER_S * 1e3:.3f} ms, plus "
          f"{f32_flops / 1e12:.3f} TFLOP of f32 block-scan attention, every "
          f"block of {blk} computed, causal or not, at "
          f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s = "
          f"{f32_flops / F32_FLOPS_PER_S * 1e3:.3f} ms); the prefill takes "
          f"{prefill_ms / pre_bound:.2f}x it")
    print(f"{ARCH} decode bound {dec_bound:.4f} ms ({dec_by}: "
          f"{n_params * 4 / 1e9:.3f} GB of f32 params + "
          f"{kv_bytes / 1e9:.3f} GB of bf16 K/V at S {s + g}, at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); the step takes "
          f"{decode_ms / dec_bound:.2f}x it")
    print_top(f"{ARCH} decode step", device_events(
        lambda: decode(params, cache, last))[0], decode_ms)
    del logits, cache
    torch.cuda.empty_cache()
    print_top(f"{ARCH} prefill", device_events(
        lambda: prefill_step(params, {"tokens": tokens}))[0], prefill_ms)
    torch.cuda.empty_cache()

    round_blocks(params)
    toks = tokens[:CHECK_BATCH, :CHECK_PROMPT]
    hold_decode(params, arch, toks, policy, E2E_TOL, f"{ARCH} bf16")
    hold_decode(params, arch, toks, f32, F32_MODEL_TOL, f"{ARCH} f32")
    # f32 on the card against the port on the CPU: a prefill, two decode
    # steps and a third at cache_len == S_max (its row lands in the last
    # slot), the card's greedy tokens fed to both
    tok = tokens[:CPU_BATCH, :CPU_PROMPT]
    cap = CPU_PROMPT + 2
    cpu_params = tree_map(lambda t: t.cpu(), params)
    lg, c = prefill(params, arch, {"tokens": tok}, cap, f32)
    lg_cpu, c_cpu = prefill(cpu_params, arch, {"tokens": tok.cpu()}, cap, f32)
    errs = [hold_close(lg.cpu(), lg_cpu, F32_MODEL_TOL, F32_MODEL_TOL,
                       f"{ARCH} f32 prefill card vs cpu")]
    for step in range(3):
        nxt = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
        at = int(c["len"])
        lg, c = decode_step(params, arch, c, nxt, f32)
        lg_cpu, c_cpu = decode_step(cpu_params, arch, c_cpu, nxt.cpu(), f32)
        errs.append(hold_close(
            lg.cpu(), lg_cpu, F32_MODEL_TOL, F32_MODEL_TOL,
            f"{ARCH} f32 decode at cache_len {at} (S_max {cap}) card vs cpu"))
    check(int(c["len"]) == cap + 1, "the decode at S_max")
    for k in ("k", "v"):
        errs.append(hold_close(c[k].cpu(), c_cpu[k], F32_MODEL_TOL,
                               F32_MODEL_TOL, f"{ARCH} f32 cache {k}"))
    print(f"{ARCH} f32 card vs cpu, B {CPU_BATCH} S {CPU_PROMPT}, capacity "
          f"{cap}: prefill, decodes at cache_len {CPU_PROMPT}, "
          f"{CPU_PROMPT + 1} and {cap} == S_max (clamped into the last "
          f"slot), then K and V: max errs "
          + ", ".join(f"{e[0]:.3g}" for e in errs)
          + f" (largest share of the limit {max(e[2] for e in errs):.3g})")
    del params, cpu_params, lg, c, lg_cpu, c_cpu
    torch.cuda.empty_cache()

    # ---- (b) minicpm3-4b (MLA) at full width ------------------------
    arch = get_arch(MLA_ARCH)
    b, s, g = MLA_BATCH, MLA_PROMPT, MLA_GEN
    serve_full(kernels, MLA_ARCH, b, s, g, ("--mla-absorb",))
    params = init_model(0, arch, policy, dev)
    tokens = prompt(arch, b, s, dev)
    zero_counts(kernels)
    pre_ms, (logits, cache) = wall_ms(lambda: make_prefill_step(
        arch, policy, s + g)(params, {"tokens": tokens}))
    first = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    runs, fed = {}, [first]
    for absorb in (False, True):
        step = make_decode_step(arch, policy, mla_absorb=absorb)
        c = {k: v.clone() for k, v in cache.items()}
        lgs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(g):
            nxt, lg, c = step(params, c, fed[i])
            lgs.append(lg)
            if not absorb:
                fed.append(nxt)
        torch.cuda.synchronize()
        runs[absorb] = ((time.perf_counter() - t0) * 1e3 / g, lgs)
        del c
    hold_counts(kernels, f"{MLA_ARCH} prefill and decode")
    mla_errs = [hold_logits(a, e, E2E_TOL,
                            f"{MLA_ARCH} absorbed vs expanded step {i}")
                for i, (a, e) in enumerate(zip(runs[True][1], runs[False][1]))]
    check(all(bool(torch.isfinite(x).all()) for x in runs[True][1]),
          "minicpm3 absorbed logits not finite")
    # the same in f32: one step from an f32 prefill, the reference's limit
    # for the two modes
    _, c32 = prefill(params, arch, {"tokens": tokens}, s + 1, f32)
    outs = [decode_step(params, arch, {k: v.clone() for k, v in c32.items()},
                        first, f32, mla_absorb=absorb)[0]
            for absorb in (False, True)]
    f32_err = hold_close(outs[1], outs[0], MLA_F32_TOL, MLA_F32_TOL,
                         f"{MLA_ARCH} f32 absorbed vs expanded")
    print(f"{MLA_ARCH} B {b} S {s}, {count_params(params) / 1e9:.3f} B "
          f"params: prefill {pre_ms:.3f} ms (host clock, median of 3); "
          f"decode {runs[False][0]:.3f} ms a step expanded, "
          f"{runs[True][0]:.3f} ms absorbed ({g} steps each from clones of "
          f"one prefill's cache, the same tokens fed); absorbed vs expanded "
          f"bf16 logits max err {max(e[0] for e in mla_errs):.3g} over {g} "
          f"steps (max |logit| {max(e[1] for e in mla_errs):.3g}, "
          f"{max(e[2] for e in mla_errs):.3g} of the limit atol "
          f"{max(e[3] for e in mla_errs):.3g} + rtol {E2E_TOL:g} * "
          f"|logit|; a flat atol {E2E_TOL:g} would read "
          f"{max(e[4] for e in mla_errs):.3g} of it), f32 one step "
          f"{f32_err[0]:.3g} "
          f"({f32_err[2]:.3g} of atol {MLA_F32_TOL:g} + rtol "
          f"{MLA_F32_TOL:g} * |logit|)")
    del params, logits, cache, c32, outs, runs
    torch.cuda.empty_cache()

    # ---- (c) moonshot-v1-16b-a3b (MoE), 4 of its 48 layers ----------
    full_arch = get_arch(MOE_ARCH)
    arch = dataclasses.replace(full_arch, n_layers=MOE_LAYERS)
    expert = full_arch.n_experts * 3 * full_arch.d_model * full_arch.d_ff
    print(f"{MOE_ARCH}: cut to {MOE_LAYERS} of its {full_arch.n_layers} "
          f"layers at full width: each layer holds {expert / 1e6:.1f} M "
          f"expert params ({expert * 4 / 1e9:.2f} GB in f32), so "
          f"{full_arch.n_layers} layers would need about "
          f"{full_arch.param_count_estimate() * 4 / 1e9:.0f} GB, more than "
          "the card holds")
    b, s, g = MOE_BATCH, MOE_PROMPT, MOE_GEN
    params = init_model(0, arch, policy, dev)
    tokens = prompt(arch, b, s, dev)
    zero_counts(kernels)
    pre_ms, (logits, cache) = wall_ms(lambda: make_prefill_step(
        arch, policy, s + g)(params, {"tokens": tokens}))
    last = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    step = make_decode_step(arch, policy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(g):
        last, logits, cache = step(params, cache, last)
    torch.cuda.synchronize()
    moe_dec_ms = (time.perf_counter() - t0) * 1e3 / g
    hold_counts(kernels, f"{MOE_ARCH} prefill and decode")
    check(bool(torch.isfinite(logits).all()), "moonshot decode not finite")
    print(f"{MOE_ARCH} ({MOE_LAYERS} layers) B {b} S {s}, "
          f"{count_params(params) / 1e9:.3f} B params: prefill {pre_ms:.3f} "
          f"ms (host clock, median of 3), decode {moe_dec_ms:.3f} ms a "
          f"token step ({g} steps)")
    del logits, cache
    torch.cuda.empty_cache()
    round_blocks(params)
    toks = tokens[:CHECK_BATCH, :MOE_CHECK_PROMPT]
    # A capacity-based MoE drops, in the forward over t+1 tokens, the
    # last token's choices of experts already full, while the one-token
    # decode (capacity 1, k distinct experts) drops none: the identity
    # holds at a capacity that drops nothing, C = S (factor E/k); at the
    # published 1.25 the reference itself differs (ROADMAP §C)
    free = dataclasses.replace(arch, moe_capacity_factor=arch.n_experts
                               / arch.top_k)
    aux = hold_decode(params, free, toks, policy, E2E_TOL,
                      f"{MOE_ARCH} bf16, capacity factor E/k")
    check(bool(torch.isfinite(aux)) and aux.item() > 0,
          f"moonshot forward aux {aux.item()}")
    hold_decode(params, free, toks, f32, F32_MODEL_TOL,
                f"{MOE_ARCH} f32, capacity factor E/k")
    dec, full, aux = decode_vs_forward(params, arch, toks, policy)
    check(bool(torch.isfinite(aux)), "moonshot forward aux not finite")
    print(f"{MOE_ARCH} bf16 at the published capacity factor "
          f"{arch.moe_capacity_factor}: forward aux {aux.item():.6f} (sum "
          f"over {MOE_LAYERS} layers), prefill-then-decode vs forward max "
          f"difference {(dec.float() - full.float()).abs().max().item():.3g} "
          "(the forward drops choices the decode keeps; for the record)")
    del params
    torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def family_serving(dev: torch.device, gen: torch.Generator,
                   kernels: dict) -> dict:
    """Phase 11: the hybrid, vlm and audio families served at full width
    with random weights from seed 0: (a) zamba2-2.7b through
    ``serve.main`` (decoding from an empty cache, as the JAX package's
    serve.py does: no prefill, no SSD chunk), then its prefill, which runs
    ``ssd_chunk`` once a chunk of each of its 54 Mamba2 layers, and 16
    decode steps, timed beside their bounds and profiled; the SSD
    kernel against its plain version at zamba2's chunk; forward against
    t decode steps from an empty cache; the card against the CPU in
    f32; (b) internvl2-1b served with its 256 patches, its prefill and
    decode timed; forward and ``loss_fn`` with the patches on the card
    and the CPU; prefill-then-decode against forward with no patches;
    (c) seamless-m4t-medium served against a zero cross cache, then a
    prefill over 512 frames and 16 decode steps timed; prefill-then-
    decode against forward with frames that fit the cross cache; the
    card against the CPU in f32, the cross caches included.  Every
    kernel's launch count is set to 0 before each path and read after
    it: only (a)'s prefills and forwards run one (``ssd_chunk``).
    Returns the SSD kernel's numbers on this path."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_chunk
    from repro_torch.kernels.ssd_scan import ssd_chunk_step_plain
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import (DTypePolicy, count_params, decode_step,
                                    forward, init_model, loss_fn, make_cache,
                                    prefill, ssm_config)
    from repro_torch.models.attention import AttnConfig
    from repro_torch.models.common import tree_map

    policy = DTypePolicy.standard()
    f32 = DTypePolicy(torch.float32, torch.float32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    b, s, g = ATTN_BATCH, ATTN_PROMPT, ATTN_GEN

    def timed(arch, params, batch: dict, want: "dict | None" = None
              ) -> "tuple[float, float, dict]":
        """The prefill at B b x S s, its launches counted, then timed
        (host clock, fenced, median of 3); g greedy decode steps from
        its cache; the profiles of a decode step and of the prefill.
        Returns (prefill ms, decode ms a step, the cache's shapes)."""
        name = arch.name
        prefill_step = make_prefill_step(arch, policy, s + g)
        decode = make_decode_step(arch, policy)
        zero_counts(kernels)
        logits, cache = prefill_step(params, batch)
        torch.cuda.synchronize()
        hold_counts(kernels, f"{name} prefill B {b} S {s}", want)
        check(bool(torch.isfinite(logits).all()), f"{name} prefill finite")
        del logits, cache
        pre_ms, (logits, cache) = wall_ms(lambda: prefill_step(params,
                                                               batch))
        shapes = {k: tuple(v.shape) for k, v in cache.items()}
        last = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(g):
            last, logits, cache = decode(params, cache, last)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / g
        hold_counts(kernels, f"{name} {g} decode steps")
        check(bool(torch.isfinite(logits).all()), f"{name} decode finite")
        check(int(cache["len"]) == s + g, f"{name} cache length")
        print(f"serve {name} B {b} S {s}: prefill {pre_ms:.3f} ms (host "
              f"clock, fenced, median of 3), decode {dec_ms:.3f} ms a token "
              f"step (host clock, fenced, {g} steps)")
        print_top(f"{name} decode step", device_events(
            lambda: decode(params, cache, last))[0], dec_ms)
        del logits, cache
        torch.cuda.empty_cache()
        print_top(f"{name} prefill", device_events(
            lambda: prefill_step(params, batch))[0], pre_ms)
        torch.cuda.empty_cache()
        return pre_ms, dec_ms, shapes

    def print_bounds(name: str, pre_ms: float, dec_ms: float,
                     pre_terms: "dict[str, float]", pre_bytes: float,
                     dec_bytes: float) -> None:
        """The prefill's bound: its operations, each term in ms at its
        own peak, against its bytes; the decode step's: its bytes."""
        pre_ops = sum(pre_terms.values())
        pre_bound, pre_by = max((pre_ops, "operations"),
                                (pre_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        dec_bound = dec_bytes / HBM_BYTES_PER_S * 1e3
        print(f"{name} prefill bound {pre_bound:.3f} ms ({pre_by}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in pre_terms.items())
              + f"; bytes {pre_bytes / 1e9:.3f} GB); the prefill takes "
              f"{pre_ms / pre_bound:.2f}x it")
        print(f"{name} decode bound {dec_bound:.4f} ms (bytes: "
              f"{dec_bytes / 1e9:.3f} GB of f32 params and the cache at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); the step takes "
              f"{dec_ms / dec_bound:.2f}x it")

    def nbytes(shapes: dict, cd_keys, f32_keys=()) -> float:
        return sum(math.prod(shapes[k]) * (4 if k in f32_keys else 2)
                   for k in (*cd_keys, *f32_keys))

    def mats(tree: dict) -> int:
        """The stacked matrices' elements (leaves [L, in, out])."""
        return sum(t.numel() for t in _leaves(tree) if t.ndim == 3)

    def card_vs_cpu(params, arch, batch: dict, keys, what: str) -> None:
        """An f32 prefill of capacity S + 3 and three greedy decode steps
        on the card against the port on the CPU (the card's tokens fed
        to both): the logits of each, then the cache tensors ``keys``."""
        cap = batch["tokens"].shape[1] + 3
        cpu_params = tree_map(lambda t: t.cpu(), params)
        lg, c = prefill(params, arch, batch, cap, f32)
        lg_cpu, c_cpu = prefill(cpu_params, arch,
                                {k: v.cpu() for k, v in batch.items()},
                                cap, f32)
        errs = [hold_close(lg.cpu(), lg_cpu, F32_MODEL_TOL, F32_MODEL_TOL,
                           f"{what} f32 prefill card vs cpu")]
        for _ in range(3):
            nxt = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
            at = int(c["len"])
            lg, c = decode_step(params, arch, c, nxt, f32)
            lg_cpu, c_cpu = decode_step(cpu_params, arch, c_cpu, nxt.cpu(),
                                        f32)
            errs.append(hold_close(
                lg.cpu(), lg_cpu, F32_MODEL_TOL, F32_MODEL_TOL,
                f"{what} f32 decode at cache_len {at} card vs cpu"))
        for k in keys:
            check(c[k].shape == c_cpu[k].shape, f"{what} cache {k} shape")
            errs.append(hold_close(c[k].cpu(), c_cpu[k], F32_MODEL_TOL,
                                   F32_MODEL_TOL, f"{what} f32 cache {k}"))
        print(f"{what} f32 card vs cpu, B {batch['tokens'].shape[0]} S "
              f"{batch['tokens'].shape[1]}, capacity {cap}: prefill, 3 "
              f"decode steps, then {', '.join(keys)}: max errs "
              + ", ".join(f"{e[0]:.3g}" for e in errs)
              + f" (largest share of the limit {max(e[2] for e in errs):.3g})")

    # ---- (a) zamba2-2.7b at full width ------------------------------
    arch = get_arch(HYBRID_ARCH)
    scfg = ssm_config(arch)
    every = arch.shared_attn_every
    want_ssd = arch.n_layers * (s // scfg.chunk)
    serve_full(kernels, HYBRID_ARCH, b, s, g)
    print(f"serve {HYBRID_ARCH}: decodes from an empty cache, as the JAX "
          "package's serve.py does (no prefill), so it launches no SSD "
          "chunk")
    params = init_model(0, arch, policy, dev)           # serve's weights
    n_params = count_params(params)
    tokens = prompt(arch, b, s, dev)
    pre_ms, dec_ms, shapes = timed(arch, params, {"tokens": tokens},
                                   {"ssd_scan": want_ssd})
    chunk_flops, chunk_bytes = ssd_work(b, scfg.n_heads, scfg.chunk,
                                        scfg.head_dim, scfg.d_state)
    d, V = arch.d_model, arch.padded_vocab
    print_bounds(
        HYBRID_ARCH, pre_ms, dec_ms,
        {"bf16 products": (2 * b * s * mats(params["blocks"])
                           + 2 * b * d * V) / BF16_FLOPS_PER_S * 1e3,
         "SSD chunks as split-TF32": 3 * want_ssd * chunk_flops
         / TF32_FLOPS_PER_S * 1e3},
        n_params * 4 + nbytes(shapes, ("ssm_conv",), ("ssm_h",)),
        n_params * 4 + nbytes(shapes, ("ssm_conv", "shared_k", "shared_v"),
                              ("ssm_h",)) + 4 * math.prod(shapes["ssm_h"]))
    print(f"{HYBRID_ARCH}: {n_params / 1e9:.3f} B params "
          f"({n_params * 4 / 1e9:.2f} GB f32), {arch.n_layers} Mamba2 "
          f"layers (H {scfg.n_heads}, P {scfg.head_dim}, N {scfg.d_state}, "
          f"chunk {scfg.chunk}), the shared block every {every} layers: "
          f"{-(-arch.n_layers // every)} uses, {arch.n_heads} heads of "
          f"{arch.resolved_head_dim}")

    # the SSD kernel at zamba2's chunk, against its plain version
    ins = ssd_inputs(gen, b, scfg.n_heads, scfg.chunk, scfg.head_dim,
                     scfg.d_state)
    shape = (f"Bt {b} H {scfg.n_heads} Q {scfg.chunk} P {scfg.head_dim} "
             f"N {scfg.d_state}")
    _, z_err = hold_ssd(ins, f"zamba2 {shape} f32")
    z_ms = time_ms(lambda: ssd_chunk(*ins))
    z_plain = time_ms(lambda: ssd_chunk_step_plain(*ins))
    z_bound, z_by = bound_ms(chunk_bytes, 3 * chunk_flops, TF32_FLOPS_PER_S)
    print(f"ssd zamba2 {shape}: {chunk_flops / 1e9:.3f} GFLOP, "
          f"{chunk_bytes / 1e6:.2f} MB; kernel {z_ms:.4f} ms, plain "
          f"{z_plain:.4f} ms; split-TF32 bound {z_bound:.4f} ms ({z_by}), "
          f"{z_bound / z_ms:.1%} of it; {want_ssd} launches a prefill = "
          f"{want_ssd * z_ms:.3f} ms of the {pre_ms:.3f} ms prefill")
    del ins

    # forward against t decode steps from an empty cache, at every
    # position: the identity the hybrid keeps (its prefill skips the
    # shared block), the layer weights rounded through bf16 first.  In
    # f32 it holds within 1e-3.  In bf16, at 54 Mamba2 layers and 9
    # shared blocks, the rounding of either path alone exceeds the 2e-2
    # limit: the bf16 forward reads about 1.09 of it against the f32
    # forward on the same weights.  So the bf16 decode is held to the f32
    # forward as closely as the bf16 forward is (``BF16_DEPTH_MARGIN``),
    # and its share of the 2e-2 limit against the bf16 forward printed
    round_blocks(params)
    t = HYBRID_CHECK_T
    toks = tokens[:CHECK_BATCH, :t]

    def decoded(pol: DTypePolicy) -> torch.Tensor:
        """The logits of t decode steps from an empty cache, [B, t, V]."""
        cache = make_cache(arch, t, CHECK_BATCH, pol, dev)
        lgs = []
        for i in range(t):
            lg, cache = decode_step(params, arch, cache, toks[:, i:i + 1],
                                    pol)
            lgs.append(lg[:, 0])
        return torch.stack(lgs, dim=1)

    zero_counts(kernels)
    full32 = forward(params, arch, {"tokens": toks}, f32)[0]
    dec32 = decoded(f32)
    full16 = forward(params, arch, {"tokens": toks}, policy)[0].float()
    dec16 = decoded(policy).float()
    torch.cuda.synchronize()
    hold_counts(kernels, f"{HYBRID_ARCH} forward over {t} tokens in f32 and "
                f"bf16, 2 x {t} decode steps",
                {"ssd_scan": 2 * arch.n_layers * -(-t // scfg.chunk)})
    what = f"{HYBRID_ARCH} {t} decode steps from an empty cache vs forward"
    err, scale, share = hold_close(dec32, full32, F32_MODEL_TOL,
                                   F32_MODEL_TOL, f"{what} f32")
    print(f"{what} f32 at every position, B {CHECK_BATCH}: max err {err:.3g} "
          f"(max |logit| {scale:.3g}, {share:.3g} of the limit atol "
          f"{F32_MODEL_TOL:g} + rtol {F32_MODEL_TOL:g} * |logit|)")
    floor = (full16 - full32).abs().max().item()
    got = (dec16 - full32).abs().max().item()
    check(got <= BF16_DEPTH_MARGIN * floor,
          f"{what} bf16: {got:.3g} from the f32 forward, beyond "
          f"{BF16_DEPTH_MARGIN:g} x the bf16 forward's {floor:.3g}")
    atol = E2E_TOL * max(1.0, full16.abs().max().item())
    e2e = ((dec16 - full16).abs() / (atol + E2E_TOL * full16.abs())).max()
    print(f"{what} bf16 at every position, B {CHECK_BATCH}: max err "
          f"{got:.3g} against the f32 forward, {got / floor:.3g} x the bf16 "
          f"forward's own {floor:.3g} (limit {BF16_DEPTH_MARGIN:g} x); "
          f"against the bf16 forward {(dec16 - full16).abs().max():.3g}, "
          f"{e2e:.3g} of atol {atol:.3g} + rtol {E2E_TOL:g} * |logit| (for "
          f"the record; the bf16 forward against the f32 forward reads "
          f"{((full16 - full32).abs() / (atol + E2E_TOL * full32.abs())).max():.3g}"
          " of it)")
    del full32, dec32, full16, dec16
    zero_counts(kernels)
    card_vs_cpu(params, arch, {"tokens": tokens[:CPU_BATCH, :CPU_PROMPT]},
                ("ssm_h", "ssm_conv", "shared_k", "shared_v"), HYBRID_ARCH)
    hold_counts(kernels, f"{HYBRID_ARCH} f32 prefill and decode on the card",
                {"ssd_scan": arch.n_layers * -(-CPU_PROMPT // scfg.chunk)})
    del params, tokens
    torch.cuda.empty_cache()

    # ---- (b) internvl2-1b at full width -----------------------------
    arch = get_arch(VLM_ARCH)
    serve_full(kernels, VLM_ARCH, b, s, g)
    params = init_model(0, arch, policy, dev)
    n_params = count_params(params)
    rng = np.random.default_rng(0)            # serve's tokens, then patches
    tokens = torch.from_numpy(rng.integers(0, arch.vocab, (b, s))).to(
        dev, torch.int32)
    patches = torch.from_numpy(rng.standard_normal(
        (b, arch.n_patches, arch.vit_dim))).to(dev, torch.float32)
    pre_ms, dec_ms, shapes = timed(arch, params,
                                   {"tokens": tokens, "patches": patches})
    blk = AttnConfig.block_kv
    L, hq, hd = arch.n_layers, arch.n_heads, arch.resolved_head_dim
    d, V = arch.d_model, arch.padded_vocab
    print_bounds(
        VLM_ARCH, pre_ms, dec_ms,
        {"bf16 products": (2 * b * s * mats(params["blocks"])
                           + 2 * b * d * V) / BF16_FLOPS_PER_S * 1e3,
         "f32 block-scan attention": L * 4 * b * hq * s * (-(-s // blk) * blk)
         * hd / F32_FLOPS_PER_S * 1e3},
        n_params * 4 + nbytes(shapes, ("k", "v")) * s / (s + g),
        n_params * 4 + nbytes(shapes, ("k", "v")))
    print(f"{VLM_ARCH}: {n_params / 1e9:.3f} B params; the prefill embeds "
          "the tokens only, as the reference's (its patches are drawn and "
          "passed, and ignored)")
    # forward and loss_fn with the 256 patches, card against CPU, f32
    tok = tokens[:CPU_BATCH, :CPU_PROMPT + 1]
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "patches": patches[:CPU_BATCH]}
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    zero_counts(kernels)
    full, _ = forward(params, arch, batch, f32)
    loss, met = loss_fn(params, arch, batch, f32)
    hold_counts(kernels, f"{VLM_ARCH} forward and loss_fn")
    full_cpu, _ = forward(cpu_params, arch, cpu_batch, f32)
    loss_cpu, met_cpu = loss_fn(cpu_params, arch, cpu_batch, f32)
    check(full.shape == (CPU_BATCH, arch.n_patches + CPU_PROMPT, V),
          f"{VLM_ARCH} forward shape {tuple(full.shape)}")
    e_full = hold_close(full.cpu(), full_cpu, F32_MODEL_TOL, F32_MODEL_TOL,
                        f"{VLM_ARCH} f32 forward card vs cpu")
    e_loss = [hold_close(met[k].cpu(), met_cpu[k], F32_MODEL_TOL,
                         F32_MODEL_TOL, f"{VLM_ARCH} f32 {k} card vs cpu")
              for k in ("ce", "z_loss")]
    e_loss.append(hold_close(loss.cpu(), loss_cpu, F32_MODEL_TOL,
                             F32_MODEL_TOL, f"{VLM_ARCH} f32 loss"))
    check(met["tokens"].item() == CPU_PROMPT, f"{VLM_ARCH} loss tokens")
    print(f"{VLM_ARCH} f32 forward over {arch.n_patches} patches + "
          f"{CPU_PROMPT} tokens, card vs cpu: logits max err "
          f"{e_full[0]:.3g} ({e_full[2]:.3g} of the limit); loss_fn "
          f"{loss.item():.6f} vs {loss_cpu.item():.6f}, ce / z_loss / loss "
          "max errs " + ", ".join(f"{e[0]:.3g}" for e in e_loss))
    del full, full_cpu, cpu_params
    round_blocks(params)
    none = {"patches": torch.zeros((CHECK_BATCH, 0, arch.vit_dim),
                                   device=dev)}
    toks = tokens[:CHECK_BATCH, :CHECK_PROMPT]
    zero_counts(kernels)
    hold_decode(params, arch, toks, policy, E2E_TOL,
                f"{VLM_ARCH} bf16, no patches", none)
    hold_decode(params, arch, toks, f32, F32_MODEL_TOL,
                f"{VLM_ARCH} f32, no patches", none)
    hold_counts(kernels, f"{VLM_ARCH} prefill-then-decode checks")
    del params, tokens, patches
    torch.cuda.empty_cache()

    # ---- (c) seamless-m4t-medium at full width ----------------------
    arch = get_arch(ENCDEC_ARCH)
    serve_full(kernels, ENCDEC_ARCH, b, s, g)
    params = init_model(0, arch, policy, dev)
    n_params = count_params(params)
    tokens = prompt(arch, b, s, dev)
    frames = torch.randn((b, ENCDEC_FRAMES, arch.d_model), generator=gen,
                         device=dev)
    pre_ms, dec_ms, shapes = timed(arch, params,
                                   {"tokens": tokens, "frames": frames})
    s_enc = max((s + g) // arch.cross_len_frac, 16)
    check(shapes["cross_k"][3] == min(ENCDEC_FRAMES, s_enc),
          f"{ENCDEC_ARCH} cross cache {shapes['cross_k']}")
    L, hq, hd = arch.n_layers, arch.n_heads, arch.resolved_head_dim
    d, V, F = arch.d_model, arch.padded_vocab, ENCDEC_FRAMES
    cross_kv = (params["blocks"]["cross"]["wk"].numel()
                + params["blocks"]["cross"]["wv"].numel())
    enc_attn = arch.enc_layers * 4 * b * hq * F * (-(-F // blk) * blk) * hd
    dec_attn = L * 4 * b * hq * s * ((-(-s // blk) + -(-F // blk)) * blk) * hd
    print_bounds(
        ENCDEC_ARCH, pre_ms, dec_ms,
        {"bf16 products": (2 * b * s * (mats(params["blocks"]) - cross_kv)
                           + 2 * b * F * (cross_kv
                                          + mats(params["enc_blocks"]))
                           + 2 * b * d * V) / BF16_FLOPS_PER_S * 1e3,
         "f32 block-scan attention": (enc_attn + dec_attn)
         / F32_FLOPS_PER_S * 1e3},
        n_params * 4 + b * F * d * 4 + nbytes(shapes, ("cross_k", "cross_v"))
        + nbytes(shapes, ("k", "v")) * s / (s + g),
        n_params * 4 + nbytes(shapes, ("k", "v", "cross_k", "cross_v")))
    print(f"{ENCDEC_ARCH}: {n_params / 1e9:.3f} B params; prefill over "
          f"{F} frames, cross cache {shapes['cross_k']} (at most "
          f"max({s + g} // {arch.cross_len_frac}, 16) = {s_enc} positions)")
    toks = tokens[:CHECK_BATCH, :CHECK_PROMPT]
    fit = {"frames": frames[:CHECK_BATCH, :ENCDEC_CHECK_FRAMES]}
    check(max((CHECK_PROMPT + 1) // arch.cross_len_frac, 16)
          == ENCDEC_CHECK_FRAMES, "the check's frames fit the cross cache")
    # the encdec stacks run uncast in forward as in prefill and decode, so
    # the weights need no rounding here
    zero_counts(kernels)
    hold_decode(params, arch, toks, policy, E2E_TOL,
                f"{ENCDEC_ARCH} bf16, {ENCDEC_CHECK_FRAMES} frames", fit)
    hold_decode(params, arch, toks, f32, F32_MODEL_TOL,
                f"{ENCDEC_ARCH} f32, {ENCDEC_CHECK_FRAMES} frames", fit)
    card_vs_cpu(params, arch, {"tokens": tokens[:CPU_BATCH, :CPU_PROMPT],
                               "frames": frames[:CPU_BATCH, :CPU_FRAMES]},
                ("k", "v", "cross_k", "cross_v"), ENCDEC_ARCH)
    hold_counts(kernels, f"{ENCDEC_ARCH} checks")
    del params, tokens, frames
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"launches": want_ssd, "ms": z_ms, "plain_ms": z_plain,
            "bound_ms": z_bound, "bound_by": z_by, "max_abs_err": z_err}


def _tree_items(tree: dict) -> "dict[str, torch.Tensor]":
    """{"a/b": tensor} of a nested dict, keys sorted."""
    from repro_torch.models.common import named_leaves
    return {"/".join(path): t for path, t in named_leaves(tree)}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float().cpu() - want.cpu()).norm()
                 / max(float(want.norm()), 1e-30))


def _train_batch(vocab: int, b: int, s: int, dev: torch.device) -> dict:
    """The first batch ``train.main`` draws for this shape."""
    from repro_torch.data import DataConfig, SyntheticCorpus
    nb = next(SyntheticCorpus(DataConfig(vocab=vocab, seq_len=s,
                                         global_batch=b)).batch_iter())
    return {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}


def train_main(kernels: dict, what: str, argv: list, want: dict) -> dict:
    """``repro_torch.launch.train.main`` (which asserts that the loss
    fell), its launches counted from 0 and held to ``want``; prints the
    median step of the steady state (the first two steps dropped)."""
    from repro_torch.launch import train
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train.main(argv)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = hold_counts(kernels, what, want)
    steady = out["step_ms"][2:] or out["step_ms"]
    out["median_ms"] = statistics.median(steady)
    print(f"{what}: {out['steps']} steps in {out['wall_s']:.1f} s (init "
          f"and data included), loss {out['first_loss']:.4f} -> "
          f"{out['final_loss']:.4f}, step {out['median_ms']:.3f} ms (host "
          f"clock up to the loss on the host, median of {len(steady)})")
    return out


def training(dev: torch.device, kernels: dict) -> dict:
    """Phase 12: training on the card.  (a) mamba2-130m at full width
    through ``launch.train.main``: the loss falls and ``ssd_chunk``
    launches 24 layers x 4 chunks a step; (b) one train step of it in
    f32 on the card (the kernel's forward) and the CPU (the plain
    version): loss, every gradient leaf and the updated params held;
    (c) m100 through ``train.main``: learns, recovers from a simulated failure,
    learns with compressed gradients; a checkpoint written from the card
    restores on the CPU bit-equal; (d) step times, the step's split by
    ``torch.profiler``, busy share, peak memory and bounds.  Returns the
    SSD kernel's numbers on this path."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.kernels.ssd_scan import ssd_chunk_step_plain
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import M100
    from repro_torch.models import (DTypePolicy, count_params, init_model,
                                    loss_fn, ssm_config)
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ckpt_root = REPO / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    arch = get_arch(TRAIN_ARCH)
    scfg = ssm_config(arch)
    per_step = arch.n_layers * (TRAIN_SEQ // scfg.chunk)
    policy = DTypePolicy.standard()
    f32 = DTypePolicy(torch.float32, torch.float32, torch.float32)
    rt = RuntimeConfig(accum_steps=1, remat="none")

    # ---- (a) mamba2-130m at full width through train.main
    run_a = train_main(
        kernels, f"train {TRAIN_ARCH} full B {TRAIN_BATCH} S {TRAIN_SEQ}",
        ["--arch", TRAIN_ARCH, "--preset", "full", "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
         str(TRAIN_STEPS), "--ckpt-dir", str(ckpt_root / "mamba2"),
         "--ckpt-every", str(10 * TRAIN_STEPS), "--log-every", "5"],
        {"ssd_scan": per_step * TRAIN_STEPS})

    # ---- (b) one f32 step on the card and on the CPU
    opt_cfg = adamw.AdamWConfig(warmup_steps=20, total_steps=TRAIN_STEPS)
    params = init_model(0, arch, f32, dev)
    batch = _train_batch(arch.vocab, 1, GRAD_SEQ, dev)
    step32 = make_train_step(arch, rt, f32, opt_cfg)
    zero_counts(kernels)
    p_card, _, st_card = step32(params, adamw.init(params, f32), batch)
    loss_card, _, g_card = loss_and_grads(params, arch, batch, rt, f32)
    torch.cuda.synchronize()
    n_grad = arch.n_layers * (GRAD_SEQ // scfg.chunk)
    hold_counts(kernels, "f32 train step on the card (step + gradients)",
                {"ssd_scan": 2 * n_grad})
    hp = tree_map(lambda t: t.cpu(), params)
    hb = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    p_cpu, _, st_cpu = make_train_step(arch, rt, f32, opt_cfg)(
        hp, adamw.init(hp, f32), hb)
    loss_cpu, _, g_cpu = loss_and_grads(hp, arch, hb, rt, f32)
    cpu_s = time.perf_counter() - t0
    for k in ("loss", "grad_norm"):
        rel = abs(float(st_card[k]) - float(st_cpu[k])) / abs(
            float(st_cpu[k]))
        print(f"f32 step card vs cpu {k}: {float(st_card[k]):.7g} vs "
              f"{float(st_cpu[k]):.7g}, relative {rel:.3g} (limit "
              f"{GRAD_TOL:g})")
        check(rel <= GRAD_TOL, f"f32 step {k}: card vs cpu {rel:.3g}")
    check(abs(float(loss_card) - float(st_card["loss"]))
          <= 1e-6 * abs(float(st_card["loss"])),
          "loss_and_grads and the step disagree on the loss")
    worst_g, worst_name = 0.0, ""
    gc, gh = _tree_items(g_card), _tree_items(g_cpu)
    check(sorted(gc) == sorted(_tree_items(params)), "a param has no "
          "gradient")
    for name, g in gc.items():
        check(bool(torch.isfinite(g).all()), f"gradient {name} not finite")
        check(float(g.abs().max()) > 0, f"gradient {name} is zero on the "
              "card")
        rel = _rel_l2(g, gh[name])
        if rel > worst_g:
            worst_g, worst_name = rel, name
        check(rel <= GRAD_TOL, f"gradient {name}: card vs cpu relative L2 "
              f"{rel:.3g} > {GRAD_TOL:g}")
    lr1 = float(adamw.cosine_lr(opt_cfg, torch.tensor(1)))
    flips = total = 0
    worst_move = 0.0
    ref, old = _tree_items(p_cpu), _tree_items(hp)
    for name, new in _tree_items(p_card).items():
        d_card, d_cpu = new.cpu() - old[name], ref[name] - old[name]
        flips += int((torch.sign(d_card) != torch.sign(d_cpu)).sum())
        total += d_card.numel()
        worst_move = max(worst_move, float((d_card - d_cpu).abs().max()))
    print(f"f32 step card vs cpu ({TRAIN_ARCH} full, B 1 x S {GRAD_SEQ}, "
          f"{n_grad} SSD chunks a pass): {len(gc)} gradient leaves, all "
          f"finite and nonzero on the card; worst relative L2 {worst_g:.3g} "
          f"({worst_name}; limit {GRAD_TOL:g}); updated params: {flips} of "
          f"{total} entries moved the other way (limit {FLIP_SHARE:g} of "
          f"them), the largest difference {worst_move:.3g} (limit 2 lr + "
          f"1e-6 = {2 * lr1 + 1e-6:.3g}: a flipped sign, plus each side's "
          f"f32 rounding of params up to ~3); the CPU's step and gradients "
          f"took {cpu_s:.1f} s")
    check(flips <= FLIP_SHARE * total, f"{flips} of {total} updates flipped")
    check(worst_move <= 2 * lr1 + 1e-6, "an updated param moved more than a "
          "sign flip can move it")
    del params, p_card, p_cpu, g_card, g_cpu, hp, gc, gh
    torch.cuda.empty_cache()

    # ---- (c) m100 through train.main
    run_m = train_main(kernels, "train m100 (defaults: B 8 x S 128, 50 "
                       "steps)", ["--preset", "m100", "--ckpt-dir",
                                  str(ckpt_root / "m100"), "--log-every",
                                  "10"], {})
    crash = train_main(kernels, "train m100 --simulate-failure 8",
                       ["--preset", "m100", "--steps", "16", "--ckpt-dir",
                        str(ckpt_root / "m100_crash"), "--ckpt-every", "50",
                        "--simulate-failure", "8", "--log-every", "8"], {})
    check(crash["steps"] >= 16, "the crash run did not finish its steps")
    train_main(kernels, "train m100 --compress-grads",
               ["--preset", "m100", "--steps", "20", "--ckpt-dir",
                str(ckpt_root / "m100_comp"), "--compress-grads",
                "--log-every", "10"], {})
    mgr = CheckpointManager(str(ckpt_root / "m100"))
    check(mgr.steps() == [20, 40], f"m100 checkpoints {mgr.steps()}")
    mp = init_model(0, M100, policy, dev)
    tmpl = {"params": mp, "opt": adamw.init(mp, policy)}
    on_card = mgr.restore(tmpl)
    on_cpu = mgr.restore(tree_map(lambda t: t.cpu(), tmpl))
    on_cpu = _tree_items(on_cpu)
    check(all(torch.equal(a.cpu(), on_cpu[k])
              for k, a in _tree_items(on_card).items()),
          "train.main's checkpoint restores differently on card and CPU")
    # a state written from the card, a bf16 leaf among it
    mb = _train_batch(M100.vocab, 8, 128, dev)
    p1, o1, _ = make_train_step(M100, rt, policy)(mp, adamw.init(mp, policy),
                                                    mb)
    state = {"params": {**p1, "embed_bf16": p1["embed"].to(torch.bfloat16)},
             "opt": o1}
    card_mgr = CheckpointManager(str(ckpt_root / "card"))
    card_mgr.save(1, state, blocking=True)
    back = _tree_items(card_mgr.restore(tree_map(lambda t: t.cpu(), state)))
    same = [torch.equal(a.cpu(), back[k]) and a.dtype == back[k].dtype
            for k, a in _tree_items(state).items()]
    check(all(same), "a checkpoint written on the card restores on the CPU "
          "with other bits")
    print(f"checkpoints: m100 train.main's step 40 restores bit-equal on the "
          f"card and the CPU; a state written from the card ({len(same)} "
          "leaves, a bf16 one among them) restores on the CPU bit-equal")
    del mp, tmpl, on_card, on_cpu, p1, o1, state, back
    torch.cuda.empty_cache()

    # ---- (d) numbers: step split, busy share, peak memory, bounds
    def numbers(a, b: int, s: int, n_ssd: int, what: str, run: dict,
                split: bool) -> dict:
        params = init_model(0, a, policy, dev)
        opt = adamw.init(params, policy)
        batch = _train_batch(a.vocab, b, s, dev)
        step = make_train_step(a, rt, policy, adamw.AdamWConfig(
            warmup_steps=20, total_steps=TRAIN_STEPS))
        step(params, opt, batch)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, _ = wall_ms(lambda: step(params, opt, batch))
        peak = torch.cuda.max_memory_allocated()
        events, prof_wall = device_events(lambda: step(params, opt, batch))
        busy = sum(ms for _, ms in events.values())
        ssd = [(n, ms) for k, (n, ms) in events.items() if "ssd_" in k]
        n_par = count_params(params)
        tokens = b * s
        flops = 6 * n_par * tokens
        bound = flops / BF16_FLOPS_PER_S * 1e3
        ssd_f = 0.0
        if n_ssd:
            c = ssm_config(a)
            ssd_f = ssd_work(b, c.n_heads, c.chunk, c.head_dim,
                             c.d_state)[0] * n_ssd
            bound += 3 * 3 * ssd_f / TF32_FLOPS_PER_S * 1e3
        out = {"step_ms": step_ms, "main_step_ms": run["median_ms"],
               "tok_per_s": tokens / run["median_ms"] * 1e3,
               "busy": busy / step_ms, "peak_gb": peak / 1e9,
               "bound_ms": bound, "params": n_par}
        print(f"{what}: step {step_ms:.3f} ms (host clock, fenced, median "
              f"of 3; train.main's {run['median_ms']:.3f} ms), "
              f"{out['tok_per_s']:.1f} tokens/s in train.main; device "
              f"busy {busy:.3f} ms in "
              f"{sum(n for n, _ in events.values())} launches, "
              f"{out['busy']:.1%} of the step "
              f"(profiled wall {prof_wall:.3f} ms); peak memory "
              f"{out['peak_gb']:.2f} GB; bound {bound:.3f} ms = 6 x "
              f"{n_par / 1e6:.2f} M params x {tokens} tokens at "
              f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s"
              + (f" + 3 (split-TF32) x (1 forward + 2 backward) x "
                 f"{ssd_f / 1e9:.3f} GFLOP of {n_ssd} SSD chunks at "
                 f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s" if n_ssd else "")
              + f"; the step is {step_ms / bound:.1f}x it")
        if ssd:
            out["ssd_fwd_launches"] = sum(n for n, _ in ssd)
            out["ssd_fwd_ms"] = sum(ms for _, ms in ssd)
            print(f"{what}: the SSD kernel's forward, {n_ssd} calls "
                  f"({out['ssd_fwd_launches']} device kernels), "
                  f"{out['ssd_fwd_ms']:.3f} ms of device time")
        if split:
            leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
            fwd, _ = device_events(lambda: loss_fn(leaves, a, batch, policy,
                                                   rt=rt))
            del leaves
            both, _ = device_events(
                lambda: loss_and_grads(params, a, batch, rt, policy))
            _, _, grads = loss_and_grads(params, a, batch, rt, policy)
            upd, _ = device_events(lambda: adamw.update(
                grads, opt, params, adamw.AdamWConfig(), policy))
            f_ms = sum(ms for _, ms in fwd.values())
            fb_ms = sum(ms for _, ms in both.values())
            u_ms = sum(ms for _, ms in upd.values())
            out.update(forward_ms=f_ms, backward_ms=fb_ms - f_ms,
                       adamw_ms=u_ms)
            print(f"{what} split (profiler, device): forward {f_ms:.3f} ms, "
                  f"backward {fb_ms - f_ms:.3f} ms, AdamW {u_ms:.3f} ms")
            print_top(f"{what} backward + forward", both, step_ms)
            del grads
        del params, opt
        torch.cuda.empty_cache()
        return out

    num_a = numbers(arch, TRAIN_BATCH, TRAIN_SEQ, per_step,
                    f"{TRAIN_ARCH} B {TRAIN_BATCH} x S {TRAIN_SEQ}", run_a,
                    True)
    num_m = numbers(M100, 8, 128, 0, "m100 B 8 x S 128", run_m, False)
    # the plain backward of one chunk at the path's shape, as SSDChunk runs
    # it, and the kernel's forward of the same chunk
    g = torch.Generator(device=dev).manual_seed(5)
    ins = [t.requires_grad_() for t in ssd_inputs(
        g, TRAIN_BATCH, scfg.n_heads, scfg.chunk, scfg.head_dim,
        scfg.d_state)]
    cot = (torch.randn(ins[0].shape, generator=g, device=dev),
           torch.randn(ins[5].shape, generator=g, device=dev))

    def plain_backward():
        with torch.enable_grad():
            y, h = ssd_chunk_step_plain(*ins)
        return torch.autograd.grad((y, h), ins, cot)

    bwd_ms = time_ms(plain_backward, 5, 1)
    print(f"ssd plain backward at Bt {TRAIN_BATCH} H {scfg.n_heads} Q "
          f"{scfg.chunk} P {scfg.head_dim} N {scfg.d_state}: {bwd_ms:.4f} ms "
          f"a chunk, {per_step} a step: {per_step * bwd_ms:.3f} ms")
    del ins, cot
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return {"train_launches": run_a["launches"]["ssd_scan"],
            "train_step_launches": per_step,
            "train_plain_backward_ms": bwd_ms,
            "train_step_ms": num_a["step_ms"],
            "m100_step_ms": num_m["step_ms"]}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_phase(dev: torch.device, kernels: dict) -> dict:
    """Phase 14: the mesh-bound group on a one-rank process group (NCCL
    on the card).  (a) mamba2-130m's sharded train step at full width;
    (b) ``pipeline_apply`` at P 1; (c) ``compressed_pod_mean``; (d) the
    dry run of qwen3-1.7b x train_4k on both production meshes, in a
    subprocess.  Returns the SSD kernel's counts on these paths."""
    import importlib.util
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.roofline import DeviceCounters
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import DTypePolicy, init_model, ssm_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import _cast_blocks, _layer_apply_full
    from repro_torch.optim import adamw
    from repro_torch.runtime.compressed_sync import (compressed_pod_mean,
                                                     uncompressed_pod_mean)
    from repro_torch.runtime.pipeline import pipeline_apply, split_stages

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fake_pg = importlib.util.find_spec(
        "torch.testing._internal.distributed.fake_pg") is not None
    print(f"mesh: torch.testing._internal.distributed.fake_pg "
          f"{'is' if fake_pg else 'is NOT'} installed (the dry run's fake "
          "world)")
    check(fake_pg, "the fake process group's module is missing")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    mesh = make_test_mesh((1, 1), ("data", "model"), device_type=dev.type)
    pod = make_test_mesh((1,), ("pod",), device_type=dev.type)
    arch = get_arch(TRAIN_ARCH)
    scfg = ssm_config(arch)
    per_step = arch.n_layers * (TRAIN_SEQ // scfg.chunk)
    policy = DTypePolicy.standard()
    f32 = DTypePolicy(torch.float32, torch.float32, torch.float32)
    rt = RuntimeConfig(accum_steps=1, remat="none")
    opt_cfg = adamw.AdamWConfig(warmup_steps=20, total_steps=TRAIN_STEPS)
    baxes = shd.batch_axes_for(mesh, TRAIN_BATCH)

    def placed(params, batch, pol, axes):
        pps = shd.param_pspecs(params, mesh)
        return (shd.place(params, pps, mesh),
                shd.place(adamw.init(params, pol),
                          {"m": pps, "v": pps, "step": shd.P()}, mesh),
                shd.place(batch, shd.input_pspecs(
                    batch, mesh, next(iter(batch.values())).shape[0], axes),
                    mesh))

    # ---- (a) the sharded train step at full width, against the plain one
    params = init_model(0, arch, policy, dev)
    batch = _train_batch(arch.vocab, TRAIN_BATCH, TRAIN_SEQ, dev)
    step = make_train_step(arch, rt, policy, opt_cfg)
    dp, do, db = placed(params, batch, policy, baxes)
    sharded_ms, losses = [], []
    with shd.activation_sharding(mesh, baxes):
        for i in range(MESH_STEPS):
            zero_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp, do, st = step(dp, do, db)
            loss = float(_full(st["loss"]))
            torch.cuda.synchronize()
            sharded_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            hold_counts(kernels, f"sharded step {i + 1}",
                        {"ssd_scan": per_step})
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    plain_ms = []
    p, o = params, adamw.init(params, policy)
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, st = step(p, o, batch)
        float(st["loss"])
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    del dp, do, db, p, o
    torch.cuda.empty_cache()
    sh_med = statistics.median(sharded_ms[1:])
    pl_med = statistics.median(plain_ms[1:])
    print(f"sharded step {TRAIN_ARCH} full B {TRAIN_BATCH} x S {TRAIN_SEQ} "
          f"on a (1, 1) {backend} mesh: {MESH_STEPS} steps, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; {per_step} SSD "
          f"launches a step; host-clock ms (fenced) "
          f"{', '.join(f'{x:.1f}' for x in sharded_ms)} against the plain "
          f"step's {', '.join(f'{x:.1f}' for x in plain_ms)}: median of "
          f"the last {MESH_STEPS - 1} {sh_med:.1f} vs {pl_med:.1f} ms, the "
          f"DTensor step {sh_med / pl_med:.2f}x the plain one")

    # the f32 step and its gradients, sharded against plain on the card
    p32 = init_model(0, arch, f32, dev)
    b32 = _train_batch(arch.vocab, 1, GRAD_SEQ, dev)
    step32 = make_train_step(arch, rt, f32, opt_cfg)
    n_grad = arch.n_layers * (GRAD_SEQ // scfg.chunk)
    # a batch of one row stays whole (batch axes ()): DTensor refuses to
    # merge a Shard(0) dim of size 1 in a view, even on a mesh dim of 1
    dp32, do32, db32 = placed(p32, b32, f32, ())
    zero_counts(kernels)
    with shd.activation_sharding(mesh, ()):
        pm, _, stm = step32(dp32, do32, db32)
        _, _, gm = loss_and_grads(dp32, arch, db32, rt, f32)
        torch.cuda.synchronize()
    hold_counts(kernels, "sharded f32 step + gradients",
                {"ssd_scan": 2 * n_grad})
    pm, gm = tree_map(_full, pm), tree_map(_full, gm)
    pp, _, stp = step32(p32, adamw.init(p32, f32), b32)
    _, _, gp = loss_and_grads(p32, arch, b32, rt, f32)
    for k in ("loss", "grad_norm"):
        got, want = float(_full(stm[k])), float(stp[k])
        rel = abs(got - want) / abs(want)
        print(f"f32 step sharded vs plain {k}: {got:.7g} vs {want:.7g}, "
              f"relative {rel:.3g} (limit {GRAD_TOL:g})")
        check(rel <= GRAD_TOL, f"sharded f32 step {k}: {rel:.3g}")
    worst = 0.0
    gh, gw = _tree_items(gm), _tree_items(gp)
    check(sorted(gh) == sorted(gw), "the sharded gradients' leaves")
    for name, g in gh.items():
        rel = _rel_l2(g, gw[name])
        worst = max(worst, rel)
        check(rel <= GRAD_TOL, f"sharded gradient {name}: {rel:.3g}")
    flips = total = 0
    old, ref = _tree_items(p32), _tree_items(pp)
    for name, new in _tree_items(pm).items():
        d_m, d_p = new - old[name], ref[name] - old[name]
        flips += int((torch.sign(d_m) != torch.sign(d_p)).sum())
        total += d_m.numel()
    print(f"f32 step sharded vs plain ({TRAIN_ARCH} full, B 1 x S "
          f"{GRAD_SEQ}): {len(gh)} gradient leaves, worst relative L2 "
          f"{worst:.3g} (limit {GRAD_TOL:g}); {flips} of {total} updates "
          f"flipped (limit {FLIP_SHARE:g} of them)")
    check(flips <= FLIP_SHARE * total, f"{flips} of {total} flipped")

    # ---- (c) compressed sync of the sharded gradients (bf16 policy)
    dp, _, db = placed(params, batch, policy, baxes)
    with shd.activation_sharding(mesh, baxes):
        _, _, grads = loss_and_grads(dp, arch, db, rt, policy)
    with DeviceCounters() as c_cmp:
        got = compressed_pod_mean(grads, pod)
    with DeviceCounters() as c_ref:
        uncompressed_pod_mean(grads, pod)
    worst_share = 0.0
    for name, g in _tree_items(grads).items():
        g = _full(g).float()
        err = float((_full(_tree_items(got)[name]).float() - g).abs().max())
        step_q = float(g.abs().max()) / 127
        worst_share = max(worst_share, err / max(step_q, 1e-30))
        # round to nearest: half a step, plus the f32 scale's rounding
        check(err <= (0.5 + 1e-4) * step_q, f"compressed {name}: error "
              f"{err:.3g} > half the int8 step {step_q:.3g}")
    ratio = c_cmp.collective_bytes / c_ref.collective_bytes
    print(f"compressed_pod_mean over {len(_tree_items(grads))} gradient "
          f"tensors on a one-rank pod group: worst error {worst_share:.3f} "
          f"of its int8 step; payload {c_cmp.collective_bytes:.0f} B "
          f"(all-gather {c_cmp.payload['all-gather']} B) against the bf16 "
          f"all-reduce's {c_ref.collective_bytes:.0f} B: {ratio:.3f}x "
          "(limit 0.6)")
    check(ratio <= 0.6, f"compressed payload {ratio:.3f}x")
    del dp, db, grads, got, pm, pp, gm, gp, dp32, do32, db32
    torch.cuda.empty_cache()

    # ---- (b) the pipeline at P 1 against the model's own block loop
    g = torch.Generator(device=dev).manual_seed(3)
    mbs = torch.randn((PIPE_MB, PIPE_B, PIPE_S, arch.d_model), generator=g,
                      device=dev).to(policy.compute)
    blocks = _cast_blocks(params["blocks"], policy.compute)

    def layer_fn(bp, h):
        return _layer_apply_full(bp, arch, h)[0]

    with torch.no_grad():
        staged = shd.place(split_stages(blocks, 1), tree_map(
            lambda t: shd.P("pod", *([None] * (t.ndim - 1))),
            split_stages(blocks, 1)), pod)
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_apply(layer_fn, staged, mbs, pod, "pod")
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        pipe_launches = hold_counts(
            kernels, "pipeline P 1", {"ssd_scan": arch.n_layers * (
                PIPE_S // scfg.chunk) * PIPE_MB})["ssd_scan"]
        want = []
        for m in range(PIPE_MB):
            h = mbs[m]
            for l in range(arch.n_layers):
                h = layer_fn(tree_map(lambda t: t[l], blocks), h)
            want.append(h)
        want = torch.stack(want)
    rel = _rel_l2(out, want)
    print(f"pipeline_apply P 1: {PIPE_MB} microbatches of B {PIPE_B} x S "
          f"{PIPE_S} through {arch.n_layers} blocks in {pipe_s:.2f} s, "
          f"{pipe_launches} SSD launches; relative L2 against the block "
          f"loop {rel:.3g} (limit {PIPE_TOL:g})")
    check(tuple(out.shape) == tuple(mbs.shape), "pipeline output shape")
    check(rel <= PIPE_TOL, f"pipeline vs block loop {rel:.3g}")
    del mbs, blocks, staged, out, want, params
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # ---- (d) the dry run on the host, in a subprocess
    out_path = REPO / "build" / "dryrun_smoke.jsonl"
    out_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
         "--out", str(out_path)], capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    dry_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"dry run exit {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in out_path.read_text().splitlines()]
    check(len(rows) == 2 and all(r["status"] == "ok" for r in rows),
          f"dry run rows {[r.get('status') for r in rows]}")
    check(sorted(r["mesh"] for r in rows) == sorted(DRYRUN_STATE_BYTES),
          f"dry run meshes {[r['mesh'] for r in rows]}")
    for r in rows:
        want = DRYRUN_STATE_BYTES[r["mesh"]]
        check(r["state_bytes_per_device"] == want,
              f"{r['mesh']}: state bytes {r['state_bytes_per_device']} != "
              f"the reference's {want}")
        rf = r["roofline"]
        print(f"dry run {r['arch']} x {r['shape']} x {r['mesh']} "
              f"({r['chips']} ranks): ok, trace {r['trace_s']:.1f} s, "
              f"state {r['state_bytes_per_device'] / 2**30:.3f} GiB a "
              f"device ({r['state_share_of_hbm']:.1%} of 80 GB), counted "
              f"{r['counted_flops_per_device']:.4g} flops, "
              f"{r['counted_bytes_per_device']:.4g} B, collectives "
              f"{r['collective_bytes_per_device']:.4g} B; terms compute "
              f"{rf['compute_s'] * 1e3:.2f} ms, memory "
              f"{rf['memory_s'] * 1e3:.2f} ms, collective "
              f"{rf['collective_s'] * 1e3:.2f} ms: dominant "
              f"{rf['dominant']}, mfu bound {rf['mfu_bound']:.3f}")
    print(f"dry run subprocess: {dry_s:.1f} s")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return {"mesh_step_launches": per_step, "mesh_step_ms": sh_med,
            "mesh_plain_step_ms": pl_med, "pipeline_launches": pipe_launches}


def autotune_phase(dev: torch.device, launched: dict) -> dict:
    """Phase 15: ``autotune.tune`` over ``standard_problems`` into a
    dict (the repo's table is read, never written).  Returns, by kernel,
    phases 2, 3 and 5's problem: the table's configuration, its us and
    the default's in this run."""
    from repro_torch.kernels import _build, autotune

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(dev)
    _, table = autotune.read_table()
    entries, main_path, n_cands = {}, {}, 0
    for label, kernel, args, dims in autotune.standard_problems(dev):
        t0 = time.perf_counter()
        entry = autotune.tune(kernel, args, dims, entries=entries)
        n_cands += len(entry["swept"])
        best = min(entry["swept"], key=lambda r: r["us"])
        print(f"autotune {label} ({kernel}, {name}): "
              f"{len(entry['swept'])} candidates, each held to the plain "
              f"version; default {entry['default']} "
              f"{entry['default_us']:.3f} us; fastest {best['config']} "
              f"{best['us']:.3f} us; chosen {entry['config']} "
              f"{entry['us']:.3f} us ({time.perf_counter() - t0:.1f} s)")
        if label not in autotune.MAIN_PATH:
            continue
        key = autotune.shape_key(kernel, name, **dims)
        check(key in table, f"the checked-in table has no entry {key!r}")
        cfg = dict(autotune.get_config(kernel, name, **dims))
        rows = {json.dumps(r["config"], sort_keys=True): r["us"]
                for r in entry["swept"]}
        tuned_us = rows[json.dumps(cfg, sort_keys=True)]
        print(f"autotune {label}: the table's {cfg} {tuned_us:.3f} us, "
              f"the default {entry['default']} {entry['default_us']:.3f} "
              f"us in this run ({tuned_us / entry['default_us']:.4f}x); "
              f"tuned at {table[key]['us']:.3f} against "
              f"{table[key]['default_us']:.3f} us")
        check(tuned_us <= (1 + autotune.MARGIN) * entry["default_us"],
              f"{label}: the table's configuration reads {tuned_us:.3f} "
              f"us, over the default's {entry['default_us']:.3f} us by "
              f"more than {autotune.MARGIN:.0%}")
        main_path[label] = {"kernel": kernel, "config": cfg,
                            "us": tuned_us, "default": entry["default"],
                            "default_us": entry["default_us"]}
        del args
    tuned = {}
    for label, phase in (("gather qwen3-1.7b", 2), ("decode_32k", 3),
                         ("ssd mamba2-130m", 5)):
        row = tuned[main_path[label]["kernel"]] = main_path[label]
        check(launched[row["kernel"]] == row["config"],
              f"phase {phase} launched {row['kernel']} with "
              f"{launched[row['kernel']]}, the table says {row['config']}")
    for lib, names, what in (("amm_gather", ("amm_gather_kernel",),
                              "gather"),
                             ("banked_kv_decode", ("kv_split", "kv_combine"),
                              "decode"),
                             ("ssd_scan", ("ssd_",), "SSD")):
        check_spills(_build.ptxas_report(lib), names, what)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s, {n_cands} "
          "candidates")
    return tuned


def load_script(rel: str):
    """A script of the repo as a module (its ``__main__`` guard keeps it
    from running)."""
    import importlib.util
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(mod, argv: list, echo: bool = True) -> "tuple[object, str]":
    """``mod.main(argv)`` in this process: its result and its stdout
    (echoed unless ``echo`` is false)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    if echo:
        sys.stdout.write(buf.getvalue())
    return out, buf.getvalue()


def scripts_phase(dev: torch.device, kernels: dict) -> dict:
    """Phase 16: the port's copies of the repo's scripts, each loaded by
    path and its ``main`` called here on the card with the counts set to
    0 before each call and read after it.  (a) the quickstart on the card
    and with ``--device cpu``: both stdouts equal ``examples/quickstart.py``'s,
    two ``cycle_lanes`` launches on the card; (b) ``dse_machsuite md_knn
    --full`` cold over a fresh cache (one launch, every point its golden
    row, the fronts, the expansion and the ratio those of the golden
    points), then warm (80 hits, no launch, the same stdout); (c)
    ``check_legality`` over the 390 TINY golden rows (15 launches, 0
    violations, tight on 68, exit 0); (d) ``serve_lm`` with its defaults
    (no kernel) and with mamba2-130m (``ssd_chunk`` once a chunk of each
    layer in the prefill, then held against its plain version at that
    chunk's shape); (e) ``train_lm`` for 160 steps from an empty
    checkpoint directory: the failure at step 150 recovered, the loss
    falling, no kernel.  Returns the launches by kernel and script."""
    import shutil

    from repro_torch.configs import get_arch, tiny_variant
    from repro_torch.core.bench import BENCHMARKS, get_trace
    from repro_torch.core.dse import (design_space_expansion, pareto_front,
                                      performance_ratio)
    from repro_torch.core.sim import prepare_trace
    from repro_torch.models import ssm_config

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mods = {k: load_script(v) for k, v in SCRIPTS.items()}
    seconds: "dict[str, float]" = {}
    launches: "dict[str, dict[str, int]]" = {"cycle_lanes": {},
                                             "ssd_scan": {}}

    # (a) the quickstart, on the card and on the CPU
    t0 = time.perf_counter()
    zero_counts(kernels)
    _, card_out = run_script(mods["quickstart"], [])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    got = hold_counts(kernels, "16a quickstart", {"cycle_lanes": 2})
    launches["cycle_lanes"]["quickstart"] = got["cycle_lanes"]
    t1 = time.perf_counter()
    _, cpu_out = run_script(mods["quickstart"], ["--device", "cpu"],
                            echo=False)
    cpu_s = time.perf_counter() - t1
    hold_counts(kernels, "16a quickstart, then on the CPU",
                {"cycle_lanes": 2})
    check(card_out == cpu_out, "16a: the quickstart's stdout on the card "
          "differs from its stdout on the CPU")
    check(card_out == QUICKSTART_STDOUT, "16a: the quickstart's stdout "
          "differs from examples/quickstart.py's")
    print("16a quickstart: the card's stdout equals the CPU's and "
          f"examples/quickstart.py's, byte for byte; {card_s:.1f} s on "
          f"the card, {cpu_s:.1f} s on the host CPU")
    seconds["16a"] = time.perf_counter() - t0

    # (b) dse_machsuite at full size, cold then warm over one fresh cache
    t0 = time.perf_counter()
    cache_dir = REPO / "build" / "scripts_dse_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    argv = [SCRIPT_BENCH, "--full", "--cache-dir", str(cache_dir)]
    zero_counts(kernels)
    cold, cold_out = run_script(mods["dse_machsuite"], argv)
    torch.cuda.synchronize()
    got = hold_counts(kernels, "16b dse_machsuite cold", {"cycle_lanes": 1})
    launches["cycle_lanes"]["dse_machsuite"] = got["cycle_lanes"]
    want = golden_points(prepare_trace(get_trace(SCRIPT_BENCH, full=True)),
                         json.loads(GOLDEN_SCHEDULE_FULL.read_text()))
    check(same_points(cold["points"], want),
          f"16b: {SCRIPT_BENCH}'s points differ from its golden rows")
    banked = [p for p in want if not p.is_amm]
    amm = [p for p in want if p.is_amm]
    check(same_points(cold["fronts"]["banking"], pareto_front(banked))
          and same_points(cold["fronts"]["amm"], pareto_front(amm)),
          "16b: a Pareto front differs from the golden points'")
    check(cold["expansion"] == design_space_expansion(banked, amm)
          and cold["ratio"] == performance_ratio(want),
          "16b: the expansion or the ratio differs from the golden "
          "points'")
    check((cold["cache_hits"], cold["cache_misses"]) == (0, len(want)),
          f"16b cold: {cold['cache_hits']} hits, {cold['cache_misses']} "
          f"misses, want 0 and {len(want)}")
    zero_counts(kernels)
    warm, warm_out = run_script(mods["dse_machsuite"], argv, echo=False)
    hold_counts(kernels, "16b dse_machsuite warm")
    check((warm["cache_hits"], warm["cache_misses"]) == (len(want), 0),
          f"16b warm: {warm['cache_hits']} hits, {warm['cache_misses']} "
          f"misses, want {len(want)} and 0")
    check(warm_out == cold_out, "16b: the warm run's stdout differs")
    print(f"16b dse_machsuite {SCRIPT_BENCH} --full: {len(want)} points "
          "golden, fronts, expansion and ratio the golden points'; warm: "
          f"{warm['cache_hits']} hits, no launch, the same stdout")
    shutil.rmtree(cache_dir)
    seconds["16b"] = time.perf_counter() - t0

    # (c) the legality checker over the TINY golden matrix
    t0 = time.perf_counter()
    zero_counts(kernels)
    leg, _ = run_script(mods["check_legality"],
                        ["--out", str(REPO / "build" / "legality_report.csv")])
    torch.cuda.synchronize()
    got = hold_counts(kernels, "16c check_legality",
                      {"cycle_lanes": len(BENCHMARKS)})
    launches["cycle_lanes"]["check_legality"] = got["cycle_lanes"]
    check(leg["rows"] == TINY_GOLDEN_ROWS and leg["violations"] == 0
          and leg["tight"] == TIGHT_ROWS and leg["rc"] == 0,
          f"16c: {leg}, want {TINY_GOLDEN_ROWS} rows, 0 violations, tight "
          f"on {TIGHT_ROWS}, rc 0")
    seconds["16c"] = time.perf_counter() - t0

    # (d) serving at the tiny preset: attention, then Mamba2
    t0 = time.perf_counter()
    zero_counts(kernels)
    served, _ = run_script(mods["serve_lm"], [])
    torch.cuda.synchronize()
    hold_counts(kernels, "16d serve_lm qwen3-1.7b tiny")
    check(served["generated"].shape == (SCRIPT_BATCH, SCRIPT_GEN),
          f"16d: generated shape {served['generated'].shape}")
    tiny = tiny_variant(get_arch(SSM_ARCH))
    tcfg = ssm_config(tiny)
    want_ssd = tiny.n_layers * (SCRIPT_PROMPT // tcfg.chunk)
    zero_counts(kernels)
    served, _ = run_script(mods["serve_lm"], ["--arch", SSM_ARCH])
    torch.cuda.synchronize()
    got = hold_counts(kernels, f"16d serve_lm {SSM_ARCH} tiny",
                      {"ssd_scan": want_ssd})
    launches["ssd_scan"]["serve_lm"] = got["ssd_scan"]
    check(served["generated"].shape == (SCRIPT_BATCH, SCRIPT_GEN),
          f"16d: generated shape {served['generated'].shape}")
    # the kernel against its plain version at the chunk this prefill gave
    # it (after the counts were read: these launches are not the path's)
    shape = (SCRIPT_BATCH, tcfg.n_heads, tcfg.chunk, tcfg.head_dim,
             tcfg.d_state)
    hold_ssd(ssd_inputs(torch.Generator(device=dev).manual_seed(16),
                        *shape),
             "16d {} tiny Bt {} H {} Q {} P {} N {} f32".format(SSM_ARCH,
                                                                *shape))
    seconds["16d"] = time.perf_counter() - t0

    # (e) training with the simulated failure, from no checkpoint
    t0 = time.perf_counter()
    ckpt_dir = mods["train_lm"].CKPT_DIR
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    zero_counts(kernels)
    trained, train_out = run_script(mods["train_lm"],
                                    ["--steps", str(TRAIN_LM_STEPS)])
    torch.cuda.synchronize()
    hold_counts(kernels, "16e train_lm")
    check(f"simulated node failure at step {TRAIN_LM_FAILURE}" in train_out
          and f"recovered at step {TRAIN_LM_FAILURE}" in train_out,
          f"16e: no recovery from the failure at step {TRAIN_LM_FAILURE}")
    check(trained["steps"] == TRAIN_LM_STEPS, f"16e: {trained['steps']} "
          f"steps, want {TRAIN_LM_STEPS}")
    check(trained["final_loss"] < trained["first_loss"],
          f"16e: the loss went {trained['first_loss']:.4f} -> "
          f"{trained['final_loss']:.4f}")
    print(f"16e train_lm: recovered at step {TRAIN_LM_FAILURE}, loss "
          f"{trained['first_loss']:.4f} -> {trained['final_loss']:.4f} in "
          f"{trained['steps']} steps, median step "
          f"{statistics.median(trained['step_ms']):.3f} ms (host clock)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    seconds["16e"] = time.perf_counter() - t0

    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import os
    import shutil
    # the benchmarks' on-disk trace cache, fresh under build/
    shutil.rmtree(REPO / "build" / "trace_cache", ignore_errors=True)
    os.environ["REPRO_CACHE_DIR"] = str(REPO / "build" / "trace_cache")
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.kernels import _build, autotune, pack_amm_banks
    from repro_torch.kernels.amm_gather import (amm_gather_u32,
                                                amm_gather_u32_plain)
    from repro_torch.kernels.banked_kv_decode import (
        banked_kv_decode, banked_kv_decode_plain, kernel_split)
    from repro_torch.memory import (BankedKVCache, banked_embedding_lookup,
                                    plan_memory)
    from repro_torch.memory.planner import embedding_stream
    from repro_torch.kernels import ssd_chunk
    from repro_torch.kernels.ssd_scan import kernel_tile as ssd_kernel_tile
    from repro_torch.kernels.ssd_scan import (ssd_chunk_step,
                                              ssd_chunk_step_plain,
                                              tile_counts)
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import (DTypePolicy, forward, init_model,
                                    prefill, ssm_config)
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # ---- 1. card and build ------------------------------------------
    card = autotune.card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = _build.build_all()
    print(f"build: {len(_build.KERNELS)} kernels in {build_s:.1f} s "
          "(set-up)")

    arch = get_arch(ARCH)
    plan = plan_memory(arch, SHAPES[SHAPE])
    for s in plan.streams:
        print(f"plan {ARCH} {SHAPE}: {s}")
    emb_plan = plan.for_stream("embedding")
    kv_plan = plan.for_stream("kv_pages")

    # ---- 2. amm_gather ----------------------------------------------
    vocab, width = arch.padded_vocab, arch.d_model
    print(f"gather: the plan asks for {emb_plan.n_banks} banks; "
          f"{vocab} % {emb_plan.n_banks} = {vocab % emb_plan.n_banks}, so "
          "the plan itself takes the plain gather; this run uses "
          f"{GATHER_BANKS} banks")
    table = torch.randn((vocab, width), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    stream = embedding_stream(arch, n=GATHER_IDS)
    idx = torch.from_numpy(stream).to(dev, torch.int32)
    banks, parity = pack_amm_banks(table, GATHER_BANKS)
    got = amm_gather_u32(banks, parity, idx)
    want = amm_gather_u32_plain(banks, parity, idx)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "amm_gather kernel != plain version")
    check(torch.equal(got, table[idx.long()].view(torch.int16)),
          "amm_gather kernel != table[idx]")
    gather_err = (got.view(torch.bfloat16).float()
                  - want.view(torch.bfloat16).float()).abs().max().item()
    small_b = torch.randint(-2**31, 2**31 - 1, (5, 200, 24), generator=gen,
                            device=dev, dtype=torch.int32)
    small_p = torch.randint(-2**31, 2**31 - 1, (200, 24), generator=gen,
                            device=dev, dtype=torch.int32)
    small_i = torch.randint(0, 1000, (1001,), generator=gen, device=dev,
                            dtype=torch.int32)
    check(torch.equal(amm_gather_u32(small_b, small_p, small_i),
                      amm_gather_u32_plain(small_b, small_p, small_i)),
          "amm_gather kernel != plain on an inconsistent parity plane")
    # the rows the function must read: even slots their direct row, odd
    # slots their parity row and the other banks' rows at their offset
    distinct = torch.unique(idx).numel()
    depth = vocab // GATHER_BANKS
    ids = idx.long()
    odd = ids[1::2]
    off = odd % depth
    bank_ids = torch.arange(GATHER_BANKS, device=dev)
    partners = (bank_ids[None, :] * depth + off[:, None])[
        bank_ids[None, :] != (odd // depth)[:, None]]
    table_rows = torch.unique(torch.cat([ids[0::2], partners])).numel()
    parity_rows = torch.unique(off).numel()
    g_bound, g_by = bound_ms(GATHER_IDS * width * 2
                             + (table_rows + parity_rows) * width * 2
                             + GATHER_IDS * 4)
    g_bound_direct, _ = bound_ms(GATHER_IDS * width * 2
                                 + distinct * width * 2 + GATHER_IDS * 4)
    g_ms = time_ms(lambda: amm_gather_u32(banks, parity, idx))
    launched = {"amm_gather": dict(amm_gather_u32.config)}
    # the same with the L2 flushed before each run (a write of twice its
    # 50 MB), as the lookup finds it after rebuilding the parity plane
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32, device=dev)
    g_cold = time_ms(lambda: amm_gather_u32(banks, parity, idx),
                     before=flush.zero_)
    del flush
    g_plain = time_ms(lambda: amm_gather_u32_plain(banks, parity, idx), 5)
    g_lib = time_ms(lambda: table[idx])
    print(f"gather launch configuration: {launched['amm_gather']}")
    print(f"gather [{vocab}, {width}] bf16 x {GATHER_IDS} ids "
          f"({distinct} distinct), {GATHER_BANKS} banks: bit-equal; "
          f"kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, "
          f"table[idx] {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}: "
          f"{GATHER_IDS} output rows, {table_rows} distinct direct and "
          f"partner rows, {parity_rows} distinct parity rows; counting "
          f"only the {distinct} requested rows gives {g_bound_direct:.4f} "
          f"ms)")
    # the same call counted at the L2: an even slot reads its row, an odd
    # slot its parity row and the other NB - 1 banks' rows, every slot
    # writes one row
    n_odd = GATHER_IDS // 2
    l2_rows = (GATHER_IDS - n_odd) + n_odd * GATHER_BANKS + GATHER_IDS
    l2_bytes = l2_rows * width * 2 + GATHER_IDS * 4
    print(f"gather L2-side: {l2_bytes / 1e9:.4f} GB ({GATHER_IDS - n_odd} "
          f"direct rows, {n_odd} x {GATHER_BANKS} reconstruction rows, "
          f"{GATHER_IDS} rows written) in {g_ms:.4f} ms: "
          f"{l2_bytes / g_ms / 1e9:.2f} TB/s; the bound's bytes move at "
          f"{g_bound / g_ms * HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"({g_bound / g_ms:.1%} of the bound); with the L2 flushed "
          f"before each run the kernel takes {g_cold:.4f} ms "
          f"({g_bound / g_cold:.1%} of the bound)")
    check_spills(_build.ptxas_report("amm_gather"), ("amm_gather_kernel",),
                 "gather")
    del got, want, small_b, small_p, small_i

    # ---- 3. kv_decode -----------------------------------------------
    shape = SHAPES[SHAPE]
    batch, seq = shape.global_batch, shape.seq_len
    hq, hkv, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim

    def ragged(b: int, s: int) -> torch.Tensor:
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[0], lens[1] = 0, s
        return lens

    # f32 at a smaller batch and the full length: 32 splits a row merged
    # by the combine kernel, held to 1e-5
    fb, fs = 4, seq
    q32 = torch.randn((fb, hq, hd), generator=gen, device=dev)
    k32 = torch.randn((fb, hkv, 8, fs // 8, hd), generator=gen, device=dev)
    v32 = torch.randn((fb, hkv, 8, fs // 8, hd), generator=gen, device=dev)
    l32 = ragged(fb, fs)
    o32 = banked_kv_decode(q32, k32, v32, l32)
    f32_err, _, _ = hold_close(o32, banked_kv_decode_plain(q32, k32, v32,
                                                           l32),
                               1e-5, 1e-5, "f32 kv_decode")
    check(bool(torch.all(o32[0] == 0)), "f32 empty row is not 0")
    del q32, k32, v32, o32
    torch.cuda.empty_cache()

    cache = BankedKVCache.create(batch, hkv, seq, hd, dtype=torch.bfloat16,
                                 plan=kv_plan, device=dev)
    print(f"kv: the plan asks for {kv_plan.n_banks} banks; create rounds "
          f"to {cache.n_banks} (largest divisor of {seq})")
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    lens = ragged(batch, seq)
    cache.length.copy_(lens)
    nb, sb = cache.n_banks, seq // cache.n_banks
    kb = cache.k.view(batch, hkv, nb, sb, hd)
    vb = cache.v.view(batch, hkv, nb, sb, hd)
    q = torch.randn((batch, hq, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    got = banked_kv_decode(q, kb, vb, lens)
    want = banked_kv_decode_plain(q, kb, vb, lens)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kv_decode output not finite")
    kv_err, kv_scale, kv_share = hold_close(got, want, BF16_ATOL, BF16_RTOL,
                                            "bf16 kv_decode")
    check(bool(torch.all(got[0] == 0)), "bf16 empty row is not 0")
    del got, want
    kv_ms = time_ms(lambda: banked_kv_decode(q, kb, vb, lens))
    launched["kv_decode"] = dict(banked_kv_decode.config)
    kv_plain = time_ms(lambda: banked_kv_decode_plain(q, kb, vb, lens), 3, 1)
    valid = int(lens.sum().item())
    kv_bytes = valid * hkv * hd * 2 * 2
    kv_bound, kv_by = bound_ms(kv_bytes + 2 * q.numel() * 2 + batch * 4,
                               valid * hq * hd * 4)
    tile = kernel_split(hd, 2, sb)[0]
    split = launched["kv_decode"]["split_len"]
    n_splits = nb * (sb // split)
    busy = int(((lens.long() + split - 1) // split).sum().item()) * hkv
    kv_prof, _ = device_profile(lambda: banked_kv_decode(q, kb, vb, lens),
                                ("kv_split", "kv_combine"))
    split_ms = sum(ms for k, ms in kv_prof.items() if "kv_split" in k)
    combine_ms = sum(ms for k, ms in kv_prof.items() if "kv_combine" in k)
    check(split_ms > 0 and combine_ms > 0,
          f"the profile shows no split or combine kernel: {kv_prof}")
    # yardstick the port never calls: SDPA with a length mask over the
    # same cache, on lengths with no empty row (SDPA gives NaN there)
    lib_lens = torch.clamp(lens, min=1)
    mask = (torch.arange(seq, device=dev)[None, :] < lib_lens[:, None]
            )[:, None, None, :]
    torch.cuda.empty_cache()
    kv_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], cache.k, cache.v, attn_mask=mask, enable_gqa=True),
        3, 1)
    del mask
    torch.cuda.empty_cache()
    print(f"kv_decode B {batch} Hq {hq} Hkv {hkv} D {hd} S {seq} bf16, "
          f"{nb} banks, {valid} valid positions: max err {kv_err:.3g} "
          f"(max |out| {kv_scale:.3g}, {kv_share:.3g} of the limit "
          f"atol {BF16_ATOL:g} + rtol {BF16_RTOL:g} * |out|; f32 case "
          f"max err {f32_err:.3g} of 1e-5); "
          f"kernel {kv_ms:.4f} ms, plain {kv_plain:.4f} ms, "
          f"sdpa {kv_lib:.4f} ms, bound {kv_bound:.4f} ms")
    print(f"kv_decode launch configuration: {launched['kv_decode']}")
    print(f"kv_decode split design: tile {tile} positions, split {split} "
          f"positions, {n_splits} splits a row, {batch * hkv * n_splits} "
          f"split CTAs of which {busy} non-empty; {kv_bytes / 1e9:.4f} GB "
          f"of valid K/V at {kv_bytes / kv_ms / 1e6:.1f} GB/s, "
          f"{kv_bound / kv_ms:.1%} of the bound ({kv_ms / kv_bound:.2f}x "
          f"it), {kv_lib / kv_ms:.2f}x faster than sdpa")
    print(f"kv_decode one profiled call (device): split {split_ms:.4f} ms, "
          f"combine {combine_ms:.4f} ms")
    check_spills(_build.ptxas_report("banked_kv_decode"),
                 ("kv_split", "kv_combine"), "decode")

    # ---- 4. the slice end to end ------------------------------------
    step_plan = dataclasses.replace(emb_plan, n_banks=GATHER_BANKS)
    print(f"end to end: embedding plan {emb_plan.note!r} with n_banks "
          f"{emb_plan.n_banks} -> {GATHER_BANKS}; kv plan "
          f"{kv_plan.n_banks} -> {cache.n_banks} banks")
    step_ids = idx[:DECODE_STEPS * batch].view(DECODE_STEPS, batch)
    step_kv = [(torch.randn((batch, hkv, 1, hd), generator=gen, device=dev,
                            dtype=torch.bfloat16),
                torch.randn((batch, hkv, 1, hd), generator=gen, device=dev,
                            dtype=torch.bfloat16))
               for _ in range(DECODE_STEPS)]
    start_len = cache.length.clone()
    torch.cuda.synchronize()
    amm_gather_u32.launches = 0
    banked_kv_decode.launches = 0
    outs = []
    t0 = time.perf_counter()
    for step in range(DECODE_STEPS):
        x = banked_embedding_lookup(table, step_ids[step], step_plan)
        cache.append(*step_kv[step])
        outs.append((x, cache.decode_read(x.view(batch, hq, hd)),
                     cache.length.clone()))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    launches = {"amm_gather": amm_gather_u32.launches,
                "banked_kv_decode": banked_kv_decode.launches}
    print(f"end to end: {DECODE_STEPS} steps, {step_ms:.3f} ms a step "
          f"(host clock), launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(torch.equal(cache.length,
                      torch.clamp(start_len + DECODE_STEPS, max=seq)),
          "lengths after the appends")
    # the same steps on the plain versions.  Append is plain indexing,
    # the same for both.  A later step writes only at positions at or
    # past this step's lengths (full rows drop their writes), which the
    # decode masks, so the final cache read with a step's lengths is the
    # cache as that step read it.
    pb, pp = pack_amm_banks(table, GATHER_BANKS)
    e2e_err = e2e_scale = e2e_share = 0.0
    for step, (x, o, lens_after) in enumerate(outs):
        xp = amm_gather_u32_plain(pb, pp, step_ids[step]).view(
            torch.bfloat16)
        check(torch.equal(x.view(torch.int16), xp.view(torch.int16)),
              f"step {step}: lookup != plain")
        op = banked_kv_decode_plain(xp.view(batch, hq, hd), kb, vb,
                                    lens_after)
        check(bool(torch.isfinite(o).all()) and o.shape == (batch, hq, hd),
              f"step {step}: output shape or values")
        err, scale, share = hold_close(o, op, BF16_ATOL, BF16_RTOL,
                                       f"step {step} decode")
        e2e_err, e2e_scale = max(e2e_err, err), max(e2e_scale, scale)
        e2e_share = max(e2e_share, share)
    print(f"end to end: lookups bit-equal, decode max err {e2e_err:.3g} "
          f"(max |out| {e2e_scale:.3g}, {e2e_share:.3g} of the limit)")
    # where a step's time goes, timed after every check (the extra
    # appends move the lengths on, which nothing reads any more)
    split = {
        "lookup": time_ms(lambda: banked_embedding_lookup(
            table, step_ids[0], step_plan)),
        "append": time_ms(lambda: cache.append(*step_kv[0])),
        "decode_read": time_ms(lambda: cache.decode_read(q), 5, 1)}
    print("end to end step split (ms, device): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))

    del cache, kb, vb, q, table, banks, parity, pb, pp, outs
    torch.cuda.empty_cache()

    # ---- 5. ssd_chunk -----------------------------------------------
    ssm_arch = get_arch(SSM_ARCH)
    scfg = ssm_config(ssm_arch)
    sb, sh, sq, sp, sn = (SERVE_BATCH, scfg.n_heads, scfg.chunk,
                          scfg.head_dim, scfg.d_state)

    ssd_in = ssd_inputs(gen, sb, sh, sq, sp, sn)
    _, ssd_err = hold_ssd(ssd_in, f"Bt {sb} H {sh} Q {sq} P {sp} N {sn} f32")
    hold_ssd(ssd_inputs(gen, 2, 3, 12, 8, 6),
             "odd Bt 2 H 3 Q 12 P 8 N 6 f32")
    odd = ssd_inputs(gen, 2, 3, 12, 8, 6)
    yb, _ = hold_ssd((odd[0].to(torch.bfloat16),) + odd[1:],
                     "odd, bf16 x (y within one bf16 step)", BF16_RTOL)
    check(torch.equal(yb, yb.to(torch.bfloat16).float()),
          "y of bf16 x is not rounded through bf16")
    ssd_ms = time_ms(lambda: ssd_chunk(*ssd_in))
    launched["ssd_chunk"] = dict(ssd_chunk_step.config)
    ssd_plain = time_ms(lambda: ssd_chunk_step_plain(*ssd_in))
    ssd_flops, ssd_bytes = ssd_work(sb, sh, sq, sp, sn)
    ssd_bound_f32, ssd_by_f32 = bound_ms(ssd_bytes, ssd_flops)
    ssd_bound, ssd_by = bound_ms(ssd_bytes, 3 * ssd_flops, TF32_FLOPS_PER_S)
    print(f"ssd Bt {sb} H {sh} Q {sq} P {sp} N {sn} f32: "
          f"{ssd_flops / 1e9:.3f} GFLOP, {ssd_bytes / 1e6:.2f} MB; kernel "
          f"{ssd_ms:.4f} ms, plain {ssd_plain:.4f} ms; route: split-TF32 "
          f"mma.sync on the tensor cores, bound {ssd_bound:.4f} ms "
          f"({ssd_by}: 3 x {ssd_flops / 1e9:.3f} GFLOP at "
          f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; bytes alone "
          f"{ssd_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), "
          f"{ssd_bound / ssd_ms:.1%} of it; the f32 CUDA-core bound is "
          f"{ssd_bound_f32:.4f} ms ({ssd_by_f32}); no single PyTorch call "
          f"computes this function, so library_ms is null")
    print(f"ssd launch configuration: {launched['ssd_chunk']}")
    tiles = tile_counts(sb, sh, sq, sp, sn, ssd_kernel_tile())
    ssd_prof, _ = device_profile(lambda: ssd_chunk(*ssd_in),
                                 ("ssd_cb_kernel", "ssd_y_kernel",
                                  "ssd_state_kernel"))
    per_kernel = {k: sum(ms for name, ms in ssd_prof.items() if k in name)
                  for k in ("ssd_cb_kernel", "ssd_y_kernel",
                            "ssd_state_kernel")}
    check(all(ms > 0 for ms in per_kernel.values()),
          f"the profile misses an SSD kernel: {ssd_prof}")
    print("ssd one profiled call (device): " + ", ".join(
        f"{k} {ms:.4f} ms ({tiles[k.split('_')[1]]} CTAs)"
        for k, ms in per_kernel.items()))
    check_spills(_build.ptxas_report("ssd_scan"), ("ssd_",), "SSD")
    del ssd_in

    # ---- 6. Mamba2 serving, end to end ------------------------------
    amm_gather_u32.launches = 0
    banked_kv_decode.launches = 0
    ssd_chunk_step.launches = 0
    torch.cuda.synchronize()
    served = serve.main(["--arch", SSM_ARCH, "--preset", "full",
                         "--batch", str(SERVE_BATCH),
                         "--prompt-len", str(SERVE_PROMPT),
                         "--gen", str(SERVE_GEN)])
    torch.cuda.synchronize()
    serve_launches = {"amm_gather": amm_gather_u32.launches,
                      "banked_kv_decode": banked_kv_decode.launches,
                      "ssd_scan": ssd_chunk_step.launches}
    want_launches = ssm_arch.n_layers * (SERVE_PROMPT // scfg.chunk)
    print(f"serve {SSM_ARCH} full: launches {serve_launches} (want "
          f"{want_launches} ssd_scan), {served['tok_per_s']:.1f} tok/s")
    check(serve_launches["ssd_scan"] == want_launches,
          f"ssd_scan launched {serve_launches['ssd_scan']} times, not "
          f"{want_launches}")
    check(served["generated"].shape == (SERVE_BATCH, SERVE_GEN),
          f"generated shape {served['generated'].shape}")

    policy = DTypePolicy.standard()
    f32 = DTypePolicy(torch.float32, torch.float32)
    # serve's weights, with the stacked layer weights rounded through
    # bf16: the JAX forward casts every stacked leaf to the compute dtype
    # (A_log, D, dt_bias and the norm scales included) where prefill and
    # decode keep f32, so with unrounded weights the bf16 check below
    # would measure that rounding, not the path
    params = init_model(0, ssm_arch, policy, dev)
    params["blocks"] = tree_map(lambda t: t.to(torch.bfloat16).float(),
                                params["blocks"])
    prompt_rng = np.random.default_rng(0)
    tokens = torch.from_numpy(prompt_rng.integers(
        0, ssm_arch.vocab, (SERVE_BATCH, SERVE_PROMPT))).to(dev, torch.int32)
    prefill_step = make_prefill_step(ssm_arch, policy,
                                     SERVE_PROMPT + SERVE_GEN)
    decode = make_decode_step(ssm_arch, policy)
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    last = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)

    def prefill_decode_vs_forward(pol: DTypePolicy, tol: float,
                                  what: str) -> None:
        """Decode token t+1 from the prefill's cache (the kernel's h_out
        and the conv tail) and hold it against forward over t+1."""
        _, c = prefill(params, ssm_arch, {"tokens": tokens},
                       SERVE_PROMPT + 1, pol)
        _, dec = make_decode_step(ssm_arch, pol)(params, c, last)[:2]
        full, _ = forward(params, ssm_arch,
                          {"tokens": torch.cat([tokens, last], dim=1)}, pol)
        torch.cuda.synchronize()
        err, scale, share = hold_close(
            dec[:, 0], full[:, SERVE_PROMPT], tol, tol,
            f"{what} prefill-then-decode vs forward")
        print(f"{what} prefill-then-decode vs forward at t+1 = "
              f"{SERVE_PROMPT + 1}, B {SERVE_BATCH}: max err {err:.3g} (max "
              f"|logit| {scale:.3g}, {share:.3g} of the limit atol {tol:g} "
              f"+ rtol {tol:g} * |logit|)")

    prefill_decode_vs_forward(policy, E2E_TOL, "bf16")
    prefill_decode_vs_forward(f32, F32_MODEL_TOL, "f32")
    torch.cuda.empty_cache()
    gen_ids = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_GEN):
        last, logits, cache = decode(params, cache, last)
        gen_ids.append(last)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / SERVE_GEN
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(torch.cat(gen_ids, 1).shape == (SERVE_BATCH, SERVE_GEN),
          "generated ids shape")

    # the whole model in f32: card (kernel) against CPU (plain versions)
    tok32 = tokens[:F32_BATCH, :F32_PROMPT]
    lg_card, c_card = prefill(params, ssm_arch, {"tokens": tok32},
                              F32_PROMPT, f32)
    lg_cpu, c_cpu = prefill(tree_map(lambda t: t.cpu(), params), ssm_arch,
                            {"tokens": tok32.cpu()}, F32_PROMPT, f32)
    f32_errs = [hold_close(got.cpu(), want, F32_MODEL_TOL, F32_MODEL_TOL,
                           f"f32 card vs cpu {what}")
                for what, got, want in (
                    ("logits", lg_card, lg_cpu),
                    ("ssm_h", c_card["ssm_h"], c_cpu["ssm_h"]),
                    ("ssm_conv", c_card["ssm_conv"], c_cpu["ssm_conv"]))]
    print("f32 prefill B {} S {} card vs cpu: ".format(F32_BATCH, F32_PROMPT)
          + ", ".join(f"{w} max err {e[0]:.3g} (max {e[1]:.3g}, {e[2]:.3g} "
                      "of the limit)" for w, e in
                      zip(("logits", "ssm_h", "ssm_conv"), f32_errs)))
    del lg_card, c_card, lg_cpu, c_cpu

    # where the prefill's and a decode step's device time go
    prefill_med = statistics.median(prefill_ms)
    print(f"serve {SSM_ARCH} B {SERVE_BATCH} S {SERVE_PROMPT}: prefill "
          f"{prefill_med:.3f} ms (host clock, median of "
          f"{', '.join(f'{t:.3f}' for t in prefill_ms)}), decode "
          f"{decode_ms:.3f} ms a token step ({SERVE_GEN} steps)")
    print_profile("prefill split", *device_profile(
        lambda: prefill_step(params, {"tokens": tokens})), prefill_med)
    print_profile("decode step split", *device_profile(
        lambda: decode(params, cache, last)), decode_ms)
    print(f"prefill split (events): {want_launches} x {ssd_ms:.4f} ms = "
          f"{want_launches * ssd_ms:.3f} ms of ssd_scan, "
          f"{prefill_med - want_launches * ssd_ms:.3f} ms the rest")

    del params, tokens, logits, cache
    torch.cuda.empty_cache()

    # ---- 7. the replay engine and the fault campaigns ---------------
    replay_and_faults(dev, gen, idx[:REPLAY_IDS], vocab, width)

    # ---- 8. the batched timing backend ------------------------------
    schedule_kernel = timing_backend(dev)

    # ---- 9. the DSE runner and Fig 5 --------------------------------
    schedule_kernel.update(runner_and_fig5(dev))

    # ---- 10. the attention families ---------------------------------
    from repro_torch.kernels.cycle_lanes import cycle_lanes
    attention_serving(dev, {"amm_gather": amm_gather_u32,
                            "banked_kv_decode": banked_kv_decode,
                            "ssd_scan": ssd_chunk_step,
                            "cycle_lanes": cycle_lanes})

    # ---- 11. the hybrid, vlm and audio families ----------------------
    zamba2_ssd = family_serving(dev, gen, {
        "amm_gather": amm_gather_u32, "banked_kv_decode": banked_kv_decode,
        "ssd_scan": ssd_chunk_step, "cycle_lanes": cycle_lanes})

    # ---- 12. training ------------------------------------------------
    train_ssd = training(dev, {
        "amm_gather": amm_gather_u32, "banked_kv_decode": banked_kv_decode,
        "ssd_scan": ssd_chunk_step, "cycle_lanes": cycle_lanes})

    # ---- 13. the surrogate-pruned sweep ------------------------------
    schedule_kernel["pruned"] = pruned_sweep(dev, {
        "amm_gather": amm_gather_u32, "banked_kv_decode": banked_kv_decode,
        "ssd_scan": ssd_chunk_step, "cycle_lanes": cycle_lanes},
        schedule_kernel["launch_ms"], schedule_kernel["runner_cold_s"])

    # ---- 14. the mesh ------------------------------------------------
    train_ssd.update(mesh_phase(dev, {
        "amm_gather": amm_gather_u32, "banked_kv_decode": banked_kv_decode,
        "ssd_scan": ssd_chunk_step, "cycle_lanes": cycle_lanes}))

    # ---- 15. the autotuner ------------------------------------------
    tuned = autotune_phase(dev, launched)

    # ---- 16. the scripts ----------------------------------------------
    scripts = scripts_phase(dev, {
        "amm_gather": amm_gather_u32, "banked_kv_decode": banked_kv_decode,
        "ssd_scan": ssd_chunk_step, "cycle_lanes": cycle_lanes})

    def tuned_keys(kernel: str) -> dict:
        row = tuned[kernel]
        return {"config": row["config"]} | (
            {} if row["config"] == row["default"]
            else {"default_ms": row["default_us"] / 1e3})

    kernels = [{
        "name": "amm_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/amm_gather.cu",
        "replaces": "src/repro/kernels/amm_gather.py:47",
        "launches": launches["amm_gather"], "max_abs_err": gather_err,
        "ms": g_ms, "kernel_ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
        "bound_by": g_by, "library_ms": g_lib,
        **tuned_keys("amm_gather")}, {
        "name": "banked_kv_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/banked_kv_decode.cu",
        "replaces": "src/repro/kernels/banked_kv_decode.py:74",
        "launches": launches["banked_kv_decode"], "max_abs_err": kv_err,
        "ms": kv_ms, "kernel_ms": kv_ms, "plain_ms": kv_plain, "bound_ms": kv_bound,
        "bound_by": kv_by, "library_ms": kv_lib,
        **tuned_keys("kv_decode")}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:58",
        "launches": serve_launches["ssd_scan"], "max_abs_err": ssd_err,
        "ms": ssd_ms, "kernel_ms": ssd_ms, "plain_ms": ssd_plain,
        "bound_ms": ssd_bound, "bound_by": ssd_by, "library_ms": None,
        "zamba2_prefill": zamba2_ssd, **train_ssd,
        "scripts_launches": scripts["ssd_scan"],
        **tuned_keys("ssd_chunk")},
        {**schedule_kernel, "scripts_launches": scripts["cycle_lanes"],
         "config": None}]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
