#!/usr/bin/env python3
"""Drive the PyTorch port's serving-memory path on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA Hopper card
(sm_90a) and nvcc.  Phases, each of which fails the run if a check
fails:

1. card and build: the card's name and power limit, then nvcc builds
   every kernel of ``src/repro_torch/csrc/`` into ``build/`` (set-up);
2. ``amm_gather`` at qwen3-1.7b's width: a [151936, 2048] bf16 table,
   65536 token ids from the planner's embedding stream, 8 banks; the
   kernel is bit-equal to its plain version, and so is a small int32
   case whose parity plane is not the XOR of its banks;
3. ``kv_decode`` at decode_32k and qwen3-1.7b's width (Hq 16, Hkv 8,
   D 128, S 32768, batch 128, bf16) with the planner's KV bank plan;
   ragged lengths with one empty and one full row; within one bf16
   rounding of the plain version (see ``BF16_ATOL``), the empty row
   exactly 0; an f32 case within 1e-5;
4. the slice end to end: 4 decode steps, each an embedding lookup
   through ``banked_embedding_lookup``, an ``append`` and a
   ``decode_read``, held against the same steps on the plain versions;
   both kernels' launch counts must rise in this run.

It then prints the ``kernels`` JSON line (kernel, plain, library and
bound times), and last ``{"ok": true, "device": {...}}``.  It exits
non-zero, printing no result, when there is no CUDA device or the
package is missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
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


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, each run fenced by CUDA
    events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
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


def bound_ms(n_bytes: float, n_flops: float = 0.0) -> "tuple[float, str]":
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.kernels import _build, pack_amm_banks
    from repro_torch.kernels.amm_gather import (amm_gather_u32,
                                                amm_gather_u32_plain)
    from repro_torch.kernels.banked_kv_decode import (
        banked_kv_decode, banked_kv_decode_plain)
    from repro_torch.memory import (BankedKVCache, banked_embedding_lookup,
                                    plan_memory)
    from repro_torch.memory.planner import embedding_stream

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # ---- 1. card and build ------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
    distinct = torch.unique(idx).numel()
    g_bound, g_by = bound_ms(GATHER_IDS * width * 2 + distinct * width * 2
                             + GATHER_IDS * 4)
    g_ms = time_ms(lambda: amm_gather_u32(banks, parity, idx))
    g_plain = time_ms(lambda: amm_gather_u32_plain(banks, parity, idx), 5)
    g_lib = time_ms(lambda: table[idx])
    print(f"gather [{vocab}, {width}] bf16 x {GATHER_IDS} ids "
          f"({distinct} distinct), {GATHER_BANKS} banks: bit-equal; "
          f"kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, "
          f"table[idx] {g_lib:.4f} ms, bound {g_bound:.4f} ms")
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

    # f32 at a smaller batch: 1e-5
    fb, fs = 8, 4096
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
    kv_plain = time_ms(lambda: banked_kv_decode_plain(q, kb, vb, lens), 3, 1)
    valid = int(lens.sum().item())
    kv_bound, kv_by = bound_ms(
        valid * hkv * hd * 2 * 2 + 2 * q.numel() * 2 + batch * 4,
        valid * hq * hd * 4)
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

    kernels = [{
        "name": "amm_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/amm_gather.cu",
        "replaces": "src/repro/kernels/amm_gather.py:47",
        "launches": launches["amm_gather"], "max_abs_err": gather_err,
        "ms": g_ms, "kernel_ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
        "bound_by": g_by, "library_ms": g_lib}, {
        "name": "banked_kv_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/banked_kv_decode.cu",
        "replaces": "src/repro/kernels/banked_kv_decode.py:74",
        "launches": launches["banked_kv_decode"], "max_abs_err": kv_err,
        "ms": kv_ms, "kernel_ms": kv_ms, "plain_ms": kv_plain, "bound_ms": kv_bound,
        "bound_by": kv_by, "library_ms": kv_lib}]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
