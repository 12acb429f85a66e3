"""Launch-geometry autotuning for the port's hand-written kernels.

The counterpart of the JAX package's ``kernels/autotune.py``.  Each CUDA
kernel takes its launch geometry as arguments:

- ``amm_gather``: ``pairs``, the even/odd request pairs (one warp each)
  a CTA serves, 1-16 (the JAX ``block_n`` is 2 x pairs ids), and
  ``word_bytes``, the width a lane moves at a time, 16, 8, 4 or 2 bytes,
  at most the widest word that divides the row pitch and every base;
- ``kv_decode``: ``head_block``, the query heads a split CTA serves, 1,
  2 or 4 (the JAX ``block_h``); ``split_len``, the positions a split CTA
  scores (the whole bank, or a multiple of the kernel's tile that
  divides it); ``bulk``, TMA bulk copies (1) or plain loads (0);
- ``ssd_chunk``: ``vec``, 16-byte staging (1) or 4-byte copies (0).  The
  tile stays the compiled 64 (``ssd_scan.kernel_tile``).

``default_config`` is each kernel's launch before this module existed.
``tune`` times every legal candidate at one shape on the card, after
holding its output against the kernel's plain version (a candidate that
differs raises), and keeps the default unless another configuration is
at least ``MARGIN`` faster.  Winners live in the checked-in table
``_autotune_cache.json`` under ``kernel|<CUDA device name>|<shape
bucket>``.  The wrappers resolve every CUDA launch through ``resolve``:
an explicit configuration must be legal or raises, a table hit is
brought back to a legal configuration at the actual shape
(``_legalize``), a miss takes the default.  A CPU tensor takes the plain
version and never reads the table.

Shape buckets round every dimension up to a power of two, as the
reference does, so one winner serves neighbouring shapes.  The dims a
wrapper passes (its module's ``launch_dims``) are the shape's, which
make the key, and ``LAUNCH_DIMS``, which set legality at the actual
call and stay out of the key: the gather's widest word ``word``, the
decode's tile ``tile`` and bulk-copy legality ``vec``, the SSD's 16-byte
legality ``vec``.

Unlike the reference, a damaged table raises a ``ValueError`` naming its
path (the file carries a sha256 of its contents); a missing one reads
as empty.  Re-tune on the card, e.g. after a kernel change::

    python -m repro_torch.kernels.autotune [--repeat N] [--dry-run]
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import types

import torch

_CACHE_FILE = pathlib.Path(__file__).with_name("_autotune_cache.json")
_TABLE: "dict[str, dict] | None" = None

MARGIN = 0.03              # a winner must beat the default by this share
SPLIT_TARGET = 1024        # the default split: at most this many positions
MIN_SPLIT = 64             # the shortest split a sweep times
PAIRS = (1, 2, 4, 8, 16)
DEFAULT_PAIRS = 4
WORDS = (16, 8, 4, 2)
HEAD_BLOCKS = (1, 2, 4)
SPIN_CYCLES = 35_000_000   # ~20 ms at the H100's 1.755 GHz boost clock
LAUNCH_DIMS = ("word", "tile", "vec")
# the problems of standard_problems that the main path launches
MAIN_PATH = ("gather qwen3-1.7b", "decode_32k", "ssd mamba2-130m",
             "ssd zamba2-2.7b")


# -- launch rules -------------------------------------------------------
def split_len(bank_len: int, tile: int, target: int = SPLIT_TARGET) -> int:
    """The longest legal split at most ``target`` positions long: the
    whole bank when it holds at most ``target`` positions or is not a
    whole number of tiles, else the longest equal sub-division of the
    bank that is a multiple of the tile (at least one tile).  A split
    thus always lies inside one bank, and the splits tile every bank
    exactly."""
    if bank_len <= target or bank_len % tile:
        return bank_len
    tiles = bank_len // tile
    per_split = max(k for k in range(1, max(1, target // tile) + 1)
                    if tiles % k == 0)
    return per_split * tile


def head_block(group: int) -> int:
    """The default head block: the group rounded up to a power of two,
    at most 4."""
    return 1 if group <= 1 else 2 if group <= 2 else 4


def _legal_splits(bank_len: int, tile: int) -> "list[int]":
    if bank_len % tile:
        return [bank_len]
    tiles = bank_len // tile
    return [k * tile for k in range(1, tiles + 1) if tiles % k == 0]


def default_config(kernel: str, **dims: int) -> "dict[str, int]":
    """Each kernel's launch as it was before the table: the gather 4
    pairs a CTA at the widest word; the decode's head block by the group,
    ``split_len`` at ``SPLIT_TARGET`` and bulk copies where legal; the
    SSD's 16-byte staging where legal."""
    if kernel == "amm_gather":
        return {"pairs": DEFAULT_PAIRS, "word_bytes": dims["word"]}
    if kernel == "kv_decode":
        return {"head_block": head_block(dims["hq"] // dims["hkv"]),
                "split_len": split_len(dims["s"] // dims["nb"],
                                       dims["tile"]),
                "bulk": dims["vec"]}
    if kernel == "ssd_chunk":
        return {"vec": dims["vec"]}
    raise KeyError(f"unknown kernel {kernel!r}")


def is_legal(kernel: str, cfg: "dict[str, int]", **dims: int) -> bool:
    """Whether the kernel takes ``cfg`` at this shape."""
    if kernel == "amm_gather":
        return (set(cfg) == {"pairs", "word_bytes"}
                and cfg["pairs"] in PAIRS and cfg["word_bytes"] in WORDS
                and cfg["word_bytes"] <= dims["word"])
    if kernel == "kv_decode":
        return (set(cfg) == {"head_block", "split_len", "bulk"}
                and cfg["head_block"] in HEAD_BLOCKS
                and cfg["split_len"] in _legal_splits(
                    dims["s"] // dims["nb"], dims["tile"])
                and cfg["bulk"] in (0, 1) and cfg["bulk"] <= dims["vec"])
    if kernel == "ssd_chunk":
        return (set(cfg) == {"vec"} and cfg["vec"] in (0, 1)
                and cfg["vec"] <= dims["vec"])
    raise KeyError(f"unknown kernel {kernel!r}")


def check_config(kernel: str, cfg: "dict[str, int]", **dims: int) -> None:
    """Raise ``ValueError`` unless the kernel takes ``cfg`` here."""
    if not is_legal(kernel, cfg, **dims):
        raise ValueError(f"{kernel}: launch configuration {dict(cfg)} is "
                         f"not legal at {dims}")


def candidates(kernel: str, **dims: int) -> "list[dict[str, int]]":
    """The configurations a sweep times at this (actual) shape: every
    legal one, but for the decode no head block beyond the default
    (heads past the group are masked work) and no split shorter than
    ``MIN_SPLIT`` positions other than the default's."""
    if kernel == "amm_gather":
        return [{"pairs": p, "word_bytes": w} for p in PAIRS for w in WORDS
                if w <= dims["word"]]
    if kernel == "kv_decode":
        bank = dims["s"] // dims["nb"]
        default = default_config(kernel, **dims)
        splits = sorted({s for s in _legal_splits(bank, dims["tile"])
                         if s >= min(bank, MIN_SPLIT)}
                        | {default["split_len"]})
        return [{"head_block": h, "split_len": s, "bulk": u}
                for h in HEAD_BLOCKS if h <= default["head_block"]
                for s in splits for u in range(dims["vec"] + 1)]
    if kernel == "ssd_chunk":
        return [{"vec": v} for v in range(dims["vec"] + 1)]
    raise KeyError(f"unknown kernel {kernel!r}")


def _legalize(kernel: str, cfg: "dict[str, int]", **dims: int
              ) -> "dict[str, int]":
    """A bucket's winner brought back to a legal configuration at the
    actual shape (the counterpart of the reference's ``ops._pick_block``):
    the widest legal word at most the winner's; the largest head block at
    most the winner's and the default's; the longest legal split at most
    the winner's (``split_len`` with the winner's as target); bulk copies
    or 16-byte staging only where legal."""
    if kernel == "amm_gather":
        return {"pairs": cfg["pairs"],
                "word_bytes": min(cfg["word_bytes"], dims["word"])}
    if kernel == "kv_decode":
        cap = min(cfg["head_block"], head_block(dims["hq"] // dims["hkv"]))
        return {"head_block": max(h for h in HEAD_BLOCKS if h <= cap),
                "split_len": split_len(dims["s"] // dims["nb"],
                                       dims["tile"], cfg["split_len"]),
                "bulk": min(cfg["bulk"], dims["vec"])}
    if kernel == "ssd_chunk":
        return {"vec": min(cfg["vec"], dims["vec"])}
    raise KeyError(f"unknown kernel {kernel!r}")


# -- shape bucketing / the table ----------------------------------------
def _pow2_bucket(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def shape_key(kernel: str, device_name: str, **dims: int) -> str:
    """``kernel|device_name|dims``, each shape dim rounded up to a power
    of two as the reference rounds it (``LAUNCH_DIMS`` left out)."""
    parts = ";".join(f"{k}={_pow2_bucket(v)}" for k, v in sorted(dims.items())
                     if k not in LAUNCH_DIMS)
    return f"{kernel}|{device_name}|{parts}"


_FRAME = re.compile(r'\{"version": 1,\n "cards": (\{[^\n]*\}),\n '
                    r'"sha256": "([0-9a-f]{64})",\n "entries": (\{.*\})\}\n',
                    re.S)


def _digest(cards: str, entries: str) -> str:
    return hashlib.sha256(f"{cards}\n{entries}".encode()).hexdigest()


def read_table(path: "str | os.PathLike" = _CACHE_FILE
               ) -> "tuple[dict[str, str], dict[str, dict]]":
    """(cards, entries) of the table at ``path``: each card's name and
    ``nvidia-smi`` line (name, power limit), and the tuned entries by
    key.  A missing file reads as empty; one whose text is not as
    ``save_table`` wrote it raises ``ValueError`` naming its path."""
    path = pathlib.Path(path)
    if not path.is_file():
        return {}, {}
    raw = path.read_bytes()
    m = _FRAME.fullmatch(raw.decode("ascii")) if raw.isascii() else None
    if m is None or m.group(2) != _digest(m.group(1), m.group(3)):
        raise ValueError(f"damaged autotune table {path}: its text is not "
                         "as save_table wrote it (delete it, or re-tune "
                         "with python -m repro_torch.kernels.autotune)")
    d = json.loads(raw)
    return d["cards"], d["entries"]


def load_table(path: "str | os.PathLike" = _CACHE_FILE,
               refresh: bool = False) -> "dict[str, dict]":
    """The entries the wrappers consult, read once (again on
    ``refresh``, which also makes ``path`` the table in use)."""
    global _TABLE
    if _TABLE is None or refresh:
        _TABLE = read_table(path)[1]
        _config.cache_clear()
    return _TABLE


def save_table(entries: "dict[str, dict]",
               path: "str | os.PathLike" = _CACHE_FILE,
               cards: "dict[str, str] | None" = None) -> None:
    """Write ``entries`` (and the cards they were tuned on) to ``path``
    atomically, and make them the table in use."""
    global _TABLE
    cards_text = json.dumps(cards or {}, sort_keys=True)
    entries_text = json.dumps(entries, indent=1, sort_keys=True)
    path = pathlib.Path(path)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(f'{{"version": 1,\n "cards": {cards_text},\n "sha256": '
                   f'"{_digest(cards_text, entries_text)}",\n "entries": '
                   f'{entries_text}}}\n')
    os.replace(tmp, path)
    _TABLE = dict(entries)
    _config.cache_clear()


@functools.lru_cache(maxsize=4096)
def _config(kernel: str, device_name: str, items: tuple
            ) -> "types.MappingProxyType":
    dims = dict(items)
    hit = load_table().get(shape_key(kernel, device_name, **dims))
    cfg = (_legalize(kernel, hit["config"], **dims) if hit
           else default_config(kernel, **dims))
    check_config(kernel, cfg, **dims)
    return types.MappingProxyType(cfg)


def get_config(kernel: str, device_name: str, **dims: int
               ) -> "types.MappingProxyType":
    """The table's configuration for this call (legalized at ``dims``),
    or the kernel's default on a miss; memoized per (kernel, card,
    dims), so a repeated launch pays one dict lookup."""
    return _config(kernel, device_name, tuple(sorted(dims.items())))


@functools.cache
def device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def resolve(kernel: str, device: torch.device, dims: "dict[str, int]",
            **given: "int | None") -> "types.MappingProxyType | dict":
    """The configuration of one CUDA launch: each ``given`` value that is
    not None, the table's (or the default) for the rest.  An explicit
    configuration that the kernel does not take raises."""
    cfg = get_config(kernel, device_name(device.index or 0), **dims)
    if all(v is None for v in given.values()):
        return cfg
    cfg = {**cfg, **{k: v for k, v in given.items() if v is not None}}
    check_config(kernel, cfg, **dims)
    return cfg


# -- timing ------------------------------------------------------------
def time_cuda(fn, repeat: int = 30, warmup: int = 2
              ) -> "tuple[float, float]":
    """(median device us a call, first-call ms).  The first call is
    fenced on the host clock; after ``warmup`` more, the card spins
    ~20 ms so the host queues every timed call before the first starts,
    and each is fenced by CUDA events.  nvcc's build time is not in
    either number (``_build.build_all`` reports it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    pairs = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3, \
        first_ms


# -- the tuner ---------------------------------------------------------
def _make_call(kernel: str, args: tuple, cfg: "dict[str, int]"):
    from repro_torch.kernels.amm_gather import amm_gather_u32
    from repro_torch.kernels.banked_kv_decode import banked_kv_decode
    from repro_torch.kernels.ssd_scan import ssd_chunk_step

    fn = {"amm_gather": amm_gather_u32, "kv_decode": banked_kv_decode,
          "ssd_chunk": ssd_chunk_step}[kernel]
    return lambda: fn(*args, **cfg)


def _plain(kernel: str, args: tuple):
    from repro_torch.kernels.amm_gather import amm_gather_u32_plain
    from repro_torch.kernels.banked_kv_decode import banked_kv_decode_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_step_plain

    return {"amm_gather": amm_gather_u32_plain,
            "kv_decode": banked_kv_decode_plain,
            "ssd_chunk": ssd_chunk_step_plain}[kernel](*args)


def _close(got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float) -> bool:
    want = want.float()
    return bool(((got.float() - want).abs()
                 <= atol + rtol * want.abs()).all())


def holds(kernel: str, got, want, args: tuple) -> bool:
    """The gates of the kernel against its plain version: the gather
    bit-equal; the decode within atol 1e-4 + rtol 2^-7 in bf16 (both
    round the output once) or 1e-5 in f32; the SSD chunk within atol
    1e-4 + rtol 1e-5 (y of a bf16 x within one bf16 step, rtol 2^-7)."""
    if kernel == "amm_gather":
        return torch.equal(got, want)
    if kernel == "kv_decode":
        bf16 = args[0].dtype == torch.bfloat16
        return _close(got, want, 1e-4 if bf16 else 1e-5,
                      2.0 ** -7 if bf16 else 1e-5)
    y_rtol = 2.0 ** -7 if args[0].dtype == torch.bfloat16 else 1e-5
    return (_close(got[0], want[0], 1e-4, y_rtol)
            and _close(got[1], want[1], 1e-4, 1e-5))


def tune(kernel: str, args: tuple, dims: "dict[str, int]",
         repeat: int = 30, entries: "dict | None" = None, *,
         card: "str | None" = None, timer=time_cuda,
         make_call=_make_call) -> dict:
    """Time every candidate of one kernel at one shape and return the
    entry (recorded into ``entries`` when given).  Each candidate's
    output is held against the plain version before its time counts, and
    one that differs raises.  The fastest replaces the default only when
    at least ``MARGIN`` faster.  ``card`` names the card in the key (by
    default the CUDA device of ``args``); ``timer`` and ``make_call`` are
    ``time_cuda`` and a call of the kernel's wrapper."""
    if card is None:
        card = device_name(args[0].device.index or 0)
    want = _plain(kernel, args)
    default = default_config(kernel, **dims)
    rows = []
    for cfg in candidates(kernel, **dims):
        fn = make_call(kernel, args, cfg)
        us, first_ms = timer(fn, repeat, 2)
        if not holds(kernel, fn(), want, args):
            raise RuntimeError(f"{kernel} at {dims}: configuration {cfg} "
                               "differs from the plain version")
        rows.append({"config": cfg, "us": round(us, 3),
                     "first_ms": round(first_ms, 3)})
    base = next(r for r in rows if r["config"] == default)
    best = min(rows, key=lambda r: r["us"])
    win = best if best["us"] <= (1.0 - MARGIN) * base["us"] else base
    entry = {"config": win["config"], "us": win["us"], "default": default,
             "default_us": base["us"], "first_ms": win["first_ms"],
             "dims": dict(dims), "swept": rows}
    if entries is not None:
        entries[shape_key(kernel, card, **dims)] = entry
    return entry


# -- the shapes the tuner sweeps ---------------------------------------
def _ssd_inputs(gen: torch.Generator, bt: int, h: int, q: int, p: int,
                n: int) -> tuple:
    """dt in [1e-3, 1e-1], A = -linspace(1, 16, h) as the model's A_log
    gives it, cum = cumsum(dt A); normal x, B, C and h_in."""
    dev = gen.device
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((bt, h, q), generator=gen,
                                            device=dev)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    cum = torch.cumsum(dt * A[None, :, None], dim=-1)
    return (torch.randn((bt, h, q, p), generator=gen, device=dev), dt,
            cum, torch.randn((bt, q, n), generator=gen, device=dev),
            torch.randn((bt, q, n), generator=gen, device=dev),
            torch.randn((bt, h, p, n), generator=gen, device=dev))


def standard_problems(device: torch.device):
    """(label, kernel, args, dims) of each shape the tuner sweeps, made
    one at a time from seed 0: the reference's six small shapes
    (``src/repro/kernels/autotune.py:164-188``, f32) and the main path's
    (``MAIN_PATH``): the gather at qwen3-1.7b's [151936, 2048] bf16 table,
    8 banks, the planner's 65536 token ids; the decode at decode_32k (B
    128, Hq 16, Hkv 8, D 128, S 32768, bf16, 8 banks, lengths uniform in
    [1, S] with one empty and one full row, as phase 3 of chip_smoke.py
    draws them); the SSD chunk at mamba2-130m's (Bt 8, H 24, Q 256, P 64,
    N 128) and zamba2-2.7b's (H 80, N 64) shapes, f32."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.amm_gather import launch_dims as gather_dims
    from repro_torch.kernels.banked_kv_decode import launch_dims as kv_dims
    from repro_torch.kernels.ops import pack_amm_banks
    from repro_torch.kernels.ssd_scan import launch_dims as ssd_dims
    from repro_torch.memory.planner import embedding_stream

    gen = torch.Generator(device=device).manual_seed(0)

    def gather(label, v, d, nb, ids, dtype):
        table = torch.randn((v, d), generator=gen, device=device).to(dtype)
        banks, parity = pack_amm_banks(table, nb)
        args = (banks, parity, ids)
        return label, "amm_gather", args, gather_dims(*args)

    def decode(label, b, hq, hkv, s, d, nb, dtype, lens):
        q = torch.randn((b, hq, d), generator=gen, device=device,
                        dtype=dtype)
        k = torch.randn((b, hkv, nb, s // nb, d), generator=gen,
                        device=device, dtype=dtype)
        v = torch.randn((b, hkv, nb, s // nb, d), generator=gen,
                        device=device, dtype=dtype)
        args = (q, k, v, lens)
        return label, "kv_decode", args, kv_dims(q, k, v)

    def ssd(label, *shape):
        args = _ssd_inputs(gen, *shape)
        return label, "ssd_chunk", args, ssd_dims(*args)

    def uniform(b, s):
        return torch.randint(1, s + 1, (b,), generator=gen, device=device,
                             dtype=torch.int32)

    for v, d, nb, n in ((1024, 128, 4, 256), (4096, 64, 8, 2048)):
        yield gather(f"ref gather {v}x{d}", v, d, nb,
                     torch.randint(0, v, (n,), generator=gen, device=device,
                                   dtype=torch.int32), torch.float32)
    for b, hq, hkv, s, d, nb in ((4, 8, 4, 512, 64, 8),
                                 (8, 16, 2, 1024, 64, 8)):
        yield decode(f"ref decode B{b} S{s}", b, hq, hkv, s, d, nb,
                     torch.float32, uniform(b, s))
    for shape in ((2, 4, 64, 32, 16), (2, 8, 128, 64, 32)):
        yield ssd(f"ref ssd H{shape[1]} Q{shape[2]}", *shape)

    arch = get_arch("qwen3-1.7b")
    ids = torch.from_numpy(embedding_stream(arch, n=65536)).to(
        device, torch.int32)
    yield gather(MAIN_PATH[0], arch.padded_vocab, arch.d_model, 8, ids,
                 torch.bfloat16)
    lens = uniform(128, 32768)
    lens[0], lens[1] = 0, 32768
    yield decode(MAIN_PATH[1], 128, 16, 8, 32768, 128, 8, torch.bfloat16,
                 lens)
    yield ssd(MAIN_PATH[2], 8, 24, 256, 64, 128)
    yield ssd(MAIN_PATH[3], 8, 80, 256, 64, 64)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Re-tune the CUDA kernels' launch geometry on this "
                    "card and rewrite the table.")
    ap.add_argument("--repeat", type=int, default=30,
                    help="timed calls per candidate")
    ap.add_argument("--dry-run", action="store_true",
                    help="print winners without rewriting the table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("autotune: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = card_line()
    print(card)
    print(f"build: {_build.build_all():.1f} s")
    dev = torch.device("cuda", torch.cuda.current_device())
    cards, entries = read_table()
    t0 = time.perf_counter()
    for label, kernel, call_args, dims in standard_problems(dev):
        entry = tune(kernel, call_args, dims, repeat=args.repeat,
                     entries=entries)
        print(f"{label}: {len(entry['swept'])} candidates; default "
              f"{entry['default']} {entry['default_us']:.3f} us; chosen "
              f"{entry['config']} {entry['us']:.3f} us")
    print(f"tuned in {time.perf_counter() - t0:.1f} s")
    if not args.dry_run:
        save_table(entries, cards={**cards, device_name(dev.index): card})
        print(f"wrote {len(entries)} entries to {_CACHE_FILE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
