"""AMM XOR-banked gather — the paper's H-NTX-Rd read path.

The logical table (an embedding shard, an expert bank, a KV page table)
is depth-partitioned into ``n_banks`` banks plus one XOR parity bank
(parity[o] = XOR_b bank_b[o]).  Requests are served two at a time (two
read ports): even request slots read the *direct* path, odd slots the
*reconstruction* path — parity XOR all other banks — which is what the
hardware does when both requests of a cycle hit the same bank.  Either
path returns the same word (the H-NTX-Rd invariant).

Words are carried as int32 (f32 table) or int16 (bf16 table) bit
patterns, because XOR is bitwise and torch's unsigned types are limited.
``amm_gather_u32`` launches ``csrc/amm_gather.cu`` on a CUDA tensor and
runs ``amm_gather_u32_plain`` on a CPU tensor.  The kernel serves a pair
of slots (one even, one odd) per warp, ``pairs`` warps a CTA, and is
instantiated per word width (at most ``_word_bytes``); both come from
the autotuner's table unless given (``autotune.resolve``).  Slot parity
is the request's index in the whole call; the JAX block body counts
within its block, which agrees whenever the block size is even or the
call is one block, and gives the same output either way when parity is
consistent.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, autotune

WORD_DTYPES = (torch.int32, torch.int16)


def amm_gather_u32_plain(banks: torch.Tensor, parity: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one vector gather plus ``n_banks`` masked
    XOR sweeps, as the Pallas block body does."""
    nb, rows, _ = banks.shape
    idx = idx.long()
    bank = idx // rows
    off = idx - bank * rows
    direct = banks[bank, off]
    acc = parity[off]
    for j in range(nb):
        acc = torch.where((bank == j)[:, None], acc, acc ^ banks[j, off])
    slot = torch.arange(idx.shape[0], device=idx.device)
    use_recon = (slot % 2) == 1
    return torch.where(use_recon[:, None], acc, direct)


def _word_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """Widest word (16, 8, 4 or 2 bytes) dividing the row pitch and
    every base address."""
    for w in (16, 8, 4, 2):
        if row_bytes % w == 0 and all(t.data_ptr() % w == 0
                                      for t in tensors):
            return w
    raise ValueError("rows must be 2-byte aligned")


@functools.cache
def _launcher() -> tuple:
    lib = _build.load("amm_gather")
    fn = lib.amm_gather_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + \
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch_dims(banks: torch.Tensor, parity: torch.Tensor,
                idx: torch.Tensor, out: "torch.Tensor | None" = None
                ) -> "dict[str, int]":
    """The autotuner's dims of a launch: the table's shape ``v`` x ``d``
    words of ``itemsize`` bytes in ``nb`` banks, ``n`` ids, and ``word``,
    the widest word the row pitch and the bases allow (``out``, when
    given, is one of them)."""
    nb, rows, d = banks.shape
    row_bytes = d * banks.element_size()
    bases = (banks, parity) if out is None else (banks, parity, out)
    return dict(v=nb * rows, d=d, nb=nb, n=idx.shape[0],
                itemsize=banks.element_size(),
                word=_word_bytes(row_bytes, *bases))


def amm_gather_u32(banks: torch.Tensor, parity: torch.Tensor,
                   idx: torch.Tensor, *, pairs: "int | None" = None,
                   word_bytes: "int | None" = None) -> torch.Tensor:
    """banks: [NB, R, D] int32/int16 words; parity: [R, D]; idx: [N]
    int32 with ``0 <= idx < NB * R`` (not checked, as in the Pallas
    kernel).  Returns [N, D] gathered words.

    A CUDA tensor launches the kernel (``amm_gather_u32.launches`` counts
    the launches, ``amm_gather_u32.config`` holds the last launch's
    configuration) with ``pairs`` warps a CTA and words of ``word_bytes``;
    each left None comes from the autotuner's table, and one the kernel
    does not take raises.  A CPU tensor takes the plain version."""
    if _build.dispatch(banks, parity, idx) == "cpu":
        return amm_gather_u32_plain(banks, parity, idx)
    nb, rows, d = banks.shape
    n = idx.shape[0]
    dev = banks.device
    _build.check_tensor("banks", banks, dev, WORD_DTYPES, (nb, rows, d))
    _build.check_tensor("parity", parity, dev, (banks.dtype,), (rows, d))
    _build.check_tensor("idx", idx, dev, (torch.int32,), (n,))
    out = torch.empty((n, d), dtype=banks.dtype, device=dev)
    cfg = autotune.resolve("amm_gather", dev,
                           launch_dims(banks, parity, idx, out),
                           pairs=pairs, word_bytes=word_bytes)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        code = fn(banks.data_ptr(), parity.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), n, nb, rows, d * banks.element_size(),
                  cfg["word_bytes"], cfg["pairs"], _build.stream_ptr(banks))
    _build.check_status(lib, code, "amm_gather")
    amm_gather_u32.launches += 1
    amm_gather_u32.config = cfg
    return out


amm_gather_u32.launches = 0
amm_gather_u32.config = None
