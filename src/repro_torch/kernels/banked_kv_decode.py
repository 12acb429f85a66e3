"""Banked KV-cache flash-decode — the paper's banking idea applied to
the decode-attention hot loop.

The KV cache of one (batch, kv-head) is partitioned into ``n_banks``
sequence banks.  A decode step is a multi-port read burst over those
banks; the online-softmax (flash) recurrence streams them in order, so
each bank is read once per step and no [S] score vector reaches device
memory.  Ragged batches: ``lengths[b]`` masks each row's positions
``>= lengths[b]`` out of both the max and the weight sum, and a row of
length 0 decodes to zeros rather than NaN.

``banked_kv_decode`` launches ``csrc/banked_kv_decode.cu`` on CUDA
tensors and runs ``banked_kv_decode_plain``, the same bank-by-bank
recurrence in PyTorch, on CPU tensors.  The CUDA kernel splits every
bank into runs of ``split_len`` positions, scores each run in its own
CTA (``head_block`` query heads a CTA, K/V staged by bulk copies or
plain loads) into an f32 workspace, and merges the runs of a row in a
second kernel (flash-decoding).  The three come from the autotuner's
table unless given (``autotune.resolve``); its default split is
``autotune.split_len`` (at decode_32k, banks of 4096 positions, four
splits a bank and 32768 CTAs for the step).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, autotune

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def banked_kv_decode_plain(q: torch.Tensor, k_banks: torch.Tensor,
                           v_banks: torch.Tensor, lengths: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version: the f32 recurrence of the Pallas block
    body, bank by bank, over every (batch row, query head) at once."""
    b, hq, d = q.shape
    _, hkv, nb, sb, _ = k_banks.shape
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, d)
    m = torch.full((b, hkv, g), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for j in range(nb):
        k = k_banks[:, :, j].float()                      # [b, hkv, sb, d]
        v = v_banks[:, :, j].float()
        s = torch.matmul(qf, k.transpose(-1, -2)) * scale  # [b, hkv, g, sb]
        pos = j * sb + torch.arange(sb, device=q.device)
        valid = (pos[None, :] < lengths[:, None])[:, None, None, :]
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(valid, p, 0.0)                    # empty-bank exp(0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v)
        m = m_new
    # a row of length 0 leaves l == 0: it decodes to zeros, not NaN
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


@functools.cache
def _launcher() -> tuple:
    lib = _build.load("banked_kv_decode")
    fn = lib.kv_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.kv_decode_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.kv_decode_tile.restype = ctypes.c_int
    # the group and head-dim limits live in the kernel source only
    limits = (lib.kv_decode_max_group(), lib.kv_decode_max_dim())
    return lib, fn, limits


def kernel_split(dim: int, itemsize: int, bank_len: int
                 ) -> "tuple[int, int]":
    """(tile, split): the CUDA kernel's positions a K/V tile for this
    head dim and item size, as the kernel reports them, and the split
    length ``autotune.split_len`` picks from it by default for banks of
    ``bank_len``."""
    tile = _launcher()[0].kv_decode_tile(dim, itemsize)
    return tile, autotune.split_len(bank_len, tile)


def launch_dims(q: torch.Tensor, k_banks: torch.Tensor,
                v_banks: torch.Tensor) -> "dict[str, int]":
    """The autotuner's dims of a launch on the card: the shape, the item
    size, the kernel's ``tile`` for this head dim and ``vec``, whether
    bulk copies are legal (rows a multiple of 16 bytes, K and V 16-byte
    aligned)."""
    b, hq, d = q.shape
    _, hkv, nb, sb, _ = k_banks.shape
    itemsize = q.element_size()
    vec = ((d * itemsize) % 16 == 0 and k_banks.data_ptr() % 16 == 0
           and v_banks.data_ptr() % 16 == 0)
    return dict(b=b, hq=hq, hkv=hkv, s=nb * sb, d=d, nb=nb,
                itemsize=itemsize, tile=kernel_split(d, itemsize, sb)[0],
                vec=int(vec))


def banked_kv_decode(q: torch.Tensor, k_banks: torch.Tensor,
                     v_banks: torch.Tensor, lengths: torch.Tensor, *,
                     head_block: "int | None" = None,
                     split_len: "int | None" = None,
                     bulk: "int | None" = None) -> torch.Tensor:
    """q: [B, Hq, D]; k/v_banks: [B, Hkv, NB, SB, D]; lengths: [B]
    int32.  Returns [B, Hq, D] in q's dtype.  Hq must be a multiple of
    Hkv; query head ``h`` reads kv head ``h // (Hq // Hkv)``.

    A CUDA tensor launches the kernel pair, split and combine
    (``banked_kv_decode.launches`` counts one per call,
    ``banked_kv_decode.config`` holds the last call's configuration)
    with ``head_block`` query heads a split CTA, splits of ``split_len``
    positions and bulk copies when ``bulk`` is 1; each left None comes
    from the autotuner's table, and one the kernel does not take raises.
    A CPU tensor takes the plain version."""
    b, hq, d = q.shape
    _, hkv, nb, sb, _ = k_banks.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if _build.dispatch(q, k_banks, v_banks, lengths) == "cpu":
        return banked_kv_decode_plain(q, k_banks, v_banks, lengths)
    group = hq // hkv
    lib, fn, (max_group, max_dim) = _launcher()
    if group > max_group or d > max_dim:
        raise ValueError(f"the CUDA kernel serves up to {max_group} query "
                         f"heads per kv head and head dim {max_dim}, got "
                         f"{group} and {d}")
    dev = q.device
    dtypes = tuple(_DTYPE_CODE)
    _build.check_tensor("q", q, dev, dtypes, (b, hq, d))
    _build.check_tensor("k_banks", k_banks, dev, (q.dtype,),
                        (b, hkv, nb, sb, d))
    _build.check_tensor("v_banks", v_banks, dev, (q.dtype,),
                        (b, hkv, nb, sb, d))
    _build.check_tensor("lengths", lengths, dev, (torch.int32,), (b,))
    cfg = autotune.resolve("kv_decode", dev,
                           launch_dims(q, k_banks, v_banks),
                           head_block=head_block, split_len=split_len,
                           bulk=bulk)
    split = cfg["split_len"]
    n_splits = nb * (sb // split)
    out = torch.empty_like(q)
    # per (row, query head, split): acc [D] then (m, l), f32
    work = torch.empty(b * hq * n_splits * (d + 2), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), k_banks.data_ptr(), v_banks.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), work.data_ptr(), b,
                  hkv, group, nb, sb, split, d, 1.0 / (d ** 0.5),
                  _DTYPE_CODE[q.dtype], cfg["head_block"], cfg["bulk"],
                  _build.stream_ptr(q))
    _build.check_status(lib, code, "banked_kv_decode")
    banked_kv_decode.launches += 1
    banked_kv_decode.config = cfg
    return out


banked_kv_decode.launches = 0
banked_kv_decode.config = None
