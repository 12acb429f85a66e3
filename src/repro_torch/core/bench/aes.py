"""AES-256... no — AES-128 ECB encrypt (MachSuite aes/aes is AES-256; we
use AES-128 for a compact known-answer test, same memory behaviour:
byte-oriented state walks (stride 1) + S-box gathers inside a 256-byte
table).  The paper groups AES with KMP as byte-oriented / high locality.

Validated against the FIPS-197 appendix test vector.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T

_SBOX = np.array([
    0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
    0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
    0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
    0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
    0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
    0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
    0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
    0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
    0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
    0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
    0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
    0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
    0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
    0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
    0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
    0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16,
], dtype=np.uint8)

_RCON = np.array([0x01,0x02,0x04,0x08,0x10,0x20,0x40,0x80,0x1b,0x36], np.uint8)

_SHIFT = np.array([0,5,10,15,4,9,14,3,8,13,2,7,12,1,6,11])  # col-major shiftrows


@dataclasses.dataclass(frozen=True)
class Params:
    n_blocks: int = 48
    seed: int = 13


TINY = Params(n_blocks=2)


def expand_key(key: np.ndarray) -> np.ndarray:
    """AES-128 key schedule -> [11, 16] round keys (column-major words)."""
    w = key.reshape(4, 4).copy()        # 4 words of 4 bytes
    words = [w[i].copy() for i in range(4)]
    for i in range(4, 44):
        t = words[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = _SBOX[t]
            t[0] ^= _RCON[i // 4 - 1]
        words.append(words[i - 4] ^ t)
    return np.concatenate(words).reshape(11, 16)


def _xtime(b: np.ndarray) -> np.ndarray:
    return ((b << 1) ^ np.where(b & 0x80, 0x1B, 0)).astype(np.uint8)


def _mix_columns(s: np.ndarray) -> np.ndarray:
    s = s.reshape(-1, 4, 4)             # [..., col, row]
    a0, a1, a2, a3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    t = a0 ^ a1 ^ a2 ^ a3
    out = np.stack([
        a0 ^ t ^ _xtime(a0 ^ a1),
        a1 ^ t ^ _xtime(a1 ^ a2),
        a2 ^ t ^ _xtime(a2 ^ a3),
        a3 ^ t ^ _xtime(a3 ^ a0),
    ], axis=-1)
    return out.reshape(-1, 16)


def encrypt_np(blocks: np.ndarray, key: np.ndarray) -> np.ndarray:
    """blocks [B,16] uint8 (column-major state), key [16] -> [B,16]."""
    rk = expand_key(key)
    s = blocks ^ rk[0]
    for rnd in range(1, 10):
        s = _SBOX[s]
        s = s[:, _SHIFT]
        s = _mix_columns(s)
        s = s ^ rk[rnd]
    s = _SBOX[s]
    s = s[:, _SHIFT]
    return s ^ rk[10]


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    return {
        "blocks": rng.integers(0, 256, size=(p.n_blocks, 16), dtype=np.uint8),
        "key": rng.integers(0, 256, size=16, dtype=np.uint8),
    }


def run_torch(blocks: torch.Tensor, key: np.ndarray) -> torch.Tensor:
    """:func:`encrypt_np` in PyTorch, vectorized over blocks ([B, 16]
    uint8), on the device of ``blocks``."""
    dev = blocks.device
    rk = torch.from_numpy(expand_key(key)).to(dev)
    sbox = torch.from_numpy(_SBOX).to(dev)
    shift = torch.from_numpy(_SHIFT).to(dev)

    def xtime(b):
        # torch.where with Python ints gives int64: back to uint8 before
        # the next XOR
        return ((b << 1) ^ torch.where((b & 0x80) != 0, 0x1B, 0)
                ).to(torch.uint8)

    def mix(s):
        s4 = s.reshape(-1, 4, 4)
        a = [s4[..., i] for i in range(4)]
        t = a[0] ^ a[1] ^ a[2] ^ a[3]
        cols = [a[i] ^ t ^ xtime(a[i] ^ a[(i + 1) % 4]) for i in range(4)]
        return torch.stack(cols, dim=-1).reshape(-1, 16)

    # the S-box is gathered with long indices: a uint8 index tensor
    # would be a boolean mask
    s = blocks ^ rk[0]
    for rnd in range(1, 10):
        s = sbox[s.long()]
        s = s[:, shift]
        s = mix(s)
        s = s ^ rk[rnd]
    s = sbox[s.long()]
    s = s[:, shift]
    return s ^ rk[10]


def gen_trace(p: Params = Params()) -> T.Trace:
    inputs = make_inputs(p)
    blocks = inputs["blocks"]
    tb = T.TraceBuilder("aes")
    BUF = tb.declare_array("buf", 1)       # state buffer per block
    SBX = tb.declare_array("sbox", 1)
    KEY = tb.declare_array("rkey", 1)
    state_vals = encrypt_np  # only addresses matter; use real sbox indices
    rk = expand_key(inputs["key"])
    for b in range(p.n_blocks):
        s = blocks[b] ^ rk[0]
        last_store: dict[int, int] = {}
        for i in range(16):
            ld = tb.load(BUF, b * 16 + i)
            lk = tb.load(KEY, i)
            x = tb.op(T.LOGIC, ld, lk)
            last_store[i] = tb.store(BUF, b * 16 + i, (x,))
        for rnd in range(1, 11):
            # subbytes: data-dependent gathers into the sbox
            sb = np.empty(16, np.uint8)
            for i in range(16):
                ld = tb.load(BUF, b * 16 + i, (last_store[i],))
                lsb = tb.load(SBX, int(s[i]), (ld,))
                last_store[i] = tb.store(BUF, b * 16 + i, (lsb,))
                sb[i] = _SBOX[s[i]]
            s = sb[_SHIFT]
            if rnd < 10:
                s = _mix_columns(s[None])[0]
                for i in range(16):
                    l0 = tb.load(BUF, b * 16 + i, (last_store[i],))
                    l1 = tb.load(BUF, b * 16 + (i + 4) % 16, (last_store[(i + 4) % 16],))
                    x0 = tb.op(T.LOGIC, l0, l1)
                    x1 = tb.op(T.LOGIC, x0)
                    last_store[i] = tb.store(BUF, b * 16 + i, (x1,))
            for i in range(16):
                ld = tb.load(BUF, b * 16 + i, (last_store[i],))
                lk = tb.load(KEY, rnd * 16 + i)
                x = tb.op(T.LOGIC, ld, lk)
                last_store[i] = tb.store(BUF, b * 16 + i, (x,))
            s = s ^ rk[rnd]
    return tb.build()
