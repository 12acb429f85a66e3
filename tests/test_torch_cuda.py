"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and skips without one (decided in
the ``cuda`` fixture, never at import).  The file imports torch and the
port only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: the gather is bit-exact (XOR of bit patterns); kv_decode
sums in another order than the plain version, so f32 is held to 1e-5.
In bf16 both sum in f32 and round the output once, so they may differ by
one bf16 step of the output (at most 2**-7 of it) plus the f32 order
difference: atol 1e-4, rtol 2**-7.  The JAX suite's 4e-2 is looser than
most outputs at S 1024 and would not tell a broken kernel.  The SSD
chunk sums in f32 in another order than the plain version: atol 1e-4
(the reference's SSD tolerance) + rtol 1e-5; with bf16 x both round y
once to bf16, so y may differ by one bf16 step (rtol 2**-7).  The
batched timing backend (``cycle_lanes``) is integer: the kernel equals
its plain version exactly (results, remap maps, event logs).  Every
launch configuration the autotuner sweeps is held to the same gates
(``autotune.holds``).
"""
import importlib
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import (amm_gather, kv_decode, pack_amm_banks,
                                 ssd_chunk)
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.amm_gather import (amm_gather_u32,
                                            amm_gather_u32_plain)
from repro_torch.kernels.banked_kv_decode import (banked_kv_decode,
                                                  banked_kv_decode_plain,
                                                  kernel_split)
from repro_torch.kernels.ssd_scan import ssd_chunk_step, ssd_chunk_step_plain
from repro_torch.core.amm import replay as rp
from repro_torch.core.amm.spec import AMMSpec
from repro_torch.core.fault import (build_masks, sample_faults,
                                    tile_states)
from repro_torch.kernels.ref import amm_gather_replay_ref

# the module, not the ``amm_gather`` function that ``repro_torch.kernels``
# exports under the same name
gather_mod = importlib.import_module("repro_torch.kernels.amm_gather")
kv_mod = importlib.import_module("repro_torch.kernels.banked_kv_decode")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("word", [torch.int32, torch.int16])
@pytest.mark.parametrize("nb,rows,d,n", [
    (1, 64, 8, 32), (2, 32, 13, 7), (3, 32, 64, 97), (5, 50, 8, 1),
    (8, 128, 2048, 256), (4, 16, 3, 64),
])
def test_amm_gather_u32_inconsistent_parity(cuda, word, nb, rows, d, n):
    """A parity plane that is not the XOR of the banks separates the
    direct and reconstruction paths: the kernel must take each slot's
    path exactly as the plain version does."""
    g = _gen(nb * 1000 + d)
    lo, hi = (-2**31, 2**31 - 1) if word == torch.int32 else (-2**15, 2**15)
    banks = torch.randint(lo, hi, (nb, rows, d), generator=g, device=cuda,
                          dtype=word)
    parity = torch.randint(lo, hi, (rows, d), generator=g, device=cuda,
                           dtype=word)
    idx = torch.randint(0, nb * rows, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    got = amm_gather_u32(banks, parity, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, amm_gather_u32_plain(banks, parity, idx))


def test_amm_gather_u32_unaligned_base(cuda):
    """Base addresses 2 bytes past a 16-byte boundary force the 2-byte
    word path."""
    g = _gen(3)
    nb, rows, d, n = 4, 32, 16, 50
    flat = torch.randint(-2**15, 2**15, (nb * rows * d + 1,), generator=g,
                         device=cuda, dtype=torch.int16)
    banks = flat[1:].view(nb, rows, d)
    pflat = torch.randint(-2**15, 2**15, (rows * d + 1,), generator=g,
                          device=cuda, dtype=torch.int16)
    parity = pflat[1:].view(rows, d)
    idx = torch.randint(0, nb * rows, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    assert torch.equal(amm_gather_u32(banks, parity, idx),
                       amm_gather_u32_plain(banks, parity, idx))


def _offset_view(flat: torch.Tensor, shape, offset: int) -> torch.Tensor:
    """A contiguous view of ``shape`` starting ``offset`` elements into
    ``flat``, to move its base off a 16-byte boundary."""
    return flat[offset:offset + math.prod(shape)].view(shape)


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("n", [1, 2, 37, 64])
@pytest.mark.parametrize("word,d,offset,word_bytes", [
    (torch.int32, 8, 0, 16),        # 32-byte rows: 16-byte words
    (torch.int32, 6, 0, 8),         # 24-byte rows: 8-byte words
    (torch.int32, 3, 0, 4),         # 12-byte rows: 4-byte words
    (torch.int16, 5, 0, 2),         # 10-byte rows: 2-byte words
    (torch.int32, 8, 1, 4),         # 4 bytes past a 16-byte boundary
])
def test_amm_gather_every_instantiation(cuda, nb, n, word, d, offset,
                                        word_bytes):
    """Every word-width instantiation, bank counts that fill the bank
    loop's batches of 4 or leave one partial, odd and even request counts,
    on a parity plane that is not the XOR of its banks: bit-equal to the
    plain version."""
    g = _gen(nb * 100 + n + d)
    lo, hi = (-2**31, 2**31 - 1) if word == torch.int32 else (-2**15, 2**15)
    rows = 19

    def rand(shape):
        flat = torch.randint(lo, hi, (offset + math.prod(shape),),
                             generator=g, device=cuda, dtype=word)
        return _offset_view(flat, shape, offset)

    banks = rand((nb, rows, d))
    parity = rand((rows, d))
    idx = torch.randint(0, nb * rows, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    out = torch.empty((n, d), dtype=word, device=cuda)
    assert gather_mod._word_bytes(d * banks.element_size(), banks, parity,
                                  out) == word_bytes
    before = amm_gather_u32.launches
    got = amm_gather_u32(banks, parity, idx)
    torch.cuda.synchronize()
    assert amm_gather_u32.launches == before + 1
    assert torch.equal(got, amm_gather_u32_plain(banks, parity, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_amm_gather_table_matches_take(cuda, dtype):
    g = _gen(4)
    table = torch.randn((250, 24), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, 250, (63,), generator=g, device=cuda)
    before = amm_gather_u32.launches
    got = amm_gather(table, idx, n_banks=5)
    assert amm_gather_u32.launches == before + 1
    word = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(word), table[idx].view(word))


def _kv_lengths(mode, g, cuda, b, s, nb, d, itemsize):
    """Row lengths for a kv_decode case.  ``random``: uniform in [1, S]
    with row 0 full; ``boundaries``: one below, at and one above the
    kernel's split length and the bank length, and the whole cache;
    ``short``: a row shorter than one split and a row of length 1;
    ``empty``: every row empty.  The last three set their own batch."""
    sb = s // nb
    _, split = kernel_split(d, itemsize, sb)
    if mode == "random":
        lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda,
                             dtype=torch.int32)
        lens[0] = s
        return lens
    rows = {"boundaries": [split - 1, split, split + 1, sb - 1, sb, sb + 1,
                           s],
            "short": [max(1, split // 2), 1, max(1, split - 1)],
            "empty": [0, 0]}[mode]
    return torch.tensor(rows, dtype=torch.int32, device=cuda).clamp(0, s)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 1e-4, 2**-7)])
@pytest.mark.parametrize("b,hq,hkv,s,d,nb", [
    (2, 4, 2, 64, 16, 4), (1, 8, 8, 128, 32, 8), (3, 6, 2, 96, 8, 3),
    (4, 8, 4, 64, 16, 1), (2, 16, 1, 300, 128, 3), (2, 4, 2, 40, 12, 5),
    (2, 2, 1, 512, 256, 2), (3, 16, 8, 1024, 128, 8),
    (2, 8, 1, 4096, 64, 2),          # group 8: two head blocks
    (2, 16, 1, 2048, 256, 1),        # group 16, D 256: 2 splits a bank
    (2, 12, 4, 3000, 12, 3),         # group 3; bf16 rows of 24 bytes
    (2, 16, 8, 8192, 128, 2),        # decode_32k's heads: 4 splits a bank
    (2, 4, 2, 32768, 128, 8),        # 32 splits combined per row
])
@pytest.mark.parametrize("lengths", ["random", "boundaries", "short",
                                     "empty"])
def test_kv_decode_kernel_matches_plain(cuda, dtype, atol, rtol, b, hq, hkv,
                                        s, d, nb, lengths):
    g = _gen(b * 100 + s + d)
    lens = _kv_lengths(lengths, g, cuda, b, s, nb, d,
                       torch.tensor([], dtype=dtype).element_size())
    b = lens.numel()
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=g, device=cuda).to(dtype)
    before = banked_kv_decode.launches
    got = kv_decode(q, k, v, lens, n_banks=nb)
    torch.cuda.synchronize()
    assert banked_kv_decode.launches == before + 1
    sb = s // nb
    want = banked_kv_decode_plain(q, k.reshape(b, hkv, nb, sb, d),
                                  v.reshape(b, hkv, nb, sb, d), lens)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert torch.all(got[i] == 0), "an empty row must decode to 0"


@pytest.mark.parametrize("b,hq,hkv,s,d,nb,lens", [
    (4, 4, 2, 64, 16, 4, [0, 5, 33, 64]),
    # banks of 8192, 8 splits of 1024 each: the poison starts mid-split,
    # at a split boundary and at a bank boundary
    (4, 4, 2, 16384, 128, 2, [0, 1500, 3072, 8192]),
])
def test_kv_decode_ragged_empty_rows_and_poison(cuda, b, hq, hkv, s, d, nb,
                                                lens):
    g = _gen(11)
    q = torch.randn((b, hq, d), generator=g, device=cuda)
    k = torch.randn((b, hkv, s, d), generator=g, device=cuda)
    v = torch.randn((b, hkv, s, d), generator=g, device=cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = kv_decode(q, k, v, lens, n_banks=nb)
    want = banked_kv_decode_plain(q, k.reshape(b, hkv, nb, s // nb, d),
                                  v.reshape(b, hkv, nb, s // nb, d), lens)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert torch.all(got[0] == 0)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        kp[i, :, n:] = 1e4
        vp[i, :, n:] = -1e4
    got2 = kv_decode(q, kp, vp, lens, n_banks=nb)
    assert (got2 - got).abs().max().item() <= 1e-6


def test_kv_decode_tile_matches_kernel(cuda):
    """The tiles the CPU tests of ``_split_len`` assume
    (tests/test_torch_kernels.py, KV_TILES) are the kernel's own."""
    tiles = {(128, 2): 32, (128, 4): 32, (256, 2): 16, (64, 2): 64,
             (32, 2): 128, (16, 4): 256, (12, 4): 256, (8, 2): 512,
             (8, 4): 512}
    for (d, itemsize), tile in tiles.items():
        assert kernel_split(d, itemsize, 4096)[0] == tile


def test_kv_decode_rejects_wide_group(cuda):
    q = torch.zeros((1, 32, 16), device=cuda)
    kb = torch.zeros((1, 1, 1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="query heads per kv head"):
        banked_kv_decode(q, kb, kb, torch.ones(1, dtype=torch.int32,
                                               device=cuda))


def test_pack_amm_banks_parity_on_card(cuda):
    g = _gen(5)
    table = torch.randn((96, 8), generator=g, device=cuda)
    banks, parity = pack_amm_banks(table, 3)
    assert torch.equal(parity, banks[0] ^ banks[1] ^ banks[2])


def _ssd_inputs(g, cuda, bt, h, q, p, n):
    """dt in [1e-3, 1e-1], A = -linspace(1, 16, h) as the model's A_log
    gives it, cum = cumsum(dt A); normal x, B, C and h_in."""
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((bt, h, q), generator=g,
                                            device=cuda)
    A = -torch.linspace(1.0, 16.0, h, device=cuda)
    cum = torch.cumsum(dt * A[None, :, None], dim=-1)
    x = torch.randn((bt, h, q, p), generator=g, device=cuda)
    B = torch.randn((bt, q, n), generator=g, device=cuda)
    C = torch.randn((bt, q, n), generator=g, device=cuda)
    h_in = torch.randn((bt, h, p, n), generator=g, device=cuda)
    return x, dt, cum, B, C, h_in


@pytest.mark.parametrize("bt,h,q,p,n", [
    (1, 2, 8, 4, 4), (2, 4, 16, 8, 8), (2, 3, 12, 8, 6), (2, 3, 12, 4, 6),
    (1, 2, 64, 16, 32), (2, 5, 100, 70, 130), (1, 3, 65, 64, 33),
    (8, 24, 256, 64, 128),          # mamba2-130m's chunk, as on the path
    (2, 3, 40, 24, 20),             # Q, P, N not multiples of the mma tile
    (1, 24, 256, 64, 128),          # Bt 1 at the path's chunk
    (2, 2, 200, 128, 64),           # two head-dim tiles, a ragged row tile
])
@pytest.mark.parametrize("aligned", [True, False])
def test_ssd_chunk_kernel_matches_plain(cuda, bt, h, q, p, n, aligned):
    """``aligned`` False moves x's base 4 bytes off a 16-byte boundary,
    which sends every tile through the 4-byte copies."""
    g = _gen(bt * 1000 + q + n)
    ins = _ssd_inputs(g, cuda, bt, h, q, p, n)
    if not aligned:
        flat = torch.empty(ins[0].numel() + 1, device=cuda)
        x = _offset_view(flat, ins[0].shape, 1)
        x.copy_(ins[0])
        ins = (x,) + ins[1:]
    assert ssd_mod._vec_copies(p, n, *ins) == (aligned and p % 4 == 0
                                               and n % 4 == 0)
    before = ssd_chunk_step.launches
    y, h_out = ssd_chunk(*ins)
    torch.cuda.synchronize()
    assert ssd_chunk_step.launches == before + 1
    want_y, want_h = ssd_chunk_step_plain(*ins)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(h_out, want_h, atol=1e-4, rtol=1e-5)


def test_ssd_chunk_kernel_rounds_y_through_bf16_x(cuda):
    g = _gen(77)
    x, dt, cum, B, C, h_in = _ssd_inputs(g, cuda, 2, 3, 12, 8, 6)
    xb = x.to(torch.bfloat16)
    y, h_out = ssd_chunk_step(xb, dt, cum, B, C, h_in)
    want_y, want_h = ssd_chunk_step_plain(xb, dt, cum, B, C, h_in)
    assert y.dtype == h_out.dtype == torch.float32
    assert torch.equal(y, y.to(torch.bfloat16).float())
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=2.0 ** -7)
    torch.testing.assert_close(h_out, want_h, atol=1e-4, rtol=1e-5)


def test_ssd_chunk_kernel_deep_decay(cuda):
    """dt 0.1 and A -16 at every position: cum falls to about -410 within
    the chunk, where exp(-cum_j) alone would overflow; the outputs stay
    finite and within the same tolerance."""
    g = _gen(91)
    bt, h, q, p, n = 2, 4, 256, 64, 128
    x, _, _, B, C, h_in = _ssd_inputs(g, cuda, bt, h, q, p, n)
    dt = torch.full((bt, h, q), 0.1, device=cuda)
    cum = torch.cumsum(dt * -16.0, dim=-1)
    assert cum.min().item() < -400
    y, h_out = ssd_chunk(x, dt, cum, B, C, h_in)
    want_y, want_h = ssd_chunk_step_plain(x, dt, cum, B, C, h_in)
    assert bool(torch.isfinite(y).all() and torch.isfinite(h_out).all())
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(h_out, want_h, atol=1e-4, rtol=1e-5)


def test_ssd_chunk_kernel_keeps_bits_below_tf32(cuda):
    """At the path's chunk, the operands rounded to TF32 (one tensor-core
    product each, as plain TF32 would take them) move the plain version
    out of the gate; the kernel's split products stay inside it."""
    g = _gen(93)
    ins = _ssd_inputs(g, cuda, 8, 24, 256, 64, 128)

    def tf32(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    want_y, want_h = ssd_chunk_step_plain(*ins)
    x, dt, cum, B, C, h_in = ins
    coarse_y, _ = ssd_chunk_step_plain(tf32(x), dt, cum, tf32(B), tf32(C),
                                       tf32(h_in))
    assert not torch.allclose(coarse_y, want_y, atol=1e-4, rtol=1e-5)
    y, h_out = ssd_chunk(*ins)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(h_out, want_h, atol=1e-4, rtol=1e-5)


def test_ssd_tile_matches_kernel(cuda):
    """The tile the CPU tests of ``workspace_shape`` and ``tile_counts``
    assume (tests/test_torch_ssm.py, SSD_TILE) is the kernel's own."""
    assert ssd_mod.kernel_tile() == 64


@pytest.mark.parametrize("bt,h,q,p,n", [
    (8, 24, 256, 64, 128),          # mamba2-130m's chunk
    (8, 80, 256, 64, 64),           # zamba2-2.7b's chunk
    (2, 3, 12, 8, 6)])
def test_ssd_chunk_grads_on_card_match_plain(cuda, bt, h, q, p, n):
    """Through ``ssd_chunk`` (``SSDChunk``: the kernel's forward, the
    plain version's backward) the gradients of all six inputs equal the
    plain version's autograd on the same inputs; the backward launches
    no kernel.  Both backwards run the same plain arithmetic on the same
    inputs: 1e-5 of each gradient's scale covers the device's sum
    order."""
    g = _gen(bt * 7 + h + n)
    ins = [t.requires_grad_() for t in _ssd_inputs(g, cuda, bt, h, q, p, n)]
    wy = torch.randn((bt, h, q, p), generator=g, device=cuda)
    wh = torch.randn((bt, h, p, n), generator=g, device=cuda)
    before = ssd_chunk_step.launches
    y, h_out = ssd_chunk(*ins)
    assert type(y.grad_fn).__name__ == "SSDChunkBackward"
    got = torch.autograd.grad((y * wy).sum() + (h_out * wh).sum(), ins)
    torch.cuda.synchronize()
    assert ssd_chunk_step.launches == before + 1
    yp, hp = ssd_chunk_step_plain(*ins)
    want = torch.autograd.grad((yp * wy).sum() + (hp * wh).sum(), ins)
    for name, a, b in zip(("x", "dt", "cum", "B", "C", "h_in"), got, want):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item(),
                                   msg=name)


def test_mamba2_train_step_grads_on_card_match_cpu(cuda):
    """A tiny mamba2's gradients under an f32 policy on the card (the
    kernel's forward) against the CPU (the plain version): every leaf
    finite, nonzero and within 1e-4 relative L2 (the chunk gate's 1e-4
    over two layers)."""
    from repro_torch.configs import get_arch, tiny_variant
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import DTypePolicy, init_model
    from repro_torch.models.common import tree_map
    arch = tiny_variant(get_arch("mamba2-130m"))
    f32 = DTypePolicy(torch.float32, torch.float32, torch.float32)
    params = init_model(0, arch, f32, device=cuda)
    toks = torch.randint(0, arch.vocab, (2, 40), generator=_gen(3),
                         device=cuda, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    before = ssd_chunk_step.launches
    loss, _, grads = loss_and_grads(params, arch, batch,
                                    RuntimeConfig(remat="none"), f32)
    assert ssd_chunk_step.launches == before + arch.n_layers * 3
    closs, _, cgrads = loss_and_grads(
        tree_map(lambda t: t.cpu(), params), arch,
        {k: v.cpu() for k, v in batch.items()}, RuntimeConfig(remat="none"),
        f32)
    torch.testing.assert_close(loss.cpu(), closs, rtol=1e-5, atol=0)

    def walk(a, b, path=""):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}{k}/")
                continue
            got, want = a[k].cpu(), b[k]
            assert bool(torch.isfinite(got).all()), path + k
            assert float(got.abs().max()) > 0, path + k
            rel = float((got - want).norm() / want.norm())
            assert rel <= 1e-4, (path + k, rel)

    walk(grads, cgrads)


def test_no_backward_guards_on_card(cuda):
    """The gather and the decode have no backward: an input that
    requires grad raises under grad mode, and under no_grad they run as
    before."""
    g = _gen(12)
    table = torch.randn((96, 8), generator=g, device=cuda,
                        requires_grad=True)
    idx = torch.randint(0, 96, (40,), generator=g, device=cuda,
                        dtype=torch.int32)
    with pytest.raises(RuntimeError, match="amm_gather has no backward"):
        amm_gather(table, idx, n_banks=3)
    with torch.no_grad():
        assert torch.equal(amm_gather(table, idx, n_banks=3),
                           table[idx.long()])
    q = torch.randn((2, 4, 16), generator=g, device=cuda,
                    requires_grad=True)
    k = torch.randn((2, 2, 64, 16), generator=g, device=cuda)
    v = torch.randn((2, 2, 64, 16), generator=g, device=cuda)
    lengths = torch.tensor([10, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="kv_decode has no backward"):
        kv_decode(q, k, v, lengths, n_banks=4)
    with torch.no_grad():
        got = kv_decode(q, k, v, lengths, n_banks=4)
        want = banked_kv_decode_plain(q, k.reshape(2, 2, 4, 16, 16),
                                      v.reshape(2, 2, 4, 16, 16), lengths)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------- replay and faults
# every design kind, a sub-banked geometry among them
REPLAY_SPECS = [
    AMMSpec("ideal", 2, 2, 64), AMMSpec("banked", 4, 4, 64, n_banks=2),
    AMMSpec("multipump", 2, 2, 64), AMMSpec("h_ntx_rd", 4, 1, 64),
    AMMSpec("b_ntx_wr", 1, 2, 64), AMMSpec("hb_ntx", 4, 2, 64),
    AMMSpec("hb_ntx", 4, 2, 64, n_banks=4), AMMSpec("lvt", 4, 2, 64),
    AMMSpec("remap", 4, 2, 64),
]


def _campaign_inputs(spec, n_faults=16, n_cycles=64):
    ops = rp.make_trace(spec, n_cycles, seed=3)
    vals = np.random.default_rng(4).integers(0, 2**32, spec.depth,
                                             dtype=np.uint32)
    return ops, vals, sample_faults(spec, n_faults, 5, n_cycles)


@pytest.mark.parametrize("spec", REPLAY_SPECS, ids=lambda s: s.describe())
def test_replay_faulty_batched_cuda_matches_cpu(cuda, spec):
    ops, vals, faults = _campaign_inputs(spec)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = rp.replay_faulty_batched(
            spec, tile_states(spec, vals, len(faults), dev),
            build_masks(spec, faults, dev), *ops, device=dev)
    (st_c, res_c), (st_g, res_g) = out["cpu"], out["cuda"]
    assert res_g.read_vals.is_cuda
    for got, want in zip(res_g, res_c):
        assert (got is None) == (want is None)
        if want is not None:
            assert torch.equal(got.cpu(), want)
    assert set(st_g) == set(st_c)
    for k in st_c:
        assert torch.equal(st_g[k].cpu(), st_c[k]), k


@pytest.mark.parametrize("spec", REPLAY_SPECS, ids=lambda s: s.describe())
def test_replay_loop_reads_nothing_back(cuda, spec):
    """With every input already on the card, a fault-injected replay runs
    under CUDA's sync debug mode set to error: nothing in the cycle loop
    waits for the device."""
    ops, vals, faults = _campaign_inputs(spec, 4, 16)
    states = tile_states(spec, vals, len(faults), cuda)
    masks = build_masks(spec, faults, cuda)
    ra, wa, wv, wm = ops
    trace = (torch.from_numpy(ra).to(cuda), torch.from_numpy(wa).to(cuda),
             rp.words(wv, cuda), torch.from_numpy(wm).to(cuda))
    want = rp.replay_faulty_batched(spec, states, masks, *trace,
                                    device=cuda)   # builds the index tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rp.replay_faulty_batched(spec, states, masks, *trace,
                                       device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[1].read_vals, want[1].read_vals)


@pytest.mark.parametrize("spec", REPLAY_SPECS, ids=lambda s: s.describe())
def test_tile_states_lanes_do_not_share_storage(cuda, spec):
    """Every lane of a campaign's batch is its own memory: a write into
    one lane changes no other (lanes of an ``expand`` would all change)."""
    vals = np.arange(spec.depth, dtype=np.uint32)
    states = tile_states(spec, vals, 3, cuda)
    for k, v in states.items():
        assert v.stride(0) == v[0].numel(), k
        ptrs = {v[i].data_ptr() for i in range(3)}
        assert len(ptrs) == 3, k
        v[1].fill_(-1)
        assert torch.equal(v[0], v[2]), k
        assert not torch.equal(v[0], v[1]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 63, 64])
def test_amm_gather_replay_ref_matches_kernel(cuda, dtype, n):
    """The replay-backed oracle on the card, bit-equal to the CUDA gather
    and to ``table[idx]``."""
    g = _gen(11)
    table = torch.randn((250, 24), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, 250, (n,), generator=g, device=cuda)
    got = amm_gather_replay_ref(table, idx)
    word = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.is_cuda
    assert torch.equal(got.view(word), amm_gather(table, idx, n_banks=5
                                                  ).view(word))
    assert torch.equal(got.view(word), table[idx].view(word))


# ---- the batched timing backend (cycle_lanes) --------------------------
# Exact: the schedule is integer, so the kernel and the plain version
# must agree bit for bit (results, final remap maps, event logs).
_SCHED_BENCHES = ("fft_strided", "gemm_ncubed", "kmp", "md_knn",
                  "sort_merge", "stencil2d", "aes", "spmv_crs", "bfs_queue",
                  "nw", "viterbi", "radix_sort", "kv_decode", "paged_kv",
                  "moe_route")
_PLAIN_SCHEDULES: dict = {}


def _plain_schedule(bench):
    """The plain version's results, maps and events for a benchmark's
    golden rows (computed once a session: it is the slow side)."""
    from _torch_sched_util import golden_configs
    from repro_torch.core.sim.batched_cycle import schedule_batched

    if bench not in _PLAIN_SCHEDULES:
        pt, rows, cfgs = golden_configs(bench)
        _PLAIN_SCHEDULES[bench] = schedule_batched(
            pt, cfgs, device="cpu", return_maps=True, collect_events=True)
    return _PLAIN_SCHEDULES[bench]


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("bench", _SCHED_BENCHES)
def test_cycle_lanes_matches_plain_on_golden_rows(cuda, bench, record):
    from _torch_sched_util import check_row, golden_configs
    from repro_torch.core.sim.batched_cycle import schedule_batched
    from repro_torch.kernels.cycle_lanes import cycle_lanes

    pt, rows, cfgs = golden_configs(bench)
    launches = cycle_lanes.launches
    got = schedule_batched(pt, cfgs, device=cuda, return_maps=True,
                           collect_events=record)
    torch.cuda.synchronize()
    assert cycle_lanes.launches == launches + 1     # one launch a call
    want = _plain_schedule(bench)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    if record:
        assert got[2] == want[2]
    for g, res in zip(rows, got[0]):
        check_row(res, g)


def test_cycle_lanes_lanes_of_different_lengths_and_a_batch_of_one(cuda):
    from repro_torch.core.amm.spec import AMMSpec
    from repro_torch.core.sim import ScheduleConfig, TraceBuilder
    from repro_torch.core.sim.batched_cycle import schedule_batched

    tb = TraceBuilder("chain")
    aids = [tb.declare_array(f"a{k}", 4) for k in range(2)]
    prev = ()
    for i in range(300):
        prev = (tb.load(aids[i % 2], i % 16, prev),)
    tr = tb.build()
    cfgs = [ScheduleConfig(mem={0: AMMSpec("ideal", 4, 4, 64),
                                1: AMMSpec(k, 2, 2, 64)}, fu_counts={},
                           mem_latency=lat)
            for k, lat in (("ideal", 1), ("banked", 9), ("remap", 3),
                           ("hb_ntx", 2), ("lvt", 5))]
    got, maps, logs = schedule_batched(tr, cfgs, device=cuda,
                                       return_maps=True, collect_events=True)
    want = schedule_batched(tr, cfgs, device="cpu", return_maps=True,
                            collect_events=True)
    assert len({r.cycles for r in got}) == len(cfgs)
    assert got == want[0] and logs == want[2]
    np.testing.assert_array_equal(maps, want[1])
    for cfg, res in zip(cfgs, got):
        assert schedule_batched(tr, [cfg], device=cuda) == [res]


def test_cycle_lanes_error_codes(cuda):
    from repro_torch.core.amm.spec import AMMSpec
    from repro_torch.core.sim import ScheduleConfig, Trace, TraceBuilder
    from repro_torch.core.sim.batched_cycle import schedule_batched
    from repro_torch.core.sim.trace import IADD

    tb = TraceBuilder("nospec")
    a = tb.declare_array("a", 4)
    b = tb.declare_array("b", 4)
    tb.load(a, 0)
    tb.load(b, 0)
    cfg = ScheduleConfig(mem={a: AMMSpec("ideal", 2, 2, 64)}, fu_counts={})
    with pytest.raises(KeyError):
        schedule_batched(tb.build(), [cfg], device=cuda)
    tb = TraceBuilder("chain")
    a = tb.declare_array("a", 4)
    prev = ()
    for i in range(64):
        prev = (tb.load(a, i % 16, prev),)
    cfg = ScheduleConfig(mem={a: AMMSpec("ideal", 1, 1, 64)}, fu_counts={},
                         max_cycles=5)
    with pytest.raises(RuntimeError, match="exceeded 5 cycles"):
        schedule_batched(tb.build(), [cfg], device=cuda)
    tr = Trace(kinds=np.array([IADD, IADD, 0], np.int8),
               array_ids=np.array([-1, -1, 0], np.int16),
               addrs=np.array([-1, -1, 0], np.int64),
               pred_ptr=np.array([0, 1, 2, 2], np.int64),
               pred_idx=np.array([1, 0], np.int64),
               array_names={0: "a"}, word_bytes={0: 4}, name="cycle")
    cfg = ScheduleConfig(mem={0: AMMSpec("ideal", 2, 2, 64)}, fu_counts={})
    with pytest.raises(RuntimeError, match="deadlock"):
        schedule_batched(tr, [cfg], device=cuda)


def _lane_call(pt, cfgs, device, **kw):
    """``cycle_lanes`` on ``_lane_inputs``' tensors on ``device``: the
    raw outputs (cycles, cnt, per_array, err, maps[, events][, prof])."""
    from repro_torch.core.sim.batched_cycle import _lane_inputs, lane_outputs

    sc, ins = _lane_inputs(pt, cfgs)
    return lane_outputs(pt, sc, ins, device, **kw)


def _same_raw(got, want):
    """Every output equal, those of lanes that end in an error included
    (such a lane stops where it failed, as the JAX lane freezes)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), (i, g, w)


@pytest.mark.parametrize("mem_latency", [0, 7])
@pytest.mark.parametrize("bench", ["kmp", "spmv_crs", "viterbi"])
def test_cycle_lanes_matches_plain_at_other_load_latencies(cuda, bench,
                                                           mem_latency):
    """Raw outputs, error codes and event logs included: at
    ``mem_latency`` 0 a load retires the cycle after it issues, and the
    lanes of kmp and viterbi end in the JAX rules' deadlock (ROADMAP.md,
    section C), which the kernel keeps."""
    import dataclasses

    from _torch_sched_util import golden_configs

    pt, _, cfgs = golden_configs(bench)
    cfgs = [dataclasses.replace(c, mem_latency=mem_latency)
            for c in cfgs[::2]]
    got = _lane_call(pt, cfgs, cuda, record=True)
    torch.cuda.synchronize()
    _same_raw(got, _lane_call(pt, cfgs, "cpu", record=True))


def _odd_trace(n_loads: int, fan_in: int):
    """``n_loads`` loads over two arrays in short chains, FADDs joining
    pairs, and one FADD fed by ``fan_in`` of the loads (the trace's node
    of largest in-degree), then a store: ``n_real`` is not a multiple
    of 32."""
    from repro_torch.core.sim import TraceBuilder
    from repro_torch.core.sim.trace import FADD, FDIV

    tb = TraceBuilder("odd")
    a, b = tb.declare_array("a", 4), tb.declare_array("b", 8)
    loads, prev = [], ()
    for i in range(n_loads):
        x = tb.load(a if i % 3 else b, (7 * i) % 61, prev)
        loads.append(x)
        prev = (x,) if i % 5 else ()
    joins = [tb.op(FADD, loads[i], loads[i + 1])
             for i in range(0, n_loads - 1, 2)]
    hub = tb.op(FADD, *loads[:fan_in])
    tb.store(a, 3, (tb.op(FDIV, hub, joins[-1]),))
    return tb.build()


@pytest.mark.parametrize("fan_in", [2, 300])
def test_cycle_lanes_odd_sizes_and_the_widest_node(cuda, fan_in):
    from repro_torch.core.amm.spec import AMMSpec
    from repro_torch.core.sim import ScheduleConfig, prepare_trace
    from repro_torch.core.sim.batched_cycle import _lane_inputs

    pt = prepare_trace(_odd_trace(333, fan_in))
    assert pt.device_views().n_real % 32 != 0
    assert int(pt.indegree.max()) == fan_in
    cfgs = [ScheduleConfig(mem={0: AMMSpec(k, 4, 2, 64, n_banks=nb),
                                1: AMMSpec("ideal", 2, 2, 64)},
                           fu_counts={"fadd": 2}, mem_latency=lat)
            for k, nb, lat in (("banked", 4, 2), ("hb_ntx", 1, 3),
                               ("remap", 1, 1), ("lvt", 1, 0),
                               ("ideal", 1, 5))]
    sc, _ = _lane_inputs(pt, cfgs)
    assert sc.pend_bits == (16 if fan_in > 255 else 8)
    got = _lane_call(pt, cfgs, cuda, record=True)
    torch.cuda.synchronize()
    _same_raw(got, _lane_call(pt, cfgs, "cpu", record=True))


_WIDE: dict = {}


def _wide_case(name):
    """A trace whose cycles pop more than one round (32 candidates) of
    the kernel's deferral scan, the wide lanes over it and the plain
    version's raw outputs, event logs included (computed once a
    session)."""
    from _torch_sched_util import hub_trace, many_arrays_trace, wide_configs
    from repro_torch.core.sim import prepare_trace

    if name not in _WIDE:
        if name == "hub":          # 1024 loads of one array ready at once
            pt = prepare_trace(hub_trace(1024))
            cfgs = wide_configs(pt)
        else:
            # 20 arrays, more than the CTA's 16 warps, so a warp scans
            # two of them (without hb_ntx b4, whose 1024 scan slots an
            # array would take 20 x 12 KB of shared memory)
            pt = prepare_trace(many_arrays_trace())
            cfgs = wide_configs(pt, ("h_ntx_rd-4R1W-b4", "remap-4R2W",
                                     "banked1"))
        _WIDE[name] = pt, cfgs, _lane_call(pt, cfgs, "cpu", record=True)
    return _WIDE[name]


@pytest.mark.parametrize("name", ["hub", "many"])
def test_cycle_lanes_scans_wider_than_a_round(cuda, name):
    """The warp rounds of the deferral scan give the one-pop loop's
    result on lanes that may defer up to 872 (hb_ntx 4R2W b4), 296
    (h_ntx_rd 4R1W b4), 32 (remap 4R2W) and 16 (banked 1) candidates a
    cycle: raw outputs, maps and event logs bit-equal to the plain
    version."""
    pt, cfgs, want = _wide_case(name)
    got = _lane_call(pt, cfgs, cuda, record=True)
    torch.cuda.synchronize()
    _same_raw(got, want)
    prof = _lane_call(pt, cfgs, cuda, profile=True)
    torch.cuda.synchronize()
    _same_raw(prof[:5], want[:5])
    pops, rounds = prof[5][:, 6].cpu(), prof[5][:, 7].cpu()
    assert bool((rounds >= 1).all()) and bool((pops >= rounds).all())
    if name == "hub":
        # hb_ntx b4 pops its 872 deferrals a cycle 32 at a time
        assert int(pops[0]) > 8 * int(rounds[0])


def _select_trace(name: str):
    """A trace for the select of each class's first ready positions.

    ``skip``: 2100 IADDs chained behind a load (the class's highest
    priorities, none ready until the load retires) before 1200 IADDs
    ready at once, so the class's first ready position lies past its
    first 2048 positions (a summary word with nothing ready); 45 IMULs
    ready at once, the IADD/IMUL boundary inside a bitmap word; an array
    that is never accessed (an empty segment).  ``arrays``: 700 loads of
    one array ready at once (more than the scan slots), an empty array
    between two others, short load chains and stores in a third, FADD
    joins and a few FDIVs (a class inside one bitmap word)."""
    from repro_torch.core.sim import TraceBuilder
    from repro_torch.core.sim.trace import FADD, FDIV, IADD, IMUL

    tb = TraceBuilder(f"select_{name}")
    if name == "skip":
        a = tb.declare_array("a", 4)
        tb.declare_array("unused", 4)
        prev = tb.load(a, 0)
        for _ in range(2100):
            prev = tb.op(IADD, prev)
        for _ in range(1200):
            tb.op(IADD)
        for _ in range(45):
            tb.op(IMUL)
        tb.store(a, 1, (prev,))
        return tb.build()
    a = tb.declare_array("a", 4)
    tb.declare_array("unused", 4)
    c = tb.declare_array("c", 8)
    loads = [tb.load(a, (7 * i) % 61) for i in range(700)]
    prev, chains = (), []
    for i in range(75):
        x = tb.load(c, (5 * i) % 59, prev)
        chains.append(x)
        prev = (x,) if i % 4 else ()
    joins = [tb.op(FADD, loads[i], loads[i + 1]) for i in range(0, 699, 2)]
    for i in range(5):
        tb.store(c, i, (tb.op(FDIV, joins[i], chains[-1 - i]),))
    return tb.build()


def _select_configs(pt):
    """Designs over every array of ``pt``, with FU budgets below the
    ready counts (IADD 1, IMUL 2) and above them (IADD 4096)."""
    from repro_torch.core.amm.spec import AMMSpec
    from repro_torch.core.sim import ScheduleConfig

    below = {"iadd": 1, "imul": 2, "fadd": 1, "fdiv": 1}
    above = {"iadd": 4096, "imul": 64, "fadd": 512, "fdiv": 8}
    return [ScheduleConfig(mem={aid: AMMSpec(kind, rd, wr, 64, n_banks=nb)
                                for aid in pt.trace.array_names},
                           fu_counts=fu, mem_latency=lat)
            for kind, rd, wr, nb, fu, lat in (
                ("banked", 2, 2, 4, below, 2), ("hb_ntx", 4, 2, 1, above, 3),
                ("remap", 2, 2, 1, below, 1), ("lvt", 4, 2, 1, above, 0),
                ("ideal", 8, 4, 1, below, 5),
                ("multipump", 2, 2, 1, above, 2))]


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("name", ["skip", "arrays"])
def test_cycle_lanes_select_matches_plain(cuda, name, record):
    """The select of each class's first ready positions from its own
    segment: on traces where a class boundary falls inside a bitmap
    word, a class's first ready position lies more than 1024 positions
    past its segment's start (the summary skip), FU budgets sit above
    and below the ready counts, an array has more ready positions than
    the scan slots and an array's segment is empty, the raw outputs
    (cycles, counters, per-array accesses, maps, and with ``record`` the
    event log's four columns) equal the plain version's."""
    from repro_torch.core.sim import prepare_trace
    from repro_torch.core.sim.batched_cycle import _lane_inputs

    pt = prepare_trace(_select_trace(name))
    dv = pt.device_views()
    seg = dv.seg_start
    A = dv.a_pad
    assert any(s % 32 for s in seg[1:-1] if 0 < s < dv.n_real)
    assert any(seg[g] == seg[g + 1] for g in range(A))
    cfgs = _select_configs(pt)
    sc, _ = _lane_inputs(pt, cfgs)
    if name == "skip":
        iadd = A + 3                                  # FU_ORDER's "iadd"
        assert seg[iadd + 1] - seg[iadd] == 3300
        # the chain (nodes 1-2100) leads the class's segment
        assert sorted(dv.perm[seg[iadd]:seg[iadd] + 2100]) == list(
            range(1, 2101))
    else:
        assert 700 > sc.scan_slots
    got = _lane_call(pt, cfgs, cuda, record=record)
    torch.cuda.synchronize()
    _same_raw(got, _lane_call(pt, cfgs, "cpu", record=record))


@pytest.mark.parametrize("rows", ["spec", "past_the_tree"])
def test_cycle_lanes_matches_plain_at_odd_depths(cuda, rows):
    """NTX lanes at depths that are not powers of two (hb_ntx 4R2W,
    b_ntx_wr 1R2W, h_ntx_rd 4R1W; leaf sub-banking 1 and 4), with the
    spec's descriptor rows and with rows cut so that addresses fall past
    the tree, where the leaf paths the kernel computes must be the zero
    row the padded tables held: raw outputs, maps and event logs
    bit-equal to the plain version, and the profiling instantiation
    schedules as the default one."""
    from _torch_sched_util import (odd_depth_configs, odd_depth_trace,
                                   past_the_tree)
    from repro_torch.core.sim import prepare_trace
    from repro_torch.core.sim.batched_cycle import _lane_inputs, lane_outputs

    pt = prepare_trace(odd_depth_trace())
    sc, ins = _lane_inputs(pt, odd_depth_configs())
    if rows == "past_the_tree":
        ins = dict(ins, desc=past_the_tree(ins["desc"]))
    want = lane_outputs(pt, sc, ins, "cpu", record=True)
    got = lane_outputs(pt, sc, ins, cuda, record=True)
    torch.cuda.synchronize()
    _same_raw(got, want)
    prof = lane_outputs(pt, sc, ins, cuda, profile=True)
    torch.cuda.synchronize()
    _same_raw(prof[:5], want[:5])


def test_cycle_lanes_profile_and_barrier_probe(cuda):
    """The profiling instantiation schedules as the default one does
    and counts each lane's phases, visited cycles and the deferral
    scan's pops and warp rounds; the barrier probe gives a positive
    time."""
    from _torch_sched_util import golden_configs
    from repro_torch.kernels.cycle_lanes import barrier_ms, cycle_lanes

    pt, _, cfgs = golden_configs("bfs_queue")
    launches = cycle_lanes.launches
    plain = _lane_call(pt, cfgs, cuda)
    prof = _lane_call(pt, cfgs, cuda, profile=True)
    torch.cuda.synchronize()
    assert cycle_lanes.launches == launches + 2
    _same_raw(prof[:5], [t.cpu() for t in plain])
    p = prof[5].cpu()
    assert p.shape == (len(cfgs), 8) and bool((p >= 0).all())
    assert bool((p[:, 5] <= prof[0].cpu()).all()) and bool((p[:, 5] > 0).all())
    assert bool((p[:, :5].sum(1) > 0).all())
    # a lane that issued memory ops popped them in at least one round
    mem = prof[1].cpu()[:, 1] > 0
    assert bool(mem.any()) and bool((p[mem, 7] >= 1).all())
    assert bool((p[:, 6] >= p[:, 7]).all())
    ms, clocks = barrier_ms(cuda, iters=10_000)
    assert ms > 0 and clocks > 0
    with pytest.raises(ValueError):
        _lane_call(pt, cfgs, cuda, record=True, profile=True)


def test_profile_lanes_reads_the_slowest_lane(cuda):
    """``batched_cycle.profile_lanes`` names a lane of the launch, its
    cycles as the schedule has them, the cycles it visited and its SM
    clocks in each phase, with shares that sum to one; the bitmap words
    its select read, at most the non-empty words plus one a class a
    visited cycle (a word that two classes share is read by both); and
    the five slowest lanes, slowest first, the first of them its own."""
    from _torch_sched_util import golden_configs
    from repro_torch.core.sim.batched_cycle import (LANE_PHASES,
                                                    profile_lanes,
                                                    schedule_batched)

    pt, _, cfgs = golden_configs("bfs_queue")
    got = profile_lanes(pt, cfgs, cuda)
    res = schedule_batched(pt, cfgs, device=cuda)
    assert 0 <= got["lane"] < len(cfgs)
    assert got["cycles"] == res[got["lane"]].cycles
    assert 0 < got["visited"] <= got["cycles"]
    assert list(got["clocks"]) == list(LANE_PHASES)
    clocks = sum(got["clocks"].values())
    assert clocks > 0 and all(c >= 0 for c in got["clocks"].values())
    assert got["clocks_per_visit"] == pytest.approx(clocks / got["visited"])
    assert sum(got["shares"]) == pytest.approx(1.0)
    assert got["scan_pops"] >= got["scan_rounds"] >= 1
    classes = pt.device_views().a_pad + 7
    assert 0 < got["select_words"] <= (got["ready_words"]
                                       + classes * got["visited"])
    slowest = got["slowest"]
    assert len(slowest) == min(5, len(cfgs))
    assert slowest[0] == {"lane": got["lane"], "clocks": clocks}
    assert len({r["lane"] for r in slowest}) == len(slowest)
    assert [r["clocks"] for r in slowest] == sorted(
        (r["clocks"] for r in slowest), reverse=True)


def test_cycle_lanes_rejects_what_it_does_not_take(cuda):
    """A layout beyond the card's shared memory is refused at launch
    (the wrapper raises); a CPU tensor mixed with CUDA ones is refused."""
    from _torch_sched_util import golden_configs
    from repro_torch.core.sim.batched_cycle import _lane_inputs
    from repro_torch.kernels.cycle_lanes import cycle_lanes

    pt, _, cfgs = golden_configs("paged_kv")
    sc, ins = _lane_inputs(pt, cfgs[:2])
    t = {k: torch.from_numpy(v).to(cuda) for k, v in ins.items()}
    args = (t["desc"], t["fu_budgets"], t["mem_latency"], t["ppb"],
            t["max_cycles"], sc.table_depth,
            pt.device_views().n_real, t["preds_pad"], t["lat"],
            t["is_load"], t["word_idx"], t["perm"], t["gid_perm"],
            t["seg_start"], t["x_pos"], t["word_pos"], t["succ_ptr"],
            t["succ_pos"], t["pend0"])
    sizes = dict(key_space=sc.key_space, bank_slots=sc.bank_slots,
                 pend_bits=sc.pend_bits, wheel_slots=sc.wheel_slots,
                 wheel_depth=sc.wheel_depth)
    with pytest.raises(RuntimeError, match="cycle_lanes launch failed"):
        cycle_lanes(*args, scan_slots=1 << 16, **sizes)
    with pytest.raises(RuntimeError, match="cycle_lanes launch failed"):
        cycle_lanes(*args, scan_slots=sc.scan_slots,
                    **dict(sizes, wheel_slots=3))
    with pytest.raises(ValueError):
        cycle_lanes(*args[:7], args[7].cpu(), *args[8:],
                    scan_slots=sc.scan_slots, **sizes)


# ---- the sweep runner, its audit and the locality metric on the card ----
BENCH_NAMES = ("fft_strided", "gemm_ncubed", "kmp", "md_knn", "sort_merge",
               "stencil2d", "aes", "spmv_crs", "bfs_queue", "nw", "viterbi",
               "radix_sort", "kv_decode", "paged_kv", "moe_route")


def _golden_grid(bench):
    """The TINY golden rows of ``bench``: the prepared trace, the designs
    and unrolls of its grid (designs-major), and each row folded into the
    DSEPoint the runner must return."""
    from _torch_sched_util import DESIGNS, golden_configs
    from repro_torch.core.dse.sweep import point_from_schedule
    from repro_torch.core.sim import ScheduleResult

    pt, rows, cfgs = golden_configs(bench)
    labels = {g["design"] for g in rows}
    designs = [dp for label, dp in DESIGNS.items() if label in labels]
    unrolls = tuple(sorted({g["unroll"] for g in rows}))
    folded = {(g["design"], g["unroll"]): point_from_schedule(
        pt, DESIGNS[g["design"]], g["unroll"], cfg, ScheduleResult(
            per_array_accesses={},
            **{k: v for k, v in g.items()
               if k not in ("bench", "design", "unroll")}))
        for g, cfg in zip(rows, cfgs)}
    assert len(folded) == len(designs) * len(unrolls)
    want = [folded[(dp.label, u)] for dp in designs for u in unrolls]
    return pt, designs, unrolls, want


def _same_points(got, want):
    """Equal points; avg_mem_parallelism within the golden file's 1e-9."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        ra, rb = a.row(), b.row()
        assert abs(ra.pop("avg_mem_parallelism")
                   - rb.pop("avg_mem_parallelism")) < 1e-9
        assert ra == rb


@pytest.mark.parametrize("bench", BENCH_NAMES)
def test_run_sweep_on_the_card_matches_golden_rows(cuda, bench, tmp_path):
    from repro_torch.core.dse import runner
    from repro_torch.kernels.cycle_lanes import cycle_lanes

    pt, designs, unrolls, want = _golden_grid(bench)
    cycle_lanes.launches = 0
    got = runner.run_sweep(pt, designs, unrolls, cache_dir=tmp_path)
    assert cycle_lanes.launches == 1
    _same_points(got, want)
    cache = runner.SweepCache(tmp_path)
    assert runner.run_sweep(pt, designs, unrolls, cache=cache) == got
    assert (cache.hits, cache.misses) == (len(got), 0)


def test_pruned_sweep_on_the_card_matches_plain(cuda, tmp_path):
    """``run_sweep(prune="surrogate")`` of a TINY benchmark schedules its
    band in one launch on the card, equal to the plain lanes' points."""
    from repro_torch.core.bench import get_trace
    from repro_torch.core.dse import runner
    from repro_torch.core.sim import prepare_trace
    from repro_torch.kernels.cycle_lanes import cycle_lanes

    pt = prepare_trace(get_trace("spmv_crs"))
    cycle_lanes.launches = 0
    got = runner.run_sweep(pt, prune="surrogate", cache_dir=tmp_path)
    assert cycle_lanes.launches == 1
    want = runner.run_sweep(pt, prune="surrogate", device="cpu")
    assert 0 < len(got) < 80
    assert got == want


@pytest.mark.parametrize("bench", ["viterbi", "bfs_queue"])
def test_front_cap_on_the_card_keeps_the_rule_s_set(cuda, bench,
                                                    monkeypatch):
    """A TINY band under the front cap: the card's kept points are
    bit-equal to the plain lanes', the dropped ones exactly those the
    host's rule caps on the plain lanes' cycles; three runs, one of them
    in launches of 8 lanes, and the band given in reverse order to
    ``evaluate_points`` return the same set."""
    from repro_torch.core.bench import get_trace
    from repro_torch.core.dse import surrogate
    from repro_torch.core.dse.sweep import (DEFAULT_DESIGNS, DEFAULT_UNROLLS,
                                            _point_static_cost,
                                            evaluate_points,
                                            schedule_config_for)
    from repro_torch.core.sim import batched_cycle, prepare_trace
    from repro_torch.core.sim.batched_cycle import (_lane_inputs,
                                                    front_capped,
                                                    front_eligible,
                                                    schedule_batched)
    from repro_torch.core.sim.scheduler import schedule_batch

    pt = prepare_trace(get_trace(bench))
    preds = surrogate.grid_predictions(pt, DEFAULT_DESIGNS, DEFAULT_UNROLLS)
    band = [(p.design, p.unroll)
            for p, k in zip(preds, surrogate.select_band(preds)) if k]
    band.sort(key=lambda pu: _point_static_cost(
        schedule_config_for(pt, *pu), pu[1])[0])
    cfgs = [schedule_config_for(pt, dp, u) for dp, u in band]
    areas, ns = zip(*(_point_static_cost(c, u)
                      for c, (_, u) in zip(cfgs, band)))
    plain = schedule_batched(pt, cfgs, device="cpu")
    desc = _lane_inputs(pt, cfgs)[1]["desc"]
    kept = front_capped(areas, ns, [r.cycles for r in plain],
                        cfgs[0].max_cycles, front_eligible(cfgs, desc))
    assert 0 < sum(kept) < len(cfgs)
    for lanes in (256, 256, 8):
        monkeypatch.setattr(batched_cycle, "BATCH_LANES", lanes)
        got = schedule_batch(pt, cfgs, areas=areas, cycle_ns=ns,
                             front_cap=True)
        assert [r is not None for r in got] == kept
        for g, w, k in zip(got, plain, kept):
            if k:
                assert g.summary() == w.summary()
    want = evaluate_points(pt, band, front_cap=True, device="cpu")
    back = evaluate_points(pt, band[::-1], front_cap=True)
    assert [p is not None for p in want] == kept
    assert [None if p is None else p.row() for p in back[::-1]] == \
        [None if p is None else p.row() for p in want]


@pytest.mark.parametrize("bench", ["paged_kv", "kmp", "aes"])
def test_legality_pass_on_the_card(cuda, bench, tmp_path, monkeypatch):
    """The audit re-schedules the points on the card with event logs,
    one launch a ``BATCH_LANES`` chunk: 0 violations; an edited cache
    entry fails it."""
    import hashlib
    import json

    from repro_torch.core.dse import runner
    from repro_torch.core.sim import batched_cycle
    from repro_torch.core.verify import LegalityError
    from repro_torch.kernels.cycle_lanes import cycle_lanes

    pt, designs, unrolls, want = _golden_grid(bench)
    monkeypatch.setattr(batched_cycle, "BATCH_LANES", 16)
    cycle_lanes.launches = 0
    got = runner.run_sweep(pt, designs, unrolls, cache_dir=tmp_path,
                           check=True)
    n = len(designs) * len(unrolls)
    assert cycle_lanes.launches == 2 * -(-n // 16)
    _same_points(got, want)
    key = runner.point_key(pt.fingerprint, designs[-1], unrolls[-1], 2)
    path = runner.SweepCache(tmp_path)._path(key)
    entry = json.loads(path.read_text())
    entry["point"]["cycles"] -= 1
    entry["sha256"] = hashlib.sha256(json.dumps(
        entry["point"], sort_keys=True).encode()).hexdigest()
    path.write_text(json.dumps(entry))
    with pytest.raises(LegalityError, match="counter"):
        runner.run_sweep(pt, designs, unrolls, cache_dir=tmp_path,
                         check=True)


def test_spatial_locality_torch_on_the_card(cuda):
    from repro_torch.core.bench import BENCHMARKS, get_trace
    from repro_torch.core.locality import (spatial_locality_np,
                                           spatial_locality_torch)

    base = np.int64(2) ** 40
    addrs = base + np.arange(0, 8000, 8, dtype=np.int64)
    assert abs(spatial_locality_torch(addrs) - 1 / 8) < 1e-9
    t = torch.from_numpy(addrs).to(cuda)
    assert abs(spatial_locality_torch(t) - 1 / 8) < 1e-9
    for name in BENCHMARKS:
        a, ids = get_trace(name).mem_addrs_and_arrays()
        for aid in np.unique(ids):
            s = a[ids == aid]
            assert abs(spatial_locality_torch(torch.from_numpy(s).to(cuda))
                       - spatial_locality_np(s)) < 1e-9, (name, aid)


@pytest.mark.parametrize("bench", BENCH_NAMES)
def test_run_torch_on_the_card_holds_to_numpy(cuda, bench):
    """Each benchmark's ``run_torch`` on the card at TINY, held to its
    numpy reference at the tolerance of ``tests/_torch_bench_calls.py``
    (exact for the integer and byte benchmarks)."""
    from _torch_bench_calls import bench_case, holds
    from repro_torch.core.bench import BENCHMARKS

    call, want = bench_case(bench, BENCHMARKS[bench].TINY, cuda)
    got = call()
    assert all(g.is_cuda for g in got)
    assert holds(bench, got, want)


# ------------------------------------------------------------ autotune
_WRAPPERS = {"amm_gather": amm_gather_u32, "kv_decode": banked_kv_decode,
             "ssd_chunk": ssd_chunk_step}


def _tune_problems(cuda):
    """(kernel, args, dims) of small shapes whose candidates span every
    launch parameter: gathers at 16-, 2- and 16-byte words (the last at
    qwen3-1.7b's row); decodes of a group of 3 (head blocks 1, 2 and 4)
    in f32 and bf16 with banks of 8 tiles; SSD chunks with and without
    16-byte staging."""
    g = _gen(40)
    found = []
    for word, d in ((torch.int32, 24), (torch.int16, 5), (torch.int16,
                                                          2048)):
        lo, hi = (-2**31, 2**31 - 1) if word == torch.int32 else \
            (-2**15, 2**15)
        banks = torch.randint(lo, hi, (3, 40, d), generator=g, device=cuda,
                              dtype=word)
        parity = torch.randint(lo, hi, (40, d), generator=g, device=cuda,
                               dtype=word)
        idx = torch.randint(0, 120, (77,), generator=g, device=cuda,
                            dtype=torch.int32)
        args = (banks, parity, idx)
        found.append(("amm_gather", args, gather_mod.launch_dims(*args)))
    for dtype in (torch.float32, torch.bfloat16):
        b, hq, hkv, s, d, nb = 3, 12, 4, 1024, 64, 2
        q = torch.randn((b, hq, d), generator=g, device=cuda).to(dtype)
        k = torch.randn((b, hkv, nb, s // nb, d), generator=g,
                        device=cuda).to(dtype)
        v = torch.randn((b, hkv, nb, s // nb, d), generator=g,
                        device=cuda).to(dtype)
        lens = torch.tensor([0, 700, s], dtype=torch.int32, device=cuda)
        found.append(("kv_decode", (q, k, v, lens),
                      kv_mod.launch_dims(q, k, v)))
    for shape in ((2, 3, 40, 24, 20), (2, 3, 12, 8, 6)):
        ins = _ssd_inputs(g, cuda, *shape)
        found.append(("ssd_chunk", ins, ssd_mod.launch_dims(*ins)))
    return found


@pytest.fixture
def planted_table(tmp_path):
    yield tmp_path / "table.json"
    autotune.load_table(refresh=True)


@pytest.mark.parametrize("case", range(7))
def test_every_candidate_matches_plain(cuda, case):
    kernel, args, dims = _tune_problems(cuda)[case]
    want = autotune._plain(kernel, args)
    wrapper = _WRAPPERS[kernel]
    cands = autotune.candidates(kernel, **dims)
    assert autotune.default_config(kernel, **dims) in cands
    for cfg in cands:
        before = wrapper.launches
        got = wrapper(*args, **cfg)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert dict(wrapper.config) == cfg
        assert autotune.holds(kernel, got, want, args), cfg


def test_candidates_span_every_launch_parameter(cuda):
    problems = _tune_problems(cuda)
    seen = {}
    for kernel, _, dims in problems:
        for cfg in autotune.candidates(kernel, **dims):
            for k, v in cfg.items():
                seen.setdefault(k, set()).add(v)
    assert seen["pairs"] == set(autotune.PAIRS)
    assert seen["word_bytes"] == set(autotune.WORDS)
    assert seen["head_block"] == set(autotune.HEAD_BLOCKS)
    assert seen["split_len"] == {64, 128, 256, 512}
    assert seen["bulk"] == seen["vec"] == {0, 1}


def test_an_illegal_configuration_raises_on_card(cuda):
    problems = _tune_problems(cuda)
    bad = {0: [dict(pairs=3), dict(pairs=32), dict(word_bytes=32)],
           1: [dict(word_bytes=4)],
           3: [dict(head_block=3), dict(head_block=8), dict(split_len=100),
               dict(split_len=32), dict(bulk=2)],
           5: [dict(vec=2)], 6: [dict(vec=1)]}
    for case, cfgs in bad.items():
        kernel, args, _ = problems[case]
        for cfg in cfgs:
            before = _WRAPPERS[kernel].launches
            with pytest.raises(ValueError, match="not legal"):
                _WRAPPERS[kernel](*args, **cfg)
            assert _WRAPPERS[kernel].launches == before
    # the C entries refuse what the wrappers never pass
    banks, parity, idx = problems[0][1]
    out = torch.empty((77, 24), dtype=torch.int32, device=cuda)
    lib, fn = gather_mod._launcher()
    for word_bytes, pairs in ((16, 3), (16, 32), (3, 4), (32, 4)):
        code = fn(banks.data_ptr(), parity.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), 77, 3, 40, 96, word_bytes, pairs,
                  _build.stream_ptr(banks))
        assert code == 1, (word_bytes, pairs)   # cudaErrorInvalidValue
    q, k, v, lens = problems[3][1]
    work = torch.empty(3 * 12 * 2 * 66, device=cuda)
    lib, fn, _ = kv_mod._launcher()
    for head_block in (0, 3, 8):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                  torch.empty_like(q).data_ptr(), work.data_ptr(), 3, 4, 3,
                  2, 512, 512, 64, 0.125, 0, head_block, 1,
                  _build.stream_ptr(q))
        assert code == 1, head_block


def test_wrappers_take_the_tables_configuration(cuda, planted_table):
    """A planted entry under this card's name reaches the launch through
    every wrapper and through ``ops``; a launch of another bucket takes
    the default."""
    name = torch.cuda.get_device_name(cuda)
    problems = [_tune_problems(cuda)[i] for i in (0, 3, 5)]
    entries, planted = {}, {}
    for kernel, args, dims in problems:
        cfg = autotune.candidates(kernel, **dims)[0]
        assert cfg != autotune.default_config(kernel, **dims)
        entries[autotune.shape_key(kernel, name, **dims)] = {"config": cfg}
        planted[kernel] = cfg
    autotune.save_table(entries, planted_table)
    for kernel, args, dims in problems:
        _WRAPPERS[kernel](*args)
        assert dict(_WRAPPERS[kernel].config) == planted[kernel]
    x, dt, cum, B, C, h_in = problems[2][1]
    ssd_chunk(x, dt, cum, B, C, h_in)
    assert dict(ssd_chunk_step.config) == planted["ssd_chunk"]
    ins = _ssd_inputs(_gen(41), cuda, 2, 3, 80, 24, 20)   # another bucket
    ssd_chunk(*ins)
    assert dict(ssd_chunk_step.config) == {"vec": 1}


@pytest.mark.parametrize("case", [0, 3, 5])
def test_tune_on_the_card(cuda, case):
    kernel, args, dims = _tune_problems(cuda)[case]
    entries = {}
    entry = autotune.tune(kernel, args, dims, repeat=3, entries=entries)
    name = torch.cuda.get_device_name(cuda)
    assert list(entries) == [autotune.shape_key(kernel, name, **dims)]
    assert len(entry["swept"]) == len(autotune.candidates(kernel, **dims))
    assert all(r["us"] > 0 for r in entry["swept"])
    assert entry["us"] <= entry["default_us"]
    assert autotune.is_legal(kernel, entry["config"], **dims)


def test_kernels_spill_nothing_at_any_configuration(cuda):
    for name, sym in (("amm_gather", "amm_gather_kernel"),
                      ("banked_kv_decode", "kv_"), ("ssd_scan", "ssd_")):
        _build.load(name)
        rows = [r for r in _build.ptxas_report(name) if sym in r["name"]]
        assert rows
        assert all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                   for r in rows), rows
