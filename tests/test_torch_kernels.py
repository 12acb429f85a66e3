"""The port's kernel modules against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
function (compiled XLA grid path, ``mode="xla"``, and on a few cases the
Pallas interpreter) and through the port, whose wrappers take the
kernels' plain PyTorch versions on CPU tensors.  The CUDA kernels
themselves are held against those plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances are the reference's own (tests/test_kernel_parity.py): the
XOR gather is bit-exact; kv_decode sums in another order than XLA, so
f32 is held to 1e-5, bf16 to 4e-2 and ragged f32 to 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import amm_gather as jax_amm_gather
from repro.kernels import kv_decode as jax_kv_decode
from repro.kernels import pack_amm_banks as jax_pack_amm_banks
from repro.kernels import ref as jax_ref
from repro.kernels.amm_gather import amm_gather_u32 as jax_amm_gather_u32
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import _build, amm_gather, kv_decode, pack_amm_banks
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.amm_gather import _word_bytes, amm_gather_u32
from repro_torch.kernels.banked_kv_decode import _split_len, banked_kv_decode

_NP_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16}
_UINT = {2: np.uint16, 4: np.uint32}


def _cpu(a: np.ndarray) -> torch.Tensor:
    return tensor_from_numpy(a, "cpu")


def _bits_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize])


def _bits_torch(t: torch.Tensor) -> np.ndarray:
    word = torch.int16 if t.element_size() == 2 else torch.int32
    return t.view(word).numpy().view(_UINT[t.element_size()])


def _to_f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ----------------------------------------------------------------- amm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,d,nb,n,bn", [
    (64, 8, 2, 16, 8), (128, 16, 4, 64, 32), (256, 32, 8, 128, 128),
    (96, 8, 3, 48, 16),          # odd bank count
    (250, 8, 5, 50, 25),         # non-pow2 table depth and banks
    (64, 8, 1, 32, 32),          # single-bank degenerate geometry
])
def test_amm_gather_matches_jax(dtype, v, d, nb, n, bn):
    rng = np.random.default_rng(v * 10 + nb)
    table = rng.standard_normal((v, d)).astype(_NP_DTYPE[dtype])
    idx = rng.integers(0, v, n).astype(np.int32)
    want = jax_amm_gather(jnp.asarray(table), jnp.asarray(idx), n_banks=nb,
                          mode="xla", block_n=bn)
    got = amm_gather(_cpu(table), _cpu(idx), n_banks=nb)
    np.testing.assert_array_equal(_bits_torch(got), _bits_np(want))
    np.testing.assert_array_equal(
        _bits_torch(got), _bits_np(jnp.take(jnp.asarray(table),
                                            jnp.asarray(idx), axis=0)))
    np.testing.assert_array_equal(
        _bits_torch(got),
        _bits_torch(torch_ref.amm_gather_ref(_cpu(table), _cpu(idx))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,nb", [(64, 4), (250, 2), (250, 5)])
@pytest.mark.parametrize("n", [1, 7, 63, 97, 128])
def test_amm_gather_request_counts_match_jax(dtype, v, nb, n):
    """Any request count, prime ones included, with JAX's own block
    choice."""
    rng = np.random.default_rng(n * 7 + v)
    table = rng.standard_normal((v, 8)).astype(_NP_DTYPE[dtype])
    idx = rng.integers(0, v, n).astype(np.int32)
    want = jax_amm_gather(jnp.asarray(table), jnp.asarray(idx), n_banks=nb,
                          mode="xla")
    got = amm_gather(_cpu(table), _cpu(idx), n_banks=nb)
    np.testing.assert_array_equal(_bits_torch(got), _bits_np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_amm_gather_matches_jax_interpreter(dtype):
    rng = np.random.default_rng(9)
    table = rng.standard_normal((96, 16)).astype(_NP_DTYPE[dtype])
    idx = rng.integers(0, 96, 24).astype(np.int32)
    want = jax_amm_gather(jnp.asarray(table), jnp.asarray(idx), n_banks=3,
                          mode="interpret", block_n=8)
    got = amm_gather(_cpu(table), _cpu(idx), n_banks=3)
    np.testing.assert_array_equal(_bits_torch(got), _bits_np(want))


@pytest.mark.parametrize("word", [np.uint32, np.uint16])
@pytest.mark.parametrize("nb,rows,d,n,block_n,mode", [
    (4, 16, 8, 64, 16, "xla"),
    (3, 10, 5, 7, 7, "xla"),         # one block: any block size agrees
    (5, 8, 4, 40, 8, "xla"),
    (2, 12, 6, 30, 10, "interpret"),
])
def test_amm_gather_u32_inconsistent_parity_matches_jax(word, nb, rows, d,
                                                        n, block_n, mode):
    """A parity plane that is not the XOR of the banks separates the
    direct and reconstruction paths, so a kernel that serves odd slots
    from the direct bank fails here.  JAX counts slot parity within a
    block, the port within the call: an even ``block_n`` (or one block)
    makes them agree."""
    rng = np.random.default_rng(nb * 100 + d)
    info = np.iinfo(word)
    banks = rng.integers(0, int(info.max) + 1, (nb, rows, d)).astype(word)
    parity = rng.integers(0, int(info.max) + 1, (rows, d)).astype(word)
    idx = rng.integers(0, nb * rows, n).astype(np.int32)
    want = np.asarray(jax_amm_gather_u32(jnp.asarray(banks),
                                         jnp.asarray(parity),
                                         jnp.asarray(idx), block_n=block_n,
                                         mode=mode))
    signed = np.int32 if word == np.uint32 else np.int16
    got = amm_gather_u32(_cpu(banks.view(signed)), _cpu(parity.view(signed)),
                         _cpu(idx)).numpy().view(word)
    np.testing.assert_array_equal(got, want)
    direct = banks.reshape(nb * rows, d)[idx]
    assert not np.array_equal(got, direct), "parity path never exercised"


@pytest.mark.parametrize("row_bytes,offset,want", [
    (4096, 0, 16), (24, 0, 8), (12, 0, 4), (10, 0, 2), (4096, 4, 4),
    (4096, 8, 8), (4096, 2, 2),
])
def test_gather_word_by_pitch_and_base(row_bytes, offset, want):
    """The widest word that divides the row pitch and every base."""
    flat = torch.zeros(64, dtype=torch.int16)
    base = flat.data_ptr() % 16
    view = flat[(16 - base) // 2 + offset // 2:]
    assert view.data_ptr() % 16 == offset
    assert _word_bytes(row_bytes, view, flat[(16 - base) // 2:]) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb", [1, 3, 4])
def test_pack_amm_banks_matches_jax(dtype, nb):
    rng = np.random.default_rng(nb)
    table = rng.standard_normal((48, 8)).astype(_NP_DTYPE[dtype])
    jb, jp = jax_pack_amm_banks(jnp.asarray(table), nb)
    tb, tp = pack_amm_banks(_cpu(table), nb)
    np.testing.assert_array_equal(_bits_torch(tb), _bits_np(jb))
    np.testing.assert_array_equal(_bits_torch(tp), _bits_np(jp))


def test_pack_amm_banks_rejects_non_dividing_banks():
    with pytest.raises(ValueError, match="divide"):
        pack_amm_banks(torch.zeros((10, 4)), 3)


# ------------------------------------------------------------------ kv
_KV_SHAPES = [
    # b, hq, hkv, s, d, nb
    (2, 4, 2, 64, 16, 4),
    (1, 8, 8, 128, 32, 8),
    (3, 6, 2, 96, 8, 3),         # odd bank count
    (4, 8, 4, 64, 16, 1),        # single bank
]


def _kv_inputs(rng, b, hq, hkv, s, d, dtype):
    cast = _NP_DTYPE[dtype]
    return (rng.standard_normal((b, hq, d)).astype(cast),
            rng.standard_normal((b, hkv, s, d)).astype(cast),
            rng.standard_normal((b, hkv, s, d)).astype(cast))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 4e-2)])
@pytest.mark.parametrize("b,hq,hkv,s,d,nb", _KV_SHAPES)
@pytest.mark.parametrize("lengths", ["nonempty", "empty_and_full",
                                     "bank_edges"])
def test_kv_decode_matches_jax(dtype, tol, b, hq, hkv, s, d, nb, lengths):
    """The port's kv_decode and its dense oracle against JAX's kv_decode
    and dense oracle; ``empty_and_full`` sets row 0 to length 0 (exact
    zeros) and the last row to the whole cache; ``bank_edges`` puts
    every row's length on a bank boundary or one position either side
    of it (the CUDA kernel's splits never cross a bank, so these are
    split boundaries too)."""
    rng = np.random.default_rng(b * 1000 + s + d)
    q, k, v = _kv_inputs(rng, b, hq, hkv, s, d, dtype)
    lens = rng.integers(1, s + 1, b).astype(np.int32)
    if lengths == "empty_and_full":
        lens[-1], lens[0] = s, 0
    if lengths == "bank_edges":
        sb = s // nb
        edges = [sb * j + o for j in range(1, nb + 1) for o in (0, -1, 1)]
        lens = np.clip(np.asarray([edges[(i * 4) % len(edges)]
                                   for i in range(b)]), 0, s
                       ).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    targs = [_cpu(a) for a in (q, k, v, lens)]
    want = np.asarray(jax_kv_decode(*jargs, n_banks=nb, mode="xla"),
                      np.float32)
    dense = np.asarray(jax_ref.kv_decode_ref(*jargs), np.float32)
    got = kv_decode(*targs, n_banks=nb)
    assert got.dtype == targs[0].dtype and got.shape == (b, hq, d)
    np.testing.assert_allclose(_to_f32(got), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(_to_f32(got), dense, atol=tol, rtol=tol)
    np.testing.assert_allclose(_to_f32(torch_ref.kv_decode_ref(*targs)),
                               dense, atol=tol, rtol=tol)
    if lengths == "empty_and_full":
        assert torch.all(got[0] == 0), "empty row must decode to 0"


def test_kv_decode_matches_jax_interpreter():
    rng = np.random.default_rng(17)
    b, hq, hkv, s, d, nb = 2, 4, 2, 32, 8, 4
    q, k, v = _kv_inputs(rng, b, hq, hkv, s, d, "float32")
    lens = np.array([0, 19], np.int32)
    want = np.asarray(jax_kv_decode(
        *[jnp.asarray(a) for a in (q, k, v, lens)], n_banks=nb,
        mode="interpret", block_h=2))
    got = kv_decode(*[_cpu(a) for a in (q, k, v, lens)], n_banks=nb)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.all(got.numpy()[0] == 0.0)


@pytest.mark.parametrize("lens", [
    [0, 5, 33, 64],              # empty row + mid-bank + bank boundary + full
    [1, 1, 16, 17],              # bank-boundary straddle (SB=16 at nb=4)
    [0, 0, 0, 0],                # fully-empty batch
])
def test_kv_decode_ragged_matches_jax(lens):
    """Ragged rows: equal to JAX within 2e-5, empty rows exactly 0, and
    padded K/V content (poisoned with +-1e4) moves nothing."""
    b, hq, hkv, s, d, nb = 4, 4, 2, 64, 16, 4
    rng = np.random.default_rng(sum(lens))
    q, k, v = _kv_inputs(rng, b, hq, hkv, s, d, "float32")
    L = np.asarray(lens, np.int32)
    want = np.asarray(jax_kv_decode(
        *[jnp.asarray(a) for a in (q, k, v, L)], n_banks=nb, mode="xla"))
    got = kv_decode(*[_cpu(a) for a in (q, k, v, L)], n_banks=nb).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for i, n in enumerate(lens):
        if n == 0:
            assert np.all(got[i] == 0.0), "empty row must decode to 0"
    kp, vp = k.copy(), v.copy()
    for i, n in enumerate(lens):
        kp[i, :, n:, :] = 1e4
        vp[i, :, n:, :] = -1e4
    got2 = kv_decode(*[_cpu(a) for a in (q, kp, vp, L)], n_banks=nb).numpy()
    np.testing.assert_allclose(got2, got, atol=1e-6)


# positions a tile of the CUDA kernel, by (head dim, item size), as
# kv_decode_tile reports them (tests/test_torch_cuda.py pins these)
KV_TILES = {(128, 2): 32, (128, 4): 32, (256, 2): 16, (64, 2): 64,
            (32, 2): 128, (16, 4): 256, (12, 4): 256, (8, 2): 512,
            (8, 4): 512}


@pytest.mark.parametrize("s,nb,d,itemsize,want", [
    (32768, 8, 128, 2, 1024),        # decode_32k: 4 splits a bank
    (32768, 8, 128, 4, 1024),
    (32768, 1, 128, 2, 1024),        # one bank of 32 splits
    (16384, 2, 128, 4, 1024),
    (8192, 2, 128, 2, 1024),
    (2048, 1, 256, 2, 1024),
    (2048, 2, 64, 2, 1024),          # the whole bank
    (3 * 4096, 3, 8, 2, 1024),       # tile 512: two tiles a split
    (64, 4, 16, 4, 16), (128, 8, 32, 2, 16), (96, 3, 8, 4, 32),
    (300, 3, 128, 2, 100), (40, 5, 12, 4, 8), (512, 2, 256, 2, 256),
    (1024, 8, 128, 2, 128),
    (12 * 1000, 3, 128, 2, 800),     # 125 tiles a bank: 5 splits of 25
])
def test_kv_decode_split_len_stays_inside_banks(s, nb, d, itemsize, want):
    """Every split lies inside one bank, the splits tile each bank
    exactly, and a split shorter than its bank is a whole number of
    tiles (a whole bank may end in a partial tile, as a row's length
    may)."""
    sb = s // nb
    tile = KV_TILES[d, itemsize]
    split = _split_len(sb, tile)
    assert split == want
    assert sb % split == 0
    assert split == sb or split % tile == 0
    starts = range(0, s, split)
    assert len(starts) == nb * (sb // split)
    for start in starts:
        assert start // sb == (start + split - 1) // sb   # one bank
    if split < sb:
        assert split <= 1024


def test_kv_decode_rejects_non_dividing_banks():
    z = torch.zeros((1, 2, 10, 4))
    with pytest.raises(ValueError, match="divide"):
        kv_decode(torch.zeros((1, 2, 4)), z, z, torch.ones(1), n_banks=3)


# ------------------------------------------------------------ dispatch
def test_wrappers_dispatch_on_device_only():
    """A tensor that is neither on the CPU nor on a CUDA device, or a
    mix of devices, raises: nothing is routed to a plain version except
    CPU tensors."""
    meta = torch.zeros((2, 4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        amm_gather_u32(meta, meta[0], torch.zeros(3, dtype=torch.int32,
                                                  device="meta"))
    cpu = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        amm_gather_u32(cpu, cpu[0], torch.zeros(3, dtype=torch.int32,
                                                device="meta"))
    q = torch.zeros((1, 2, 8), device="meta")
    kb = torch.zeros((1, 1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        banked_kv_decode(q, kb, kb, torch.ones(1, dtype=torch.int32,
                                               device="meta"))


def test_cpu_calls_do_not_count_as_launches():
    before = (amm_gather_u32.launches, banked_kv_decode.launches)
    amm_gather(torch.randn(16, 4), torch.arange(16), n_banks=4)
    kv_decode(torch.randn(1, 2, 4), torch.randn(1, 1, 8, 4),
              torch.randn(1, 1, 8, 4), torch.tensor([5]), n_banks=2)
    assert (amm_gather_u32.launches, banked_kv_decode.launches) == before


def test_nvcc_command_targets_hopper(tmp_path):
    cmd = _build.nvcc_command("nvcc", tmp_path / "k.cu", tmp_path / "k.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "k.so")
    for flag in ("-O3", "-shared", "-std=c++17"):
        assert flag in cmd


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    """``-Xptxas -v`` lines kept beside a library: one record per entry
    function, with its registers, static shared memory and spills."""
    log = tmp_path / "k.log"
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z5splitv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z5splitv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 384 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z7combinev' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z7combinev\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 32 registers, 1024 bytes smem, 384 bytes "
        "cmem[0]\n")
    monkeypatch.setattr(_build, "log_path", lambda name: log)
    assert _build.ptxas_report("k") == [
        {"name": "_Z5splitv", "registers": 64, "smem": 0,
         "spill_stores": 0, "spill_loads": 0},
        {"name": "_Z7combinev", "registers": 32, "smem": 1024,
         "spill_stores": 4, "spill_loads": 12}]
    assert "-Xptxas" in _build.NVCC_FLAGS


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_kernel_has_a_source_and_a_keyed_library(name):
    src = _build.CSRC / f"{name}.cu"
    text = src.read_text()
    if name == "cycle_lanes":       # replaces a lax.while_loop, not Pallas
        assert "Replaces: src/repro/core/sim/jax_cycle.py:130 " \
            "_make_lane_fn" in text
    else:
        assert "Replaces: src/repro/kernels/" in text
    assert "What bounds it on this card" in text
    assert 'extern "C"' in text and "cudaGetLastError()" in text
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path(name)    # stable across calls
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
