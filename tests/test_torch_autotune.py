"""The port's autotuner (``repro_torch.kernels.autotune``) on the CPU.

Its keys are held to the reference's (``repro.kernels.autotune``), its
re-legalization to the reference's ``ops._pick_block``, and its
defaults to each kernel's launch as it was before the table: the launch
rules are copied here as they stood (``_split_len_before``,
``_head_block_before``).  The kernels' tiles are pinned (the card tests
hold them to the library's).  ``tune`` runs with an injected timer and
call on the plain versions; the card sweep itself is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 15.
"""
import json

import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro.kernels.ops import _pick_block
from repro_torch.kernels import autotune as at
from repro_torch.kernels import pack_amm_banks
from repro_torch.kernels.amm_gather import (_word_bytes, amm_gather_u32,
                                            amm_gather_u32_plain)
from repro_torch.kernels.amm_gather import launch_dims as gather_dims
from repro_torch.kernels.banked_kv_decode import (banked_kv_decode,
                                                  banked_kv_decode_plain)
from repro_torch.kernels.ssd_scan import (_vec_copies, ssd_chunk_step,
                                          ssd_chunk_step_plain)
from repro_torch.kernels.ssd_scan import launch_dims as ssd_dims

# kv_decode_tile by (head dim, item size), as tests/test_torch_cuda.py
# pins them to the kernel's
KV_TILES = {(128, 2): 32, (128, 4): 32, (256, 2): 16, (64, 2): 64,
            (12, 4): 256, (8, 2): 512}


def _split_len_before(bank_len, tile):
    """banked_kv_decode._split_len as it stood before the table (now
    ``autotune.split_len`` at its default target)."""
    if bank_len <= 1024 or bank_len % tile:
        return bank_len
    tiles = bank_len // tile
    per_split = max(k for k in range(1, max(1, 1024 // tile) + 1)
                    if tiles % k == 0)
    return per_split * tile


def _head_block_before(group):
    """csrc/banked_kv_decode.cu's launch() as it stood before the table."""
    return 1 if group <= 1 else 2 if group <= 2 else 4


def kv(b, hq, hkv, s, d, nb, itemsize, vec=1):
    return dict(b=b, hq=hq, hkv=hkv, s=s, d=d, nb=nb, itemsize=itemsize,
                tile=KV_TILES[d, itemsize], vec=vec)


GATHER_DIMS = [dict(v=1024, d=128, nb=4, n=256, itemsize=4, word=16),
               dict(v=250, d=3, nb=5, n=63, itemsize=4, word=4),
               dict(v=95, d=5, nb=5, n=7, itemsize=2, word=2),
               dict(v=151936, d=2048, nb=8, n=65536, itemsize=2, word=16)]
KV_DIMS = [kv(128, 16, 8, 32768, 128, 8, 2), kv(4, 8, 4, 512, 64, 8, 2),
           kv(2, 12, 4, 3000, 12, 3, 4, vec=0), kv(2, 16, 1, 2048, 256, 1, 2),
           kv(3, 6, 2, 96 * 1000, 8, 3, 2), kv(1, 1, 1, 4100, 128, 1, 4)]
SSD_DIMS = [dict(bt=8, h=24, q=256, p=64, n=128, vec=1),
            dict(bt=2, h=3, q=12, p=8, n=6, vec=0)]
PROBLEMS = ([("amm_gather", d) for d in GATHER_DIMS]
            + [("kv_decode", d) for d in KV_DIMS]
            + [("ssd_chunk", d) for d in SSD_DIMS])


@pytest.fixture
def table(tmp_path):
    """A table of our own in use for the test; the checked-in one is put
    back afterwards."""
    yield tmp_path / "table.json"
    at.load_table(refresh=True)


def test_pow2_bucket_and_key_dims_match_reference():
    for x in list(range(0, 4100)) + [2**20 - 1, 2**20, 2**20 + 1, 151936]:
        assert at._pow2_bucket(x) == ref_autotune._pow2_bucket(x), x
    for dims in (dict(v=1000, n=200), dict(b=128, hq=16, hkv=8, s=32768,
                                           d=128, nb=8, itemsize=2),
                 dict(bt=8, h=80, q=256, p=64, n=64)):
        port = at.shape_key("ssd_chunk", "Card A", **dims)
        ref = ref_autotune.shape_key("ssd_chunk", "gpu", "compiled", **dims)
        assert port.split("|") == ["ssd_chunk", "Card A",
                                   ref.split("|")[3]]
    # the launch dims set legality at the call and stay out of the key
    assert at.shape_key("kv_decode", "Card A", **KV_DIMS[0]) == \
        at.shape_key("kv_decode", "Card A", **{
            k: v for k, v in KV_DIMS[0].items() if k not in ("tile", "vec")})
    k1 = at.shape_key("amm_gather", "Card A", v=1000, n=200)
    assert k1 == at.shape_key("amm_gather", "Card A", v=1024, n=256)
    assert k1 != at.shape_key("amm_gather", "Card A", v=1025, n=256)
    assert k1 != at.shape_key("amm_gather", "Card B", v=1000, n=200)


@pytest.mark.parametrize("kernel,dims", PROBLEMS)
def test_candidates_are_legal(kernel, dims):
    cands = at.candidates(kernel, **dims)
    assert cands and all(at.is_legal(kernel, c, **dims) for c in cands)
    assert len({json.dumps(c, sort_keys=True) for c in cands}) == len(cands)
    assert at.default_config(kernel, **dims) in cands
    if kernel == "kv_decode":
        bank = dims["s"] // dims["nb"]
        for c in cands:
            assert bank % c["split_len"] == 0
            assert (c["split_len"] == bank
                    or c["split_len"] % dims["tile"] == 0)


def test_candidate_counts_at_the_main_path():
    """20 gather candidates (5 pair counts x 4 words), 28 at decode_32k
    (head blocks 1 and 2 for its group of 2, the splits of 64-4096
    positions of a 4096-position bank, bulk or not), 2 SSD ones."""
    assert len(at.candidates("amm_gather", **GATHER_DIMS[3])) == 20
    cands = at.candidates("kv_decode", **KV_DIMS[0])
    assert len(cands) == 28
    assert sorted({c["split_len"] for c in cands}) == [
        64, 128, 256, 512, 1024, 2048, 4096]
    assert len(at.candidates("ssd_chunk", **SSD_DIMS[0])) == 2
    with pytest.raises(KeyError):
        at.candidates("nope")


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("d", [2048, 6, 5])
def test_default_gather_is_four_pairs_at_the_widest_word(d, offset):
    flat = torch.zeros(8 * 12 * d + 16, dtype=torch.int16)
    lead = (16 - flat.data_ptr() % 16) % 16 // 2
    banks = flat[lead + offset:lead + offset + 8 * 12 * d].view(8, 12, d)
    parity = torch.zeros((12, d), dtype=torch.int16)
    idx = torch.zeros(9, dtype=torch.int32)
    dims = gather_dims(banks, parity, idx)
    assert dims == dict(v=96, d=d, nb=8, n=9, itemsize=2,
                        word=_word_bytes(2 * d, banks, parity))
    assert at.default_config("amm_gather", **dims) == {
        "pairs": 4, "word_bytes": _word_bytes(2 * d, banks, parity)}


def test_default_decode_is_todays_launch():
    for group in range(1, 17):
        dims = kv(2, group, 1, 512, 64, 1, 2)
        assert at.default_config("kv_decode", **dims)["head_block"] == \
            _head_block_before(group) == {1: 1, 2: 2}.get(group, 4)
    for bank, want in ((512, 512), (4096, 1024), (4100, 4100)):
        dims = kv(2, 16, 8, 8 * bank, 128, 8, 2)
        assert at.default_config("kv_decode", **dims)["split_len"] == \
            _split_len_before(bank, 32) == want
    for (d, itemsize), tile in KV_TILES.items():
        for bank in (1, 17, 512, 1024, 1056, 4096, 4100, 12000, 65536):
            dims = dict(kv(1, 4, 2, 2 * bank, d, 2, itemsize), vec=0)
            cfg = at.default_config("kv_decode", **dims)
            assert cfg == {"head_block": 2,
                           "split_len": _split_len_before(bank, tile),
                           "bulk": 0}
    assert at.default_config("kv_decode", **KV_DIMS[0])["bulk"] == 1


@pytest.mark.parametrize("p,n,offset,want", [
    (64, 128, 0, 1), (24, 20, 0, 1), (70, 130, 0, 0), (64, 128, 1, 0)])
def test_default_ssd_stages_as_vec_copies_says(p, n, offset, want):
    flat = torch.zeros(2 * 3 * 5 * p + 8)
    lead = (16 - flat.data_ptr() % 16) % 16 // 4
    x = flat[lead + offset:lead + offset + 2 * 3 * 5 * p].view(2, 3, 5, p)
    dt, cum = torch.zeros(2, 3, 5), torch.zeros(2, 3, 5)
    B, C, h = torch.zeros(2, 5, n), torch.zeros(2, 5, n), \
        torch.zeros(2, 3, p, n)
    dims = ssd_dims(x, dt, cum, B, C, h)
    assert dims["vec"] == int(_vec_copies(p, n, x, dt, cum, B, C, h)) \
        == want
    assert at.default_config("ssd_chunk", **dims) == {"vec": want}


def test_legalize_relegalizes_as_pick_block():
    """The reference's ``test_pick_block_relegalizes`` cases, and every
    (target, length) up to 40 x 60, on the decode's split in units of
    the tile: the longest legal split at most the winner's."""
    cases = [(128, 256, 128), (128, 96, 96), (128, 97, 97), (4, 6, 3),
             (1, 5, 1)]
    cases += [(t, n, _pick_block(t, n)) for t in range(1, 41)
              for n in range(1, 61)]
    for tile, d, itemsize in ((32, 128, 2), (512, 8, 2)):
        for target, n, want in cases:
            dims = dict(kv(1, 2, 1, n * tile, d, 1, itemsize))
            got = at._legalize("kv_decode", {"head_block": 2,
                                             "split_len": target * tile,
                                             "bulk": 1}, **dims)
            assert got["split_len"] == want * tile, (target, n)
            assert at.is_legal("kv_decode", got, **dims)


def test_legalize_words_head_blocks_and_copies():
    g = dict(v=64, d=6, nb=2, n=8, itemsize=4, word=8)
    assert at._legalize("amm_gather", {"pairs": 16, "word_bytes": 16},
                        **g) == {"pairs": 16, "word_bytes": 8}
    for group, winner, want in ((1, 4, 1), (2, 4, 2), (3, 4, 4), (8, 2, 2),
                                (2, 1, 1)):
        dims = kv(1, group, 1, 512, 64, 1, 2, vec=0)
        cfg = at._legalize("kv_decode", {"head_block": winner,
                                         "split_len": 512, "bulk": 1},
                           **dims)
        assert cfg == {"head_block": want, "split_len": 512, "bulk": 0}
    assert at._legalize("ssd_chunk", {"vec": 1}, **SSD_DIMS[1]) == {"vec": 0}


def test_table_round_trip_miss_and_other_card(table):
    dims = GATHER_DIMS[0]
    key = at.shape_key("amm_gather", "Card A", **dims)
    entries = {key: {"config": {"pairs": 8, "word_bytes": 8}, "us": 1.0}}
    cards = {"Card A": "Card A, 700.00 W"}
    at.save_table(entries, table, cards)
    assert at.read_table(table) == (cards, entries)
    assert at.load_table(table, refresh=True) == entries
    assert at.get_config("amm_gather", "Card A", **dims) == \
        {"pairs": 8, "word_bytes": 8}
    # the same bucket at a smaller word: brought back to a legal word
    assert at.get_config("amm_gather", "Card A", **dict(dims, word=4)) == \
        {"pairs": 8, "word_bytes": 4}
    # a miss takes the default; another card's key never hits
    assert at.get_config("amm_gather", "Card A", **dict(dims, n=4096)) == \
        at.default_config("amm_gather", **dims)
    assert at.get_config("amm_gather", "Card B", **dims) == \
        at.default_config("amm_gather", **dims)


def test_resolve_takes_explicit_then_table_and_raises_on_illegal(
        table, monkeypatch):
    monkeypatch.setattr(at, "device_name", lambda index: "Card A")
    dims = KV_DIMS[0]
    key = at.shape_key("kv_decode", "Card A", **dims)
    at.save_table({key: {"config": {"head_block": 1, "split_len": 2048,
                                    "bulk": 1}}}, table)
    dev = torch.device("cuda", 0)
    assert at.resolve("kv_decode", dev, dims, head_block=None,
                      split_len=None, bulk=None) == \
        {"head_block": 1, "split_len": 2048, "bulk": 1}
    assert at.resolve("kv_decode", dev, dims, head_block=2, split_len=None,
                      bulk=0) == {"head_block": 2, "split_len": 2048,
                                  "bulk": 0}
    for bad in (dict(head_block=3), dict(split_len=1000),
                dict(split_len=48), dict(bulk=2)):
        with pytest.raises(ValueError, match="not legal"):
            at.resolve("kv_decode", dev, dims, **bad)
    with pytest.raises(ValueError, match="not legal"):
        at.resolve("kv_decode", dev, dict(dims, vec=0), bulk=1)


def test_a_missing_table_reads_as_empty_and_a_damaged_one_raises(table):
    assert at.read_table(table) == ({}, {})
    assert at.load_table(table, refresh=True) == {}
    at.save_table({"k": {"config": {"vec": 1}}}, table, {"A": "A, 1 W"})
    good = table.read_text()
    for bad in (good.replace('"vec": 1', '"vec": 0'), "{not json",
                good[:-2], good + " ", good.replace("1 W", "2 W")):
        table.write_text(bad)
        with pytest.raises(ValueError, match=str(table)):
            at.read_table(table)
        with pytest.raises(ValueError, match="damaged autotune table"):
            at.load_table(table, refresh=True)


def _cpu_problem(kernel):
    """(args, dims) of a small CPU problem of each kernel."""
    g = torch.Generator().manual_seed(3)
    if kernel == "amm_gather":
        table = torch.randn((96, 8), generator=g)
        banks, parity = pack_amm_banks(table, 3)
        idx = torch.randint(0, 96, (33,), generator=g, dtype=torch.int32)
        return (banks, parity, idx), gather_dims(banks, parity, idx)
    if kernel == "kv_decode":
        q = torch.randn((2, 4, 64), generator=g)
        k = torch.randn((2, 2, 2, 256, 64), generator=g)
        v = torch.randn((2, 2, 2, 256, 64), generator=g)
        lens = torch.tensor([0, 300], dtype=torch.int32)
        return (q, k, v, lens), dict(b=2, hq=4, hkv=2, s=512, d=64, nb=2,
                                     itemsize=4, tile=64, vec=1)
    x, dt = torch.randn((2, 3, 16, 8), generator=g), \
        0.01 + 0.1 * torch.rand((2, 3, 16), generator=g)
    ins = (x, dt, torch.cumsum(-dt, -1), torch.randn((2, 16, 4), generator=g),
           torch.randn((2, 16, 4), generator=g),
           torch.randn((2, 3, 8, 4), generator=g))
    return ins, dict(ssd_dims(*ins), vec=1)


_PLAIN = {"amm_gather": amm_gather_u32_plain,
          "kv_decode": banked_kv_decode_plain,
          "ssd_chunk": ssd_chunk_step_plain}


def _injected(kernel, times, bad=None):
    """A call of the plain version, tagged with its configuration (its
    output nudged for ``bad``), and a timer that reads ``times``."""
    def make_call(kernel_, args, cfg):
        def fn():
            out = _PLAIN[kernel](*args)
            if cfg != bad:
                return out
            if kernel == "amm_gather":
                return out ^ 1
            if kernel == "kv_decode":
                return out + 1e-3
            return out[0], out[1] + 1e-3
        fn.cfg = cfg
        return fn

    def timer(fn, repeat, warmup):
        return times(fn.cfg), 0.5
    return make_call, timer


@pytest.mark.parametrize("kernel", ["amm_gather", "kv_decode", "ssd_chunk"])
def test_tune_picks_the_fastest_and_keeps_the_default_within_margin(kernel):
    args, dims = _cpu_problem(kernel)
    cands = at.candidates(kernel, **dims)
    default = at.default_config(kernel, **dims)
    other = next(c for c in cands if c != default)
    key = at.shape_key(kernel, "Card A", **dims)
    for share, want in ((0.90, other), (0.98, default), (0.96, other)):
        def times(cfg):
            return {json.dumps(other): 100.0 * share}.get(
                json.dumps(cfg), 100.0 if cfg == default else 200.0)
        make_call, timer = _injected(kernel, times)
        entries = {}
        entry = at.tune(kernel, args, dims, repeat=3, entries=entries,
                        card="Card A", timer=timer, make_call=make_call)
        assert list(entries) == [key] and entries[key] is entry
        assert entry["config"] == want, share
        assert entry["default"] == default
        assert entry["default_us"] == 100.0
        assert entry["us"] == (100.0 * share if want == other else 100.0)
        assert [r["config"] for r in entry["swept"]] == cands
        assert entry["dims"] == dims and entry["first_ms"] == 0.5


@pytest.mark.parametrize("kernel", ["amm_gather", "kv_decode", "ssd_chunk"])
def test_tune_raises_on_a_candidate_that_differs_from_the_plain_version(
        kernel):
    args, dims = _cpu_problem(kernel)
    bad = at.candidates(kernel, **dims)[-1]
    make_call, timer = _injected(kernel, lambda cfg: 1.0, bad=bad)
    with pytest.raises(RuntimeError, match="differs from the plain"):
        at.tune(kernel, args, dims, repeat=3, card="Card A", timer=timer,
                make_call=make_call)


def test_checked_in_table_parses_and_each_entry_is_legal():
    cards, entries = at.read_table()
    assert entries, "the checked-in table has no entry"
    main = set()
    for key, entry in entries.items():
        kernel, card, _ = key.split("|")
        assert card in cards and cards[card].startswith(card)
        dims = entry["dims"]
        assert key == at.shape_key(kernel, card, **dims)
        assert at.is_legal(kernel, entry["config"], **dims)
        assert at.is_legal(kernel, entry["default"], **dims)
        # legal at its bucket: the key's dims rounded up, the same tile,
        # word and copy legality
        bucket = {k: v if k in at.LAUNCH_DIMS else at._pow2_bucket(v)
                  for k, v in dims.items()}
        if kernel == "kv_decode":
            bucket["hq"] = bucket["hkv"] * max(dims["hq"] // dims["hkv"], 1)
        assert at.is_legal(kernel, at._legalize(kernel, entry["config"],
                                                **bucket), **bucket)
        rows = {json.dumps(r["config"]): r["us"] for r in entry["swept"]}
        assert rows[json.dumps(entry["config"])] == entry["us"]
        assert rows[json.dumps(entry["default"])] == entry["default_us"]
        if entry["config"] != entry["default"]:
            assert entry["us"] <= (1 - at.MARGIN) * entry["default_us"]
        main.add((kernel, card))
    assert {k for k, _ in main} == {"amm_gather", "kv_decode", "ssd_chunk"}


def test_a_cpu_call_ignores_a_planted_entry(table, monkeypatch):
    """A CPU tensor takes the plain version: no table read, no config
    check, whatever the table or the arguments say."""
    for kernel in ("amm_gather", "kv_decode", "ssd_chunk"):
        args, dims = _cpu_problem(kernel)
        at.save_table({at.shape_key(kernel, "cpu", **dims):
                       {"config": {"pairs": 3}}}, table)

    def no_table(*a, **k):
        raise AssertionError("a CPU call read the autotune table")
    monkeypatch.setattr(at, "resolve", no_table)
    monkeypatch.setattr(at, "get_config", no_table)
    args, _ = _cpu_problem("amm_gather")
    assert torch.equal(amm_gather_u32(*args, pairs=3, word_bytes=32),
                       amm_gather_u32_plain(*args))
    args, _ = _cpu_problem("kv_decode")
    assert torch.equal(banked_kv_decode(*args, head_block=3, split_len=7,
                                        bulk=5),
                       banked_kv_decode_plain(*args))
    args, _ = _cpu_problem("ssd_chunk")
    for got, want in zip(ssd_chunk_step(*args, vec=9),
                         ssd_chunk_step_plain(*args)):
        assert torch.equal(got, want)
