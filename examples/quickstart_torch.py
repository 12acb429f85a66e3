"""Quickstart on the PyTorch port: the paper's pipeline in 60 lines.

1. Build an algorithmic multi-port memory (HB-NTX-RdWr, 4R2W) out of
   2-port banks and show conflict-free multi-port semantics.
2. Trace a MachSuite benchmark, measure its Weinberg spatial locality.
3. Run the Mem-Aladdin DSE sweep (each sweep one ``cycle_lanes`` launch)
   and print the paper's headline comparison: AMM vs banked area at
   matched execution time.

It prints what ``examples/quickstart.py`` prints, byte for byte.  Words
are ``uint32`` carried as int32 bits on the device; they are printed
and held against the RAM oracle as ``uint32``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
      (the CUDA device unless ``--device`` names another)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import AMMSpec, make_amm, trace_locality
from repro_torch.core.amm import replay as rp
from repro_torch.core.bench import BENCHMARKS
from repro_torch.core.dse import DesignPoint, performance_ratio, sweep
from repro_torch.device import resolve_device

DEPTH = 256
N_CYCLES = 1024


def as_u32(words: torch.Tensor) -> np.ndarray:
    """int32 word bits as the ``uint32`` values they carry (numpy)."""
    return words.cpu().numpy().view(np.uint32)


def replay_matches_ram(init: np.ndarray, ra, wa, wv, wm,
                       read_vals: torch.Tensor) -> bool:
    """Hold a replay's direct reads ([T, R] int32 bits) against a RAM
    that starts as ``init`` (``uint32``) and takes the masked writes of
    each cycle after its reads."""
    oracle = np.array(init, dtype=np.uint32)
    got = as_u32(read_vals)
    ok = True
    for t in range(len(ra)):
        ok &= bool((got[t] == oracle[ra[t]]).all())
        oracle[wa[t][wm[t]]] = wv[t][wm[t]]
    return ok


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out: dict = {}

    # --- 1. a 4R2W memory built from dual-port banks --------------------
    spec = AMMSpec("hb_ntx", n_read=4, n_write=2, depth=DEPTH)
    init = np.arange(DEPTH, dtype=np.uint32)
    sim = make_amm(spec, init, device=dev)
    state = sim.state

    # four reads + two conflicting writes in ONE cycle, no stalls:
    reads = torch.tensor([0, 1, 128, 255], device=dev)
    w_addr = torch.tensor([7, 9], device=dev)   # both in the same half
    w_val = rp.words(np.array([111, 222], dtype=np.uint32), dev)
    mask = torch.tensor([True, True], device=dev)
    state, vals = sim.step(state, reads, w_addr, w_val, mask)
    addr = {a: torch.tensor(a, device=dev) for a in (7, 9)}
    out["reads"] = as_u32(vals)
    out["writes"] = (int(as_u32(sim.read(state, addr[7]))),
                     int(as_u32(sim.read(state, addr[9]))))
    out["parity_read"] = int(as_u32(sim.read_parity(state, addr[9])))
    print("4 parallel reads  :", out["reads"])
    print("conflicting writes:", *out["writes"], "(via XOR ref re-pointing)")
    print("parity-path read  :", out["parity_read"],
          "(reconstructed from the other bank + Ref)")
    banks, depth = spec.leaf_banks()
    out["banks"], out["bank_depth"] = banks, depth
    out["overhead"] = spec.storage_bits() / (DEPTH * 32)
    print(f"built from {banks} two-port banks of depth {depth} "
          f"(storage overhead {out['overhead']:.2f}x)")

    # ...and verify the whole design against a RAM oracle: replay a
    # 1024-cycle random op trace through the replay engine.
    ra, wa, wv, wm = rp.make_trace(spec, n_cycles=N_CYCLES, seed=0)
    state, res = sim.replay(state, ra, wa, wv, wm)
    after = init.copy()
    after[7], after[9] = 111, 222          # the two writes above
    out["replay_ok"] = replay_matches_ram(after, ra, wa, wv, wm,
                                          res.read_vals)
    out["parity_agrees"] = bool((res.read_vals == res.parity_vals).all())
    print(f"{N_CYCLES}-cycle replay vs RAM oracle: "
          f"{'OK' if out['replay_ok'] else 'MISMATCH'}; "
          f"parity path agrees: {out['parity_agrees']}\n")

    # --- 2. spatial locality of a benchmark -----------------------------
    out["locality"] = {}
    for name in ("kmp", "md_knn"):
        mod = BENCHMARKS[name]
        tr = mod.gen_trace(mod.TINY)
        addrs, aids = tr.mem_addrs_and_arrays()
        out["locality"][name] = trace_locality(addrs, aids)
        print(f"{name:8s} L_spatial = {out['locality'][name]:.3f}")

    # --- 3. mini DSE: does true multi-port pay off? ----------------------
    designs = [DesignPoint("banked", n_banks=4),
               DesignPoint("banked", n_banks=16),
               DesignPoint("hb_ntx", 4, 2), DesignPoint("lvt", 4, 2)]
    out["ratio"] = {}
    for name in ("kmp", "md_knn"):
        mod = BENCHMARKS[name]
        pts = sweep(mod.gen_trace(mod.TINY), designs, unrolls=(2, 8),
                    device=dev)
        ratio = out["ratio"][name] = performance_ratio(pts)
        print(f"{name:8s} perf-ratio (banked area / AMM area, geomean) = "
              f"{ratio:.2f}  "
              f"{'-> AMM wins' if ratio > 1 else '-> banking wins'}")
    print("\nThe paper's law: AMM pays off when L_spatial < 0.3 "
          "(low locality).")
    return out


if __name__ == "__main__":
    main()
