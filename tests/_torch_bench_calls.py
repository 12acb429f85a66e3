"""Each benchmark's ``run_torch`` call on a device, and the numpy
reference it is held to, with the tolerance: shared by the CPU tests,
the card tests and ``chip_smoke.py`` (phase 9f).  Imports no JAX.

Inputs come from the modules' seeded ``make_inputs`` (``make_text``,
``make_input``), or from ``np.random.default_rng(0)`` where a module has
none (gemm_ncubed, fft_strided), in the dtypes they make.  References:
the module's ``run_np`` where it has one, ``encrypt_np`` for aes, and
otherwise what ``tests/test_bench.py`` holds the reference to
(``np.sort``, ``np.fft.fft``, ``a @ b``, the stencil's window sums), or,
for md_knn, whose reference test checks only shape and finiteness, the
same Lennard-Jones formula in numpy float64.

Tolerances ``(rtol, atol)``, ``None`` for exact: the reference tests'
own, with an absolute term where an output near zero makes a relative
one meaningless.  gemm_ncubed runs an f32 product (the reference's
``precision="highest"`` without x64) held to the float64 product of the
same f32 inputs: each entry is a sum of ``n`` products and carries a few
f32 roundings of its magnitude (~2e-6 at ``n`` 24, where a TF32 product
would be off by ~1e-3), so atol 1e-5.  stencil2d's f32 window sums run
in another order than the reference loop's: atol 1e-6 (a few f32
roundings of terms of magnitude ~1).
"""
import numpy as np
import torch

from repro_torch.core.bench import BENCHMARKS

TOL = {
    "aes": None, "kmp": None, "bfs_queue": None, "nw": None,
    "viterbi": None, "radix_sort": None, "sort_merge": None,
    "stencil2d": (1e-5, 1e-6), "md_knn": (1e-5, 0.0),
    "gemm_ncubed": (1e-5, 1e-5), "spmv_crs": (1e-5, 1e-6),
    "kv_decode": (1e-4, 1e-5), "paged_kv": (1e-4, 1e-5),
    "moe_route": (1e-4, 1e-5), "fft_strided": (1e-4, 1e-4),
}


def _stencil_np(orig, filt):
    r, c = orig.shape
    want = np.zeros((r - 2, c - 2), np.float32)
    for i in range(r - 2):
        for j in range(c - 2):
            want[i, j] = float((orig[i:i + 3, j:j + 3] * filt).sum())
    return want


def _md_knn_np(position, neighbor_list):
    lj1, lj2 = 1.5, 2.0
    d = position[:, None, :] - position[neighbor_list]
    r2inv = 1.0 / np.sum(d * d, axis=-1)
    r6inv = r2inv * r2inv * r2inv
    force = r2inv * (r6inv * (lj1 * r6inv - lj2))
    return np.sum(force[..., None] * d, axis=1)


def bench_case(name: str, p, device):
    """``(call, want)`` for benchmark ``name`` at params ``p``: ``call()``
    runs ``run_torch`` on ``device`` and returns its outputs as a tuple of
    tensors; ``want`` is the numpy reference's tuple of arrays."""
    mod = BENCHMARKS[name]
    dev = torch.device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    if name == "kmp":
        text = mod.make_text(p)
        x = t(text)
        return (lambda: (mod.run_torch(x),)), (np.asarray(mod.run_np(text)),)
    if name == "radix_sort":
        a = mod.make_input(p)
        x = t(a)
        return ((lambda: (mod.run_torch(x, p.value_bits),)),
                (mod.run_np(a, p.value_bits),))
    if name == "sort_merge":
        a = mod.make_input(p)
        x = t(a)
        return (lambda: (mod.run_torch(x),)), (np.sort(a),)
    if name == "gemm_ncubed":
        rng = np.random.default_rng(0)
        a, b = (rng.standard_normal((p.n, p.n)).astype(np.float32)
                for _ in range(2))
        ta, tb = t(a), t(b)
        return ((lambda: (mod.run_torch(ta, tb),)),
                (a.astype(np.float64) @ b.astype(np.float64),))
    if name == "fft_strided":
        rng = np.random.default_rng(0)
        x = rng.standard_normal(p.n) + 1j * rng.standard_normal(p.n)
        tx = t(x)
        return (lambda: (mod.spectrum(tx),)), (np.fft.fft(x),)

    i = mod.make_inputs(p)
    if name == "aes":
        blocks = t(i["blocks"])
        return ((lambda: (mod.run_torch(blocks, i["key"]),)),
                (mod.encrypt_np(i["blocks"], i["key"]),))
    if name == "nw":
        a, b = t(i["seq_a"]), t(i["seq_b"])
        return (lambda: mod.run_torch(a, b)), mod.run_np(i["seq_a"],
                                                         i["seq_b"])
    if name == "bfs_queue":
        edges = t(i["edges"])
        return ((lambda: (mod.run_torch(i["edge_ptr"], edges, p.n_nodes,
                                        p.start),)),
                (mod.run_np(i["edge_ptr"], i["edges"], p.n_nodes, p.start),))
    if name == "spmv_crs":
        vals, cols, vec = t(i["vals"]), t(i["cols"]), t(i["vec"])
        return ((lambda: (mod.run_torch(vals, cols, i["row_ptr"], vec),)),
                (mod.run_np(i["vals"], i["cols"], i["row_ptr"], i["vec"]),))
    if name == "md_knn":
        pos, nl = t(i["position"]), t(i["neighbor_list"])
        return ((lambda: (mod.run_torch(pos, nl),)),
                (_md_knn_np(i["position"], i["neighbor_list"]),))
    if name == "stencil2d":
        orig, filt = t(i["orig"]), t(i["filter"])
        return ((lambda: (mod.run_torch(orig, filt),)),
                (_stencil_np(i["orig"], i["filter"]),))
    keys = {"viterbi": ("obs", "init", "transition", "emission"),
            "kv_decode": ("q", "k", "v", "lengths"),
            "paged_kv": ("block_table", "lengths", "kv_pool", "weights"),
            "moe_route": ("logits", "x", "w_exp")}[name]
    extra = ((p.page_size,) if name == "paged_kv" else
             (p.top_k, p.capacity_factor) if name == "moe_route" else ())
    args = [t(i[k]) for k in keys]
    return ((lambda: (mod.run_torch(*args, *extra),)),
            (mod.run_np(*(i[k] for k in keys), *extra),))


def max_abs_err(got, want) -> float:
    """The largest absolute difference over every output."""
    return max(float(np.max(np.abs(np.asarray(g.cpu().numpy(), np.complex128)
                                   - np.asarray(w, np.complex128))))
               if np.size(w) else 0.0 for g, w in zip(got, want))


def holds(name: str, got, want) -> bool:
    """Every output of ``run_torch`` has the reference's shape and is
    equal to it (exact benchmarks) or within the benchmark's tolerance."""
    tol = TOL[name]
    for g, w in zip(got, want, strict=True):
        g = g.cpu().numpy()
        w = np.asarray(w)
        if g.shape != w.shape:
            return False
        if tol is None:
            if not np.array_equal(g, w):
                return False
        elif not np.allclose(g, w, rtol=tol[0], atol=tol[1]):
            return False
    return True
