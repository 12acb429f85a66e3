"""Fitted surrogate coefficients: a verbatim copy of the JAX package's
``core/dse/_surrogate_coef.py``, which is GENERATED — do not edit by hand.

The JAX package regenerates its file with::

    PYTHONPATH=src python tools/fit_surrogate.py

(deterministic: weighted least-squares init + fixed-step coordinate
descent on the 312 pinned golden rows).  Copy the new constants here;
tests/test_torch_surrogate.py holds the two files equal.
"""

BASE = (1.014725, 0.269732)

PORT = {
    "b_ntx_wr": (0.859259, -0.035347, 0.525657, 0.055742, 40.786443),
    "banked": (0.870000, 0.280000, -0.030000, -0.080000, 20.200000),
    "h_ntx_rd": (0.908945, 0.078345, -0.345638, 0.197631, 18.875282),
    "hb_ntx": (0.547926, 0.248189, 0.273793, 0.145060, 15.934971),
    "ideal": (0.180451, 0.683781, 0.144698, -0.009555, 7.505630),
    "lvt": (0.337965, 0.735357, -0.218818, -0.060000, 2.807079),
    "multipump": (0.180451, 0.683781, 0.144698, -0.009555, 7.505630),
    "remap": (1.001034, 0.003351, -0.083796, 0.264817, 14.080767),
}

INTF = {
    "b_ntx_wr": 0.100000,
    "banked": 0.170000,
    "h_ntx_rd": 0.000000,
    "hb_ntx": 0.100000,
    "ideal": 0.100000,
    "lvt": 0.100000,
    "multipump": 0.100000,
    "remap": 0.230000,
}

STALL = {
    "bank_conflict_stalls": {"banked": 0.851856, "remap": 0.698986},
    "parity_fanout_stalls": {"b_ntx_wr": 0.172040, "h_ntx_rd": 0.662117, "hb_ntx": 0.742874},
    "write_pair_stalls": {"b_ntx_wr": 0.532421, "hb_ntx": 0.395632},
}

# drift guard: the fitted stall models must cover exactly the
# scheduler's stall taxonomy (re-fit after changing STALL_KEYS)
from repro_torch.core.sim.arbiter import STALL_KEYS as _STALL_KEYS  # noqa: E402

assert set(STALL) == {f"{k}_stalls" for k in _STALL_KEYS}, \
    "surrogate STALL coefficients out of sync with STALL_KEYS; re-run " \
    "tools/fit_surrogate.py"

FIT_STATS = {
    "aes": {
        "rho": 0.9671,
        "medrel": 0.0576,
        "maxrel": 0.1112
    },
    "bfs_queue": {
        "rho": 0.9391,
        "medrel": 0.0346,
        "maxrel": 0.0879
    },
    "fft_strided": {
        "rho": 0.9715,
        "medrel": 0.0089,
        "maxrel": 0.1379
    },
    "gemm_ncubed": {
        "rho": 0.9556,
        "medrel": 0.02,
        "maxrel": 0.2143
    },
    "kmp": {
        "rho": None,
        "medrel": 0.0331,
        "maxrel": 0.0456
    },
    "md_knn": {
        "rho": 0.9578,
        "medrel": 0.0465,
        "maxrel": 0.0998
    },
    "nw": {
        "rho": 0.9381,
        "medrel": 0.1019,
        "maxrel": 0.2129
    },
    "radix_sort": {
        "rho": None,
        "medrel": 0.0808,
        "maxrel": 0.1239
    },
    "sort_merge": {
        "rho": 0.9334,
        "medrel": 0.0563,
        "maxrel": 0.1899
    },
    "spmv_crs": {
        "rho": 0.9493,
        "medrel": 0.0274,
        "maxrel": 0.1274
    },
    "stencil2d": {
        "rho": 0.9775,
        "medrel": 0.0112,
        "maxrel": 0.1463
    },
    "viterbi": {
        "rho": 0.9589,
        "medrel": 0.0112,
        "maxrel": 0.0976
    },
    "_all": {
        "n_rows": 312,
        "medrel": 0.0449,
        "maxrel": 0.2143
    }
}
