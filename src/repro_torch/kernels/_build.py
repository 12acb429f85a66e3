"""Build, load and guard the hand-written CUDA kernels.

Every kernel source ``csrc/<name>.cu`` exposes a plain C interface and
is compiled by nvcc into its own shared library for Hopper
(``sm_90a``), then loaded with ``ctypes``.  Libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of
the source, so a second run reuses them and an edited source builds
anew.  ``build_all`` starts one nvcc per missing library, all at once,
and waits for them.  nvcc runs with ``-Xptxas -v``; its log (each
kernel's registers, shared memory and spill bytes) is kept beside the
library and read back by ``ptxas_report``.

Nothing here falls back: a failed build, a failed load or a launch
error raises.  The CPU tests never reach this module's build path,
because a wrapper given a CPU tensor takes its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
KERNELS = ("amm_gather", "banked_kv_decode", "ssd_scan", "cycle_lanes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the "
                           "CUDA kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by the hash
    of the source and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> pathlib.Path:
    """nvcc's log of the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log")


def ptxas_report(name: str) -> "list[dict]":
    """Registers, shared memory and spill bytes of every kernel in the
    library of ``csrc/<name>.cu``, parsed from its ``-Xptxas -v`` log:
    one dict per entry function (``name`` is the mangled symbol)."""
    found, cur = [], None
    for line in log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1), "registers": None, "smem": 0,
                   "spill_stores": None, "spill_loads": None}
            found.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return found


def nvcc_command(nvcc: str, src: pathlib.Path, out: pathlib.Path
                 ) -> "list[str]":
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all(names: "tuple[str, ...]" = KERNELS) -> float:
    """Build every library in ``names`` that is not built yet, one nvcc
    process each, all started together.  Returns the wall seconds."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(nvcc, CSRC / f"{n}.cu", tmp)
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
        else:
            log_path(n).write_text(log)
            os.replace(tmp, out)      # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({msg})")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_tensor(name: str, t: torch.Tensor, device: torch.device,
                 dtypes: "tuple[torch.dtype, ...]",
                 shape: "tuple[int, ...]") -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` with one
    of ``dtypes`` and exactly ``shape``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dispatch(*tensors: torch.Tensor) -> str:
    """'cuda' when every tensor is on one CUDA device, 'cpu' when all
    are on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return "cuda"
    raise ValueError("kernel inputs must all be on the CPU or all on one "
                     f"CUDA device, got {[str(t.device) for t in tensors]}")
