"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Builds happen at first use, all sources at once in
parallel, into ``ops/_build/<hash>/`` — the hash covers every source,
header and flag, so an edited kernel never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
KERNELS = ("sae_tied_fwd", "sae_tied_bwd", "sae_tied_adam_vjp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ARGTYPES = {
    # x, E, b, r, N, B, n, d, stream
    "sae_tied_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, r, E, b, alphas, dw, db, act, part, N, B, n, d, coef, stream
    "sae_tied_bwd": [_P] * 9 + [_I] * 4 + [_F, _P],
    # E, dW, mu, nu, lrs, bc1, bc2, E2, mu2, nu2, un_part, bias, db, mub,
    # nub, bias2, mub2, nub2, N, n, d, b1, omb1, b2, omb2, eps, stream
    "sae_tied_adam_vjp": [_P] * 18 + [_I] * 3 + [_F] * 5 + [_P],
}

# Launch counts, one plain integer per kernel: each wrapper adds one where
# it launches its kernel and nowhere else, so a run can show that the main
# path went through the kernels. reset_launches() zeroes them.
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# The kernels' fixed blocking (csrc/sae_common.cuh): the batch and the
# feature count must divide by these, and d must not exceed MAX_D.
BATCH_TILE = 32
FEAT_TILE = 32
ADAM_ROWS = 8
MAX_D = 768


def check_cuda_tensors(name: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one
    CUDA device — all the kernels take."""
    devices = set()
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not cuda")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def check_kernel_shape(name: str, batch: int, n_feats: int, d: int) -> None:
    """Raise ValueError for a shape the fwd/bwd kernels' blocking does not
    take (the plain versions take any shape)."""
    if batch % BATCH_TILE or n_feats % FEAT_TILE or not 1 <= d <= MAX_D:
        raise ValueError(
            f"{name}: the CUDA kernel needs batch % {BATCH_TILE} == 0, "
            f"n_feats % {FEAT_TILE} == 0 and 1 <= d <= {MAX_D}; got "
            f"batch={batch}, n_feats={n_feats}, d={d}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns the build directory; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<name>.log``."""
    out = BUILD_ROOT / build_key()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in KERNELS:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f".lib{name}.so.tmp.{os.getpid()}"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        try:
            rc = proc.wait()
        finally:
            log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (exit {rc}):\n"
                          + (out / f"{name}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all of them first if
    needed. Every C entry point returns its cudaError_t as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = build_all()
            for kname in KERNELS:
                if kname not in _libs:
                    loaded = ctypes.CDLL(str(out / f"lib{kname}.so"))
                    fn = getattr(loaded, kname)
                    fn.argtypes = ARGTYPES[kname]
                    fn.restype = ctypes.c_int
                    _libs[kname] = loaded
            lib = _libs[name]
        return lib


def launch(name: str, *args) -> None:
    """Call one kernel's C entry point, raise on a non-zero cudaError_t,
    and count the launch. A refused launch (too much shared memory, a bad
    configuration) shows only here: torch.cuda.synchronize() would not
    report it."""
    rc = getattr(library(name), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
