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
KERNELS = ("sae_tied_fwd", "sae_tied_bwd", "sae_tied_adam_vjp",
           "sae_untied_fwd", "sae_untied_bwd", "sae_untied_adam_vjp",
           "big_sae_fwd", "big_sae_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
ARGTYPES = {
    # the tied forward's launches (csrc/sae_tied_fwd.cu), a chunk of Z
    # members x rows batch rows at a time:
    # E, W, rows, d, stream (once a call)
    "sae_tied_fwd_norms": [_P] * 2 + [_I] * 2 + [_P],
    # x, W, b, coef_mask (or null), Ct, Z, rows, n, d, stream
    "sae_tied_fwd_codes": [_P] * 5 + [_I] * 4 + [_P],
    # Ct, W, x, r, Z, rows, n, d, B, stream
    "sae_tied_fwd_decode": [_P] * 4 + [_I] * 5 + [_P],
    # E, dW, mu, nu, lrs, bc1, bc2, E2, mu2, nu2, un_part, bias, db, mub,
    # nub, bias2, mub2, nub2, N, n, d, b1, omb1, b2, omb2, eps, stream
    "sae_tied_adam_vjp": [_P] * 18 + [_I] * 3 + [_F] * 5 + [_P],
    # E, dE, muE, nuE, D, dWn, muD, nuD, lrs, bc1, bc2, E2, muE2, nuE2, D2,
    # muD2, nuD2, un_part, N, n, d, b1, omb1, b2, omb2, eps, stream
    "sae_untied_adam_vjp": [_P] * 18 + [_I] * 3 + [_F] * 5 + [_P],
    # K8's launches, one batch chunk at a time (csrc/big_sae_fwd.cu):
    # xc, E [d, n], t, Ct, rows, n, d, stream
    "big_sae_fwd_codes": [_P] * 4 + [_I] * 3 + [_P],
    # Ct, Wn, xhat, rows, n, d, stream
    "big_sae_fwd_decode": [_P] * 3 + [_I] * 3 + [_P],
    # K9's launches, one batch chunk at a time (csrc/big_sae_bwd.cu):
    # xc, E [d, n], t, C, rows, n, d, stream
    "big_sae_bwd_codes": [_P] * 4 + [_I] * 3 + [_P],
    # r, Wn, C, alpha, G, rows, n, d, B, coef, stream
    "big_sae_bwd_dpre": [_P] * 5 + [_I] * 4 + [_F, _P],
    # xc, G, dE, rows, n, d, first, stream
    "big_sae_bwd_de": [_P] * 3 + [_I] * 4 + [_P],
    # C, r, dWn, rows, n, d, first, last, coef, stream
    "big_sae_bwd_dwn": [_P] * 3 + [_I] * 5 + [_F, _P],
    # C, G, dt, c_totals, l0f, rows, n, first, stream
    "big_sae_bwd_sums": [_P] * 5 + [_I] * 3 + [_P],
    # E, dt, c_totals, l0f, dctr, scal, n, d, stream
    "big_sae_bwd_dctr": [_P] * 6 + [_I] * 2 + [_P],
    # K8's bf16 form (csrc/big_sae_fwd.cu):
    # src, dst, count, stream (xc, E and Wn, once a call each)
    "big_sae_fwd_bf16_round": [_P] * 2 + [_LL, _P],
    # xb, Eb [d, n], t, Ctb, rows, n, d, stream
    "big_sae_fwd_bf16_codes": [_P] * 4 + [_I] * 3 + [_P],
    # Ctb, Wnb, xhat, rows, n, d, stream
    "big_sae_fwd_bf16_decode": [_P] * 3 + [_I] * 3 + [_P],
    # K9's bf16 form (csrc/big_sae_bwd.cu):
    # src, dst, count, stream (xc, E, Wn and r, once a call each)
    "big_sae_bwd_bf16_round": [_P] * 2 + [_LL, _P],
    # xb, Eb [d, n], t, C, Cb, rows, n, d, stream
    "big_sae_bwd_bf16_codes": [_P] * 5 + [_I] * 3 + [_P],
    # rb, Wnb, C, alpha, G, Gb, rows, n, d, B, coef, stream
    "big_sae_bwd_bf16_dpre": [_P] * 6 + [_I] * 4 + [_F, _P],
    # xb, Gb, dE, rows, n, d, first, stream
    "big_sae_bwd_bf16_de": [_P] * 3 + [_I] * 4 + [_P],
    # Cb, rb, dWn, rows, n, d, first, last, coef, stream
    "big_sae_bwd_bf16_dwn": [_P] * 3 + [_I] * 5 + [_F, _P],
    # C, G, Gb, dt, dtb, c_totals, l0f, rows, n, first, stream
    "big_sae_bwd_bf16_sums": [_P] * 7 + [_I] * 3 + [_P],
    # Eb, dtb, c_totals, l0f, dctr, scal, n, d, stream (once a call)
    "big_sae_bwd_bf16_dctr": [_P] * 6 + [_I] * 2 + [_P],
    # the untied forward's launches (csrc/sae_untied_fwd.cu), a chunk of
    # Z members x rows batch rows at a time:
    # D, Wn, rows, d, stream (once a call)
    "sae_untied_fwd_norms": [_P] * 2 + [_I] * 2 + [_P],
    # x, E, b, Ct, Z, rows, n, d, stream
    "sae_untied_fwd_codes": [_P] * 4 + [_I] * 4 + [_P],
    # Ct, Wn, x, r, Z, rows, n, d, B, stream
    "sae_untied_fwd_decode": [_P] * 4 + [_I] * 5 + [_P],
    # the untied backward's launches (csrc/sae_untied_bwd.cu), a chunk of
    # Z members x rows batch rows at a time:
    # D, nrm, rows, d, stream (once a call)
    "sae_untied_bwd_norms": [_P] * 2 + [_I] * 2 + [_P],
    # x, E, b, C, Z, rows, n, d, stream
    "sae_untied_bwd_codes": [_P] * 4 + [_I] * 4 + [_P],
    # r, D, nrm, C, alphas, G, Z, rows, n, d, B, TB, coef, stream
    "sae_untied_bwd_dpre": [_P] * 6 + [_I] * 6 + [_F, _P],
    # x, G, dE, Z, rows, n, d, first, stream
    "sae_untied_bwd_de": [_P] * 3 + [_I] * 5 + [_P],
    # C, r, dWn, Z, rows, n, d, B, first, last, coef, stream
    "sae_untied_bwd_dwn": [_P] * 3 + [_I] * 7 + [_F, _P],
    # C, G, db, act, csum, Z, rows, n, first, stream
    "sae_untied_bwd_sums": [_P] * 5 + [_I] * 4 + [_P],
    # r, dE, dWn, db, act, csum, alphas, part, loss4, N, B, TB, n, d, P,
    # stream
    # (once a call)
    "sae_untied_bwd_loss": [_P] * 9 + [_I] * 6 + [_P],
    # the tied backward's launches (csrc/sae_tied_bwd.cu), a chunk of Z
    # members x rows batch rows at a time:
    # E, W, rows, d, stream (once a call)
    "sae_tied_bwd_norms": [_P] * 2 + [_I] * 2 + [_P],
    # x, W, b, coef_mask (or null), C, Z, rows, n, d, stream
    "sae_tied_bwd_codes": [_P] * 5 + [_I] * 4 + [_P],
    # r, W, C, alphas, G, Z, rows, n, d, B, TB, coef, stream
    "sae_tied_bwd_dpre": [_P] * 5 + [_I] * 6 + [_F, _P],
    # x, G, dW, Z, rows, n, d, first, stream
    "sae_tied_bwd_dwx": [_P] * 3 + [_I] * 5 + [_P],
    # C, r, dW, Z, rows, n, d, B, coef, stream
    "sae_tied_bwd_dwr": [_P] * 3 + [_I] * 5 + [_F, _P],
    # C, G, db, act, csum, Z, rows, n, first, stream
    "sae_tied_bwd_sums": [_P] * 5 + [_I] * 4 + [_P],
    # r, dW, db, act, csum, alphas, part, loss4, N, B, TB, n, d, P, stream
    # (once a call)
    "sae_tied_bwd_loss": [_P] * 8 + [_I] * 6 + [_P],
    # the bf16 forms (compute_dtype="bfloat16"), in the same libraries:
    # the tied forward's (csrc/sae_tied_fwd.cu):
    # src, dst, count, stream (the fp32 batch, once a call)
    "sae_tied_fwd_bf16_round": [_P] * 2 + [_LL, _P],
    # E, Wb, rows, d, stream (once a call)
    "sae_tied_fwd_bf16_norms": [_P] * 2 + [_I] * 2 + [_P],
    # xb, Wb, b, coef_mask (or null), Ctb, Z, rows, n, d, stream
    "sae_tied_fwd_bf16_codes": [_P] * 5 + [_I] * 4 + [_P],
    # Ctb, Wb, x, x_bf16, r, Z, rows, n, d, B, stream
    "sae_tied_fwd_bf16_decode": [_P] * 3 + [_I, _P] + [_I] * 5 + [_P],
    # the untied forward's (csrc/sae_untied_fwd.cu): src, dst, count,
    # stream (the fp32 batch and the raw encoder, once a call each)
    "sae_untied_fwd_bf16_round": [_P] * 2 + [_LL, _P],
    # D, Wnb, rows, d, stream (once a call)
    "sae_untied_fwd_bf16_norms": [_P] * 2 + [_I] * 2 + [_P],
    # xb, Eb, b, Ctb, Z, rows, n, d, stream
    "sae_untied_fwd_bf16_codes": [_P] * 4 + [_I] * 4 + [_P],
    # Ctb, Wnb, x, x_bf16, r, Z, rows, n, d, B, stream
    "sae_untied_fwd_bf16_decode": [_P] * 3 + [_I, _P] + [_I] * 5 + [_P],
    # the tied backward's (csrc/sae_tied_bwd.cu): src, dst, count, stream
    # (the fp32 batch and the residual, once a call each)
    "sae_tied_bwd_bf16_round": [_P] * 2 + [_LL, _P],
    # E, Wb, rows, d, stream (once a call)
    "sae_tied_bwd_bf16_norms": [_P] * 2 + [_I] * 2 + [_P],
    # xb, Wb, b, coef_mask (or null), C, Cb, Z, rows, n, d, stream
    "sae_tied_bwd_bf16_codes": [_P] * 6 + [_I] * 4 + [_P],
    # rb, Wb, C, alphas, G, Gb, Z, rows, n, d, B, TB, coef, stream
    "sae_tied_bwd_bf16_dpre": [_P] * 6 + [_I] * 6 + [_F, _P],
    # xb, Gb, dW, Z, rows, n, d, first, stream
    "sae_tied_bwd_bf16_dwx": [_P] * 3 + [_I] * 5 + [_P],
    # Cb, rb, dW, Z, rows, n, d, B, coef, stream
    "sae_tied_bwd_bf16_dwr": [_P] * 3 + [_I] * 5 + [_F, _P],
    # C, G, db, act, csum, Z, rows, n, first, stream
    "sae_tied_bwd_bf16_sums": [_P] * 5 + [_I] * 4 + [_P],
    # r, dW, db, act, csum, alphas, part, loss4, N, B, TB, n, d, P, stream
    "sae_tied_bwd_bf16_loss": [_P] * 8 + [_I] * 6 + [_P],
    # the untied backward's (csrc/sae_untied_bwd.cu): src, dst, count,
    # stream (the fp32 batch, the raw encoder and the residual)
    "sae_untied_bwd_bf16_round": [_P] * 2 + [_LL, _P],
    # D, Wnb, rows, d, stream (once a call)
    "sae_untied_bwd_bf16_norms": [_P] * 2 + [_I] * 2 + [_P],
    # xb, Eb, b, C, Cb, Z, rows, n, d, stream
    "sae_untied_bwd_bf16_codes": [_P] * 5 + [_I] * 4 + [_P],
    # rb, Wnb, C, alphas, G, Gb, Z, rows, n, d, B, TB, coef,
    # stream
    "sae_untied_bwd_bf16_dpre": [_P] * 6 + [_I] * 6 + [_F, _P],
    # xb, Gb, dE, Z, rows, n, d, first, stream
    "sae_untied_bwd_bf16_de": [_P] * 3 + [_I] * 5 + [_P],
    # Cb, rb, dWn, Z, rows, n, d, B, first, last, coef, stream
    "sae_untied_bwd_bf16_dwn": [_P] * 3 + [_I] * 7 + [_F, _P],
    # C, G, db, act, csum, Z, rows, n, first, stream
    "sae_untied_bwd_bf16_sums": [_P] * 5 + [_I] * 4 + [_P],
    # r, dE, dWn, db, act, csum, alphas, part, loss4, N, B, TB, n, d, P,
    # stream
    "sae_untied_bwd_bf16_loss": [_P] * 9 + [_I] * 6 + [_P],
    # the Adam epilogues with bf16 moments (fused_moments_dtype=
    # "bfloat16"): the fp32 ones' arguments, mu/nu in and out bf16
    "sae_tied_adam_vjp_bf16": [_P] * 18 + [_I] * 3 + [_F] * 5 + [_P],
    "sae_untied_adam_vjp_bf16": [_P] * 18 + [_I] * 3 + [_F] * 5 + [_P],
}
# The bf16 forms, each named after its kernel with "_bf16" (bf16 compute
# for the six chunked kernels, bf16 moments for the two Adam epilogues),
# and the library that holds it: its fp32 kernel's.
BF16_FORMS = {f"{name}_bf16": name for name in (
    "sae_tied_fwd", "sae_tied_bwd", "sae_untied_fwd", "sae_untied_bwd",
    "sae_tied_adam_vjp", "sae_untied_adam_vjp", "big_sae_fwd",
    "big_sae_bwd")}


def _parts(kernel: str) -> tuple[str, ...]:
    """The entry points of a chunked kernel (or bf16 form): the names that
    start with its own, less those of its bf16 form."""
    return tuple(name for name in ARGTYPES
                 if name.startswith(kernel + "_")
                 and not name.startswith(kernel + "_bf16_"))


# The library of each entry point: the chunked kernel's whose launch it
# is — K8's parts big_sae_fwd's, K9's big_sae_bwd's, and each ensemble
# kernel's parts (named after it, the bf16 form's too) its own — or its
# own name.
BIG_FWD_PARTS = _parts("big_sae_fwd")
BWD_PARTS = _parts("big_sae_bwd")
TIED_FWD_PARTS = _parts("sae_tied_fwd")
TIED_BWD_PARTS = _parts("sae_tied_bwd")
UNTIED_FWD_PARTS = _parts("sae_untied_fwd")
UNTIED_BWD_PARTS = _parts("sae_untied_bwd")
TIED_FWD_BF16_PARTS = _parts("sae_tied_fwd_bf16")
TIED_BWD_BF16_PARTS = _parts("sae_tied_bwd_bf16")
UNTIED_FWD_BF16_PARTS = _parts("sae_untied_fwd_bf16")
UNTIED_BWD_BF16_PARTS = _parts("sae_untied_bwd_bf16")
BIG_FWD_BF16_PARTS = _parts("big_sae_fwd_bf16")
BWD_BF16_PARTS = _parts("big_sae_bwd_bf16")
_PARTS = {"big_sae_fwd": BIG_FWD_PARTS, "big_sae_bwd": BWD_PARTS,
          "big_sae_fwd_bf16": BIG_FWD_BF16_PARTS,
          "big_sae_bwd_bf16": BWD_BF16_PARTS,
          "sae_tied_fwd": TIED_FWD_PARTS, "sae_tied_bwd": TIED_BWD_PARTS,
          "sae_untied_fwd": UNTIED_FWD_PARTS,
          "sae_untied_bwd": UNTIED_BWD_PARTS,
          "sae_tied_fwd_bf16": TIED_FWD_BF16_PARTS,
          "sae_tied_bwd_bf16": TIED_BWD_BF16_PARTS,
          "sae_untied_fwd_bf16": UNTIED_FWD_BF16_PARTS,
          "sae_untied_bwd_bf16": UNTIED_BWD_BF16_PARTS}


def _library(name: str) -> str:
    kernel = next((k for k, parts in _PARTS.items() if name in parts), name)
    return BF16_FORMS.get(kernel, kernel)


LIBRARY_OF = {name: _library(name) for name in ARGTYPES}

# Launch counts, one plain integer per kernel and per launch of a chunked
# kernel: each wrapper adds one where it launches its kernel and nowhere
# else, so a run can show that the main path went through the kernels.
# The six chunked kernels (big_sae_fwd, big_sae_bwd, sae_tied_fwd,
# sae_tied_bwd, sae_untied_fwd, sae_untied_bwd) count calls of their
# contracts under their own names (fused_big_sae.big_sae_forward and
# big_sae_backward; fused_sae_tiled.sae_tied_fwd, ...), each of which
# launches its parts (_PARTS) once per chunk — the norm passes, the
# backwards' loss and K9's dctr once a call. The bf16 forms count under
# their own names (BF16_FORMS), the chunked ones' calls and parts as
# theirs (the rounding passes once per rounded tensor of a call).
# reset_launches() zeroes them.
LAUNCHES: dict[str, int] = {name: 0 for name in (
    *KERNELS, *BF16_FORMS,
    *(part for parts in _PARTS.values() for part in parts))}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# The kernels' shape contract (csrc/sae_common.cuh): the batch and the
# feature count must divide by these (a chunk's rows are multiples of the
# batch tile), and d must not exceed MAX_D (the ensemble kernels) or
# BIG_MAX_D (the big-SAE kernels).
BATCH_TILE = 32
FEAT_TILE = 32
ADAM_ROWS = 8
MAX_D = 4096
# the bf16 forms' tensor-core product copies 8 bf16 values at a time along
# every operand's contiguous dimension, d among them
BF16_D_MULTIPLE = 8
BIG_BATCH_TILE = 32
BIG_FEAT_TILE = 32
BIG_MAX_D = MAX_D  # csrc/sae_common.cuh kBigMaxD = kMaxD


def check_cuda_tensors(name: str, bf16_ok: tuple = (), **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one
    CUDA device — all the kernels take — or, for the arguments named in
    ``bf16_ok``, a bfloat16 one."""
    devices = set()
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not cuda")
        if t.dtype != torch.float32 and not (
                arg in bf16_ok and t.dtype == torch.bfloat16):
            raise ValueError(f"{name}: {arg} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def kernel_shapes(compute_dtype: str = "float32") -> str:
    """The shapes the ensemble kernels take, as an error message says
    them."""
    rule = (f"batch % {BATCH_TILE} == 0, n_feats % {FEAT_TILE} == 0 and "
            f"1 <= d <= {MAX_D}")
    if compute_dtype == "bfloat16":
        rule += f" (bf16 compute: d % {BF16_D_MULTIPLE} == 0)"
    return rule


def check_kernel_shape(name: str, batch: int, n_feats: int, d: int,
                       compute_dtype: str = "float32") -> None:
    """Raise ValueError for a shape the fwd/bwd kernels' blocking does not
    take (the plain versions take any shape); the bf16 forms also need
    d % BF16_D_MULTIPLE == 0."""
    if batch % BATCH_TILE or n_feats % FEAT_TILE or not 1 <= d <= MAX_D:
        raise ValueError(
            f"{name}: the CUDA kernel needs {kernel_shapes()}; got "
            f"batch={batch}, n_feats={n_feats}, d={d}")
    if compute_dtype == "bfloat16" and d % BF16_D_MULTIPLE:
        raise ValueError(
            f"{name}: the bf16 CUDA kernel needs d % {BF16_D_MULTIPLE} == 0; "
            f"got d={d}")


def check_big_shape(name: str, batch: int, n_feats: int, d: int,
                    compute_dtype: str = "float32") -> None:
    """Raise ValueError for a shape the big-SAE kernels do not take; their
    bf16 forms also need d % BF16_D_MULTIPLE == 0."""
    if (batch % BIG_BATCH_TILE or n_feats % BIG_FEAT_TILE
            or not 1 <= d <= BIG_MAX_D):
        raise ValueError(
            f"{name}: the CUDA kernel needs batch % {BIG_BATCH_TILE} == 0, "
            f"n_feats % {BIG_FEAT_TILE} == 0 and 1 <= d <= {BIG_MAX_D}; got "
            f"batch={batch}, n_feats={n_feats}, d={d}")
    if compute_dtype == "bfloat16" and d % BF16_D_MULTIPLE:
        raise ValueError(
            f"{name}: the bf16 CUDA kernel needs d % {BF16_D_MULTIPLE} == 0; "
            f"got d={d}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


# nvcc processes this process started (a warm restart starts none)
NVCC_RUNS = 0


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
    global NVCC_RUNS
    out = BUILD_ROOT / build_key()
    out.mkdir(parents=True, exist_ok=True)
    missing = [name for name in KERNELS
               if not (out / f"lib{name}.so").exists()]
    nvcc = _nvcc() if missing else ""
    procs = {}
    for name in missing:
        lib = out / f"lib{name}.so"
        tmp = out / f".lib{name}.so.tmp.{os.getpid()}"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
        NVCC_RUNS += 1
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
    """The loaded library of one kernel source, building all of them
    first if needed. Every C entry point returns its cudaError_t as an
    int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = build_all()
            for kname in KERNELS:
                if kname not in _libs:
                    _libs[kname] = ctypes.CDLL(str(out / f"lib{kname}.so"))
            for entry, kname in LIBRARY_OF.items():
                fn = getattr(_libs[kname], entry)
                fn.argtypes = ARGTYPES[entry]
                fn.restype = ctypes.c_int
            lib = _libs[name]
        return lib


def launch(name: str, *args) -> None:
    """Call one C entry point (a kernel's, or one of a chunked kernel's
    parts: BIG_FWD_PARTS, BWD_PARTS, TIED_FWD_PARTS, TIED_BWD_PARTS,
    UNTIED_FWD_PARTS, UNTIED_BWD_PARTS and the bf16 forms' *_BF16_PARTS),
    raise on a non-zero cudaError_t, and count the launch. A refused
    launch (too much shared memory, a bad configuration) shows only here:
    torch.cuda.synchronize() would not report it."""
    rc = getattr(library(LIBRARY_OF[name]), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
