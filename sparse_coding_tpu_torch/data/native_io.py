"""ctypes bindings for the native chunk-IO library (the port's copy of the
JAX package's ``data/native_io.py``).

The library is the repository's ``native/chunkio.cpp`` (threaded
``pread`` into a caller-owned buffer, and a background prefetch handle),
compiled with ``g++`` at first use into the port's own build directory,
``ops/_build/chunkio-<hash>/`` — never into ``native/``. The hash covers
the source and the flags, so an edited source never loads a stale
library. Without a compiler the readers use ``np.load``, which returns
the same bytes: the native layer is an acceleration of the host reads,
never a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ops._build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parents[2] / "native" / "chunkio.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _usable_cpus() -> int:
    """Cores this process may run on (cgroup and taskset pinning
    respected): threaded pread only pays with real cores to spread over."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


DEFAULT_THREADS = max(1, min(8, _usable_cpus()))


def fast_astype(raw: np.ndarray, dtype) -> np.ndarray:
    """``raw.astype(dtype)`` with the float16/bfloat16 → float32 widening
    through torch's vectorized casts (numpy's are scalar loops, slower than
    the disk read they follow). Widening casts are exact, so the result
    equals ``astype``."""
    dtype = np.dtype(dtype)
    if dtype != np.float32 or raw.dtype == np.float32:
        return raw.astype(dtype)
    if raw.dtype == np.float16:
        src = torch.from_numpy(_torch_ready(raw))
    elif raw.dtype.itemsize == 2 and raw.dtype.name == "bfloat16":
        src = torch.from_numpy(_torch_ready(raw).view(np.int16)).view(
            torch.bfloat16)
    else:
        return raw.astype(dtype)
    return src.to(torch.float32).numpy()


def _torch_ready(a: np.ndarray) -> np.ndarray:
    # torch.from_numpy needs a writable C-contiguous buffer (a read-only
    # mmap or a strided view is neither): one host copy keeps the
    # vectorized cast
    if a.flags.c_contiguous and a.flags.writeable:
        return a
    return a.copy()


def library_path() -> Path:
    """Where this source and these flags build to."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"chunkio-{h.hexdigest()[:16]}" / "libchunkio.so"


def _build(lib_path: Path) -> bool:
    """Compile the library with the JAX loader's flags. The output is
    renamed into place, so processes building at once never load a
    half-written file."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.parent / f".{lib_path.name}.tmp.{os.getpid()}"
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib_path)
        return True
    except (subprocess.CalledProcessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib_path = library_path()
        except OSError:  # no source in this checkout
            _lib_failed = True
            return None
        if not lib_path.exists() and not _build(lib_path):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            _lib_failed = True
            return None
        lib.chunkio_read.restype = ctypes.c_int64
        lib.chunkio_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int]
        lib.chunkio_file_size.restype = ctypes.c_int64
        lib.chunkio_file_size.argtypes = [ctypes.c_char_p]
        lib.chunkio_prefetch_start.restype = ctypes.c_void_p
        lib.chunkio_prefetch_start.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int]
        lib.chunkio_prefetch_wait.restype = ctypes.c_int64
        lib.chunkio_prefetch_wait.argtypes = [ctypes.c_void_p]
        lib.chunkio_prefetch_cancel.restype = None
        lib.chunkio_prefetch_cancel.argtypes = [ctypes.c_void_p]
        lib.chunkio_prefetch_poll.restype = ctypes.c_int
        lib.chunkio_prefetch_poll.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _npy_header(path: Path) -> tuple[np.dtype, tuple, int]:
    """A .npy file's (dtype, shape, payload offset), parsed by np.load
    itself through a read-only map (numpy's header reader is private, and
    its module moved between releases). A malformed header or a payload
    shorter than the header promises raises ValueError (or EOFError)."""
    arr = np.load(path, mmap_mode="r")
    if np.isfortran(arr):
        raise ValueError(f"{path}: fortran-order arrays unsupported")
    return arr.dtype, arr.shape, int(arr.offset)


def read_npy_native(path: str | Path,
                    nthreads: int = DEFAULT_THREADS) -> Optional[np.ndarray]:
    """Threaded read of a .npy file; None when the library is missing or
    the payload is short (the caller then reads with np.load, which types
    the failure)."""
    lib = get_lib()
    if lib is None:
        return None
    path = Path(path)
    dtype, shape, offset = _npy_header(path)
    out = np.empty(shape, dtype)
    n = lib.chunkio_read(str(path).encode(),
                         out.ctypes.data_as(ctypes.c_char_p), offset,
                         out.nbytes, nthreads)
    return out if n == out.nbytes else None


class NativePrefetcher:
    """Background prefetch of one chunk file into a numpy buffer this
    object owns (zero copy): ``start(path)`` while the current chunk
    trains, ``wait()`` for the array."""

    def __init__(self, nthreads: int = DEFAULT_THREADS):
        self.nthreads = nthreads
        self._handle = None
        self._buffer: Optional[np.ndarray] = None  # kept alive for C
        self._size = 0

    def start(self, path: str | Path) -> bool:
        lib = get_lib()
        if lib is None or self._handle is not None:
            return False
        path = Path(path)
        dtype, shape, offset = _npy_header(path)
        out = np.empty(shape, dtype)
        handle = lib.chunkio_prefetch_start(
            str(path).encode(), out.ctypes.data_as(ctypes.c_char_p), offset,
            out.nbytes, self.nthreads)
        if not handle:
            return False
        self._handle, self._buffer, self._size = handle, out, out.nbytes
        return True

    def poll(self) -> Optional[bool]:
        """True when ``wait()`` will not block, False while the read is in
        flight, None with nothing in flight."""
        if self._handle is None:
            return None
        return bool(get_lib().chunkio_prefetch_poll(
            ctypes.c_void_p(self._handle)))

    def wait(self) -> Optional[np.ndarray]:
        """The prefetched array, or None (nothing in flight, or a short
        read)."""
        if self._handle is None:
            return None
        n = get_lib().chunkio_prefetch_wait(ctypes.c_void_p(self._handle))
        out = self._buffer if n == self._size else None
        self._handle, self._buffer, self._size = None, None, 0
        return out

    def cancel(self) -> None:
        """Abandon the read in flight (joins its threads, so the buffer
        outlives every write into it)."""
        if self._handle is not None:
            get_lib().chunkio_prefetch_cancel(ctypes.c_void_p(self._handle))
            self._handle, self._buffer, self._size = None, None, 0

    def __del__(self):  # last-resort guard against a leaked read
        try:
            self.cancel()
        except Exception:
            pass
