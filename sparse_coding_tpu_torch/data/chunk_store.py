"""Chunked on-disk activation store with device prefetch (the JAX
package's ``data/chunk_store.py``).

Same on-disk format, so each side reads what the other wrote: chunk files
``0.npy, 1.npy, …`` (float16/float32, or bfloat16 stored as its uint16 bit
pattern), an optional ``center.npy``, and ``meta.json`` — written last,
atomically — with ``activation_dim``, ``dtype``, ``n_chunks``,
``centered`` and the per-chunk sha256 ``chunk_digests``. The same
``(batch_size, np.random.default_rng(seed))`` yields the same batch
sequence on both sides.

``device_prefetch`` keeps the card fed: pinned host buffers copied with
``non_blocking=True`` on a side CUDA stream, so batch i+1 crosses PCIe
while batch i computes.
"""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_save_npy,
    atomic_write_text,
)
from sparse_coding_tpu_torch.resilience.manifest import array_sha256

_DTYPES = ("float16", "float32", "bfloat16")


def _to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float → bfloat16 (round to nearest even), as uint16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).to(torch.float32).numpy()


class ChunkCorruptionError(ValueError):
    """A chunk failed its integrity check (digest mismatch, non-finite
    rows, or an unreadable file)."""

    def __init__(self, chunk_index: int, path: Path, reason: str):
        super().__init__(f"chunk {chunk_index} ({path}): {reason}")
        self.chunk_index, self.path, self.reason = chunk_index, path, reason


class ChunkWriter:
    """Accumulates [n, d] activation slabs and flushes ~chunk_size_gb
    files. ``center=True`` subtracts the first flushed chunk's mean from
    every chunk (``center.npy`` keeps it)."""

    def __init__(self, folder: str | Path, activation_dim: int,
                 chunk_size_gb: float = 2.0, dtype: str = "bfloat16",
                 center: bool = False):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.activation_dim = activation_dim
        self.dtype = dtype
        itemsize = 4 if dtype == "float32" else 2
        self.rows_per_chunk = int(chunk_size_gb * 2**30
                                  / (activation_dim * itemsize))
        self._buffer: list[np.ndarray] = []
        self._buffered_rows = 0
        self._digests: dict[str, str] = {}
        self.chunk_index = 0
        self.center = center
        self._center_mean: Optional[np.ndarray] = None

    def add(self, acts) -> None:
        if isinstance(acts, torch.Tensor):
            acts = acts.detach().to("cpu", torch.float32).numpy()
        arr = np.asarray(acts).reshape(-1, self.activation_dim)
        self._buffer.append(arr)
        self._buffered_rows += arr.shape[0]
        while self._buffered_rows >= self.rows_per_chunk:
            flat = np.concatenate(self._buffer, axis=0)
            self._write(flat[:self.rows_per_chunk])
            rest = flat[self.rows_per_chunk:]
            self._buffer = [rest] if rest.size else []
            self._buffered_rows = rest.shape[0]

    def _encode(self, f32: np.ndarray) -> np.ndarray:
        if self.dtype == "bfloat16":
            return _to_bf16_bits(f32)
        return f32.astype(self.dtype)

    def _write(self, arr: np.ndarray) -> None:
        if self.center:
            if self._center_mean is None:
                # the JAX writer takes the mean of the ON-DISK-dtype chunk
                f32 = self._decoded(self._encode(arr))
                self._center_mean = f32.mean(axis=0)
            arr = self._decoded(self._encode(arr)) - self._center_mean
        out = self._encode(arr)
        atomic_save_npy(self.folder / f"{self.chunk_index}.npy", out)
        self._digests[str(self.chunk_index)] = array_sha256(out)
        self.chunk_index += 1

    def _decoded(self, raw: np.ndarray) -> np.ndarray:
        if self.dtype == "bfloat16":
            return _from_bf16_bits(raw)
        return raw.astype(np.float32)

    def finalize(self, metadata: Optional[dict] = None) -> int:
        """Flush the tail and write meta.json (last, atomically — its
        presence certifies a complete store). Returns the chunk count."""
        if self._buffered_rows:
            self._write(np.concatenate(self._buffer, axis=0))
            self._buffer, self._buffered_rows = [], 0
        if self._center_mean is not None:
            atomic_save_npy(self.folder / "center.npy", self._center_mean)
        centered = self.center and self._center_mean is not None
        meta = {"activation_dim": self.activation_dim,
                "dtype": self.dtype,
                "n_chunks": self.chunk_index,
                "centered": centered,
                "chunk_digests": dict(self._digests),
                **({"center_format": "subtracted-v2"} if centered else {})}
        meta.update(metadata or {})
        atomic_write_text(self.folder / "meta.json", json.dumps(meta, indent=2))
        return self.chunk_index


class ChunkStore:
    """Reader over a flat chunk folder: digest- and finite-checked loads,
    shuffled epochs. Quarantine of corrupt chunks and native readahead
    are later work; a corrupt chunk raises :class:`ChunkCorruptionError`."""

    def __init__(self, folder: str | Path, verify_digests: bool = True,
                 verify_finite: bool = True):
        self.folder = Path(folder)
        meta_path = self.folder / "meta.json"
        self.meta = (json.loads(meta_path.read_text())
                     if meta_path.exists() else {})
        self._paths = {int(p.stem): p for p in self.folder.glob("*.npy")
                       if p.stem.isdigit()}
        if not self._paths:
            raise FileNotFoundError(f"no .npy chunks in {self.folder}")
        declared = self.meta.get("n_chunks")
        self._n_chunks = (int(declared) if declared is not None
                          else max(self._paths) + 1)
        self.verify_digests = verify_digests
        self.verify_finite = verify_finite
        self._verified: set[int] = set()
        first = np.load(self._paths[min(self._paths)], mmap_mode="r")
        self.activation_dim = int(first.shape[-1])

    @property
    def n_chunks(self) -> int:
        return self._n_chunks

    @property
    def center(self) -> Optional[np.ndarray]:
        path = self.folder / "center.npy"
        return np.load(path) if path.exists() else None

    def load_chunk(self, i: int, dtype=np.float32) -> np.ndarray:
        path = self._paths.get(int(i))
        if path is None:
            raise ChunkCorruptionError(int(i), self.folder / f"{i}.npy",
                                       "chunk file missing")
        try:
            raw = np.load(path)
        except (ValueError, EOFError) as e:
            raise ChunkCorruptionError(int(i), path,
                                       f"unreadable npy: {e}") from e
        if int(i) not in self._verified:
            expected = (self.meta.get("chunk_digests") or {}).get(str(i))
            if self.verify_digests and expected is not None:
                got = array_sha256(raw)
                if got != expected:
                    raise ChunkCorruptionError(
                        int(i), path, f"content digest mismatch "
                        f"({got[:12]}… != {expected[:12]}…)")
        if raw.dtype == np.uint16:
            if self.meta.get("dtype") != "bfloat16":
                raise ValueError(f"{path} holds uint16 (bfloat16 bit "
                                 "patterns) but meta.json lacks "
                                 "dtype=bfloat16")
            out = _from_bf16_bits(raw)
        else:
            out = raw.astype(np.float32)
        if self.verify_finite and int(i) not in self._verified:
            if not np.isfinite(out).all():
                raise ChunkCorruptionError(int(i), path,
                                           "non-finite values in decoded rows")
        self._verified.add(int(i))
        return out.astype(dtype, copy=False)

    def chunk_mean(self, i: int = 0) -> np.ndarray:
        return self.load_chunk(i).mean(axis=0)

    def epoch(self, batch_size: int, rng: np.random.Generator,
              n_repetitions: int = 1, dtype=np.float32) -> Iterator[np.ndarray]:
        """Batches over all chunks, chunk order shuffled per repetition —
        the same rng draws, in the same order, as the JAX store."""
        order = np.concatenate([rng.permutation(self.n_chunks)
                                for _ in range(n_repetitions)])
        for ci in order:
            yield from shuffled_batches(self.load_chunk(int(ci), dtype),
                                        batch_size, rng)


def shuffled_batches(chunk: np.ndarray, batch_size: int,
                     rng: np.random.Generator,
                     drop_last: bool = True) -> Iterator[np.ndarray]:
    """Shuffled fixed-size batches over an in-RAM array."""
    n = chunk.shape[0]
    perm = rng.permutation(n)
    end = n - (n % batch_size) if drop_last else n
    for lo in range(0, end, batch_size):
        yield chunk[perm[lo:lo + batch_size]]


def window_stacks(batches: Iterable[np.ndarray], k: int) -> Iterator[np.ndarray]:
    """Group [B, d] host batches into [K, B, d] stacks; the final short
    window flushes with however many batches remain."""
    buf: list[np.ndarray] = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def device_prefetch(batches: Iterable[np.ndarray], device,
                    buffer_size: int = 2) -> Iterator[torch.Tensor]:
    """Host → device pipeline. On CUDA: each batch is staged in pinned host
    memory and copied with ``non_blocking=True`` on a side stream, up to
    ``buffer_size`` copies in flight; the consumer's stream waits on the
    copy's event before it sees the tensor. On the CPU: plain tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield torch.as_tensor(np.ascontiguousarray(b), device=device)
        return
    side = torch.cuda.Stream(device)
    pending: deque = deque()
    it = iter(batches)

    def submit(b) -> None:
        host = torch.from_numpy(np.ascontiguousarray(b)).pin_memory()
        with torch.cuda.stream(side):
            dev = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        pending.append((dev, done))

    for b in it:
        submit(b)
        if len(pending) >= buffer_size:
            break
    while pending:
        dev, done = pending.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        dev.record_stream(compute)
        nxt = next(it, None)
        if nxt is not None:
            submit(nxt)
        yield dev
