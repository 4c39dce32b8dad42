"""Chunked on-disk activation store with device prefetch (the JAX
package's ``data/chunk_store.py``).

Same on-disk format, so each side reads what the other wrote: chunk files
``0.npy, 1.npy, …`` (float16/float32, or bfloat16 stored as its uint16 bit
pattern), an optional ``center.npy``, and ``meta.json`` — written last,
atomically — with ``activation_dim``, ``dtype``, ``n_chunks``,
``centered`` and the per-chunk sha256 ``chunk_digests``. The same
``(batch_size, np.random.default_rng(seed))`` yields the same batch
sequence on both sides.

``ChunkStore(quarantine_corrupt=True)`` trains through corrupt chunks:
``chunk_reader`` yields None in a corrupt chunk's position (``epoch``
skips it) with a single warning and records it in the durable quarantine
ledger (``data/ledger.py``), which the next open reads, so a known-bad
chunk is never read again. Without it they raise, and ``load_chunk``
always raises.

``load_chunk(i, dtype=torch.bfloat16)`` (the sweep's
``train_dtype="bfloat16"``) returns a bfloat16 host tensor: numpy has no
bfloat16, and the batches keep half width through the host→device copy.
Every other dtype gives a numpy array.

Fault sites ``chunk.read`` (every load, the raw payload) and
``chunk.write`` (every flush, inside a bounded retry); crash barriers
``chunk.flushed`` (a chunk durable) and ``store.finalize`` (every chunk
durable, meta.json not yet written).

Reads go through the native chunk-IO library (``data/native_io.py``, the
repository's ``native/chunkio.cpp``): ``load_chunk`` reads with threaded
``pread`` when the process has more than one core, and the serial
``chunk_reader`` reads the next chunk on background threads while the
current one trains. Without the library both read with ``np.load``, the
same bytes. The counter ``data.chunk_reads`` (labelled ``path=native``,
``prefetch`` or ``numpy``) records which path served each read.

``device_prefetch`` is ``data/ingest.py::device_batches``, the
host→device stage.

A folder of the reference's torch-saved ``<i>.pt`` chunks opens too
(``format="pt"``, read through ``utils/ref_interop.py::read_pt_chunk``,
finite-checked, without native readahead); ``import_reference_chunks``
converts one to ``.npy`` chunks when read throughput matters.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.data.ingest import (
    device_batches as device_prefetch,
)
from sparse_coding_tpu_torch.data.ledger import (
    load_quarantine,
    record_quarantine,
)
from sparse_coding_tpu_torch.data.native_io import (
    DEFAULT_THREADS,
    NativePrefetcher,
    read_npy_native,
)
from sparse_coding_tpu_torch.resilience import lease
from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_save_npy,
    atomic_write_text,
)
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
# the error's home is resilience/errors.py; importing it from here works too
from sparse_coding_tpu_torch.resilience.errors import ChunkCorruptionError
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.resilience.manifest import array_sha256
from sparse_coding_tpu_torch.resilience.retry import retry_io

__all__ = ["ChunkCorruptionError", "ChunkStore", "ChunkWriter",
           "device_prefetch", "shuffled_batches", "window_stacks"]

_DTYPES = ("float16", "float32", "bfloat16")
logger = logging.getLogger(__name__)

register_fault_site("chunk.read",
                    "ChunkStore._finish_raw — every chunk load, the native, "
                    "prefetched and numpy reads alike")
register_fault_site("chunk.write",
                    "ChunkWriter._write — every chunk flush (inside the "
                    "bounded-retry scope)")
register_crash_site("chunk.flushed",
                    "ChunkWriter._write — a chunk file + digest just became "
                    "durable; the next instruction never runs")
register_crash_site("store.finalize",
                    "ChunkWriter.finalize — all chunks durable, meta.json "
                    "(the completeness marker) not yet written")


def _to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float → bfloat16 (round to nearest even), as uint16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).to(torch.float32).numpy()


# transient I/O errors on a chunk write or read get this many tries
IO_RETRIES = 3


def _count_read(path: str) -> None:
    obs.counter("data.chunk_reads", path=path).inc()


def chunk_rows(activation_dim: int, chunk_size_gb: float, dtype: str,
               round_rows_to: int = 1) -> int:
    """Rows a :class:`ChunkWriter` puts in each chunk: ``chunk_size_gb`` of
    ``dtype`` rows, rounded down to a multiple of ``round_rows_to`` (at
    least one multiple)."""
    itemsize = 4 if dtype == "float32" else 2
    rows = int(chunk_size_gb * 2**30 / (activation_dim * itemsize))
    if round_rows_to > 1:
        rows = max(round_rows_to, rows // round_rows_to * round_rows_to)
    return rows


class ChunkWriter:
    """Accumulates [n, d] activation slabs and flushes ~chunk_size_gb
    files. ``center=True`` subtracts the first flushed chunk's mean from
    every chunk (``center.npy`` keeps it).

    ``start_index`` resumes a harvest past its first chunks (the JAX
    ``skip_chunks``): numbering starts there, the kept chunks' digests come
    from the folder's ``meta.json`` or, after a crash before finalize,
    from the chunk files themselves, and a centered resume reuses the
    original ``center.npy``. ``round_rows_to`` rounds a chunk's rows down
    to a multiple of it (a producer's batch), so that chunk boundaries map
    onto input offsets. :meth:`abort` drops the buffered rows and any
    orphaned temporary file, so a failed harvest leaves whole chunks and
    no ``meta.json``."""

    def __init__(self, folder: str | Path, activation_dim: int,
                 chunk_size_gb: float = 2.0, dtype: str = "bfloat16",
                 start_index: int = 0, round_rows_to: int = 1,
                 center: bool = False):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.activation_dim = activation_dim
        self.dtype = dtype
        self.rows_per_chunk = chunk_rows(activation_dim, chunk_size_gb,
                                         dtype, round_rows_to)
        self._buffer: list[np.ndarray] = []
        self._buffered_rows = 0
        self._digests: dict[str, str] = {}
        if start_index > 0:
            prior_meta = self.folder / "meta.json"
            if prior_meta.exists():
                self._digests = dict(json.loads(prior_meta.read_text())
                                     .get("chunk_digests", {}))
            else:
                for i in range(start_index):
                    path = self.folder / f"{i}.npy"
                    if path.exists():
                        self._digests[str(i)] = array_sha256(np.load(path))
        self.chunk_index = start_index
        self.center = center
        self._center_mean: Optional[np.ndarray] = None
        if center and start_index > 0:
            prior = self.folder / "center.npy"
            if not prior.exists():
                raise ValueError(
                    f"resuming a centered harvest at chunk {start_index} but "
                    f"{prior} is missing — the original centering mean is "
                    "unrecoverable; re-harvest from chunk 0")
            self._center_mean = np.load(prior)

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
        path = self.folder / f"{self.chunk_index}.npy"

        def _write_once():
            fault_point("chunk.write")
            atomic_save_npy(path, out)

        # tmp+fsync+rename never leaves a torn chunk at the final name;
        # a transient I/O error gets a bounded retry
        retry_io(_write_once, attempts=IO_RETRIES)
        self._digests[str(self.chunk_index)] = array_sha256(out)
        self.chunk_index += 1
        lease.beat()  # a durable chunk is a harvest's unit of progress
        crash_barrier("chunk.flushed")

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
        # a kill here leaves every chunk durable and no meta.json: a
        # visibly incomplete store
        crash_barrier("store.finalize")
        atomic_write_text(self.folder / "meta.json", json.dumps(meta, indent=2))
        return self.chunk_index

    def abort(self) -> None:
        """Drop the buffered rows and sweep up orphaned temporary files:
        an aborted harvest leaves only whole chunks and no meta.json."""
        self._buffer, self._buffered_rows = [], 0
        for tmp in self.folder.glob(".*.tmp.*"):
            tmp.unlink(missing_ok=True)


class ChunkStore:
    """Reader over a flat chunk folder: digest- and finite-checked loads,
    shuffled batches. A corrupt chunk raises :class:`ChunkCorruptionError`
    from ``load_chunk``; ``chunk_reader`` and ``epoch`` skip it instead
    when ``quarantine_corrupt`` is set. A store whose every chunk file a
    scrub moved aside still opens when meta.json declares it: its
    positions read as quarantined."""

    def __init__(self, folder: str | Path, quarantine_corrupt: bool = False,
                 verify_digests: bool = True, verify_finite: bool = True):
        self.quarantine_corrupt = bool(quarantine_corrupt)
        self.folder = Path(folder)
        meta_path = self.folder / "meta.json"
        self.meta = (json.loads(meta_path.read_text())
                     if meta_path.exists() else {})
        self.format = "npy"
        self._paths = {int(p.stem): p for p in self.folder.glob("*.npy")
                       if p.stem.isdigit()}
        if not self._paths:
            pt = {int(p.stem): p for p in self.folder.glob("*.pt")
                  if p.stem.isdigit()}
            if pt:
                self._paths, self.format = pt, "pt"
        declared = self.meta.get("n_chunks")
        if not self._paths and declared is None:
            raise FileNotFoundError(f"no .npy or .pt chunks in {self.folder}")
        self._n_chunks = (int(declared) if declared is not None
                          else max(self._paths) + 1)
        self.verify_digests = verify_digests
        self.verify_finite = verify_finite
        self._verified: set[int] = set()
        # chunks a previous process proved corrupt are known at open
        self.quarantined: set[int] = set(load_quarantine(self.folder))
        if not self._paths or (self.format == "pt"
                               and "activation_dim" in self.meta):
            # every file moved aside: the meta that admitted us
            self.activation_dim = int(self.meta["activation_dim"])
        elif self.format == "pt":
            from sparse_coding_tpu_torch.utils.ref_interop import (
                read_pt_chunk,
            )

            # the on-disk dtype, no float32 copy, just for the width
            self.activation_dim = int(read_pt_chunk(
                self._paths[min(self._paths)], dtype=np.float16).shape[-1])
        else:
            first = np.load(self._paths[min(self._paths)], mmap_mode="r")
            self.activation_dim = int(first.shape[-1])

    @property
    def n_chunks(self) -> int:
        return self._n_chunks

    @property
    def center(self) -> Optional[np.ndarray]:
        path = self.folder / "center.npy"
        return np.load(path) if path.exists() else None

    def _path(self, i: int) -> Path:
        """Chunk ``i``'s file; a missing one is typed corruption."""
        path = self._paths.get(int(i))
        if path is None:
            raise ChunkCorruptionError(int(i), self.folder / f"{i}.npy",
                                       "chunk file missing")
        return path

    def load_chunk(self, i: int, dtype=np.float32):
        """Chunk ``i`` decoded to ``dtype`` (a numpy array, or a bfloat16
        tensor for ``torch.bfloat16``). Transient I/O errors get a bounded
        retry; corruption raises at once."""
        path = self._path(i)
        if self.format == "pt":
            return self._load_pt(int(i), path, dtype)

        def _load_once():
            try:
                # threaded pread only pays with cores to spread over; on
                # one core the native layer's value is chunk_reader's
                # background readahead
                raw = read_npy_native(path) if DEFAULT_THREADS > 1 else None
                via = "native"
                if raw is None:  # no library, one core, or a short read
                    raw, via = np.load(path), "numpy"
            except (ValueError, EOFError) as e:
                raise ChunkCorruptionError(int(i), path,
                                           f"unreadable npy: {e}") from e
            out = self._finish_raw(int(i), raw, dtype, path)
            _count_read(via)
            return out

        return retry_io(_load_once, attempts=IO_RETRIES)

    def _load_pt(self, i: int, path: Path, dtype):
        """A reference ``.pt`` chunk: it carries no digest, so the finite
        check is the one corruption it can show."""
        from sparse_coding_tpu_torch.utils.ref_interop import read_pt_chunk

        arr = read_pt_chunk(path)
        if self.verify_finite and i not in self._verified \
                and not np.isfinite(arr).all():
            raise ChunkCorruptionError(i, path,
                                       "non-finite values in decoded rows")
        self._verified.add(i)
        _count_read("numpy")
        if dtype is torch.bfloat16:
            return torch.from_numpy(arr).to(torch.bfloat16)
        return arr.astype(dtype, copy=False)

    def _finish_raw(self, i: int, raw: np.ndarray, dtype, path: Path):
        """The one integrity gate: the digest meta.json recorded, then the
        decode (bfloat16 bit patterns need meta.json's word), then the
        finite check — each verified once per chunk per process."""
        raw = fault_point("chunk.read", raw)
        if i not in self._verified:
            expected = (self.meta.get("chunk_digests") or {}).get(str(i))
            if self.verify_digests and expected is not None:
                got = array_sha256(raw)
                if got != expected:
                    raise ChunkCorruptionError(
                        i, path, f"content digest mismatch "
                        f"({got[:12]}… != {expected[:12]}…)")
        if raw.dtype == np.uint16 and self.meta.get("dtype") != "bfloat16":
            raise ValueError(f"{path} holds uint16 (bfloat16 bit "
                             "patterns) but meta.json lacks "
                             "dtype=bfloat16")
        if dtype is torch.bfloat16:
            out = (torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
                   if raw.dtype == np.uint16 else
                   torch.from_numpy(raw.astype(np.float32)).to(
                       torch.bfloat16))
            finite = lambda: bool(torch.isfinite(out).all())
        else:
            out = (_from_bf16_bits(raw) if raw.dtype == np.uint16
                   else raw.astype(np.float32))
            finite = lambda: bool(np.isfinite(out).all())
        if self.verify_finite and i not in self._verified and not finite():
            raise ChunkCorruptionError(i, path,
                                       "non-finite values in decoded rows")
        self._verified.add(i)
        return out if dtype is torch.bfloat16 else out.astype(dtype, copy=False)

    def chunk_mean(self, i: int = 0) -> np.ndarray:
        return self.load_chunk(i).mean(axis=0)

    def batches(self, chunk, batch_size: int, rng: np.random.Generator,
                drop_last: bool = True) -> Iterator:
        """Shuffled fixed-size batches of an in-RAM chunk."""
        return shuffled_batches(chunk, batch_size, rng, drop_last)

    def chunk_reader(self, indices, dtype=np.float32) -> Iterator:
        """In-RAM chunks for ``indices``, in order, the next chunk's file
        read on native background threads while the caller trains on the
        current one (at most two chunks in host RAM). With
        ``quarantine_corrupt`` a corrupt or ledger-known chunk yields None
        in its position (one warning, one ledger entry), so positional
        consumers stay aligned with ``indices``."""
        indices = [int(i) for i in indices]
        prefetcher = NativePrefetcher()

        def start(ci: int) -> bool:
            # never prefetch a ledger-known chunk; a bad header degrades
            # to the foreground read, which types the failure
            if self.format == "pt" or (self.quarantine_corrupt
                                       and ci in self.quarantined):
                return False
            try:
                return prefetcher.start(self._path(ci))
            except (ChunkCorruptionError, ValueError, EOFError, OSError):
                return False

        try:
            prefetching = start(indices[0]) if indices else False
            for pos, ci in enumerate(indices):
                raw = prefetcher.wait() if prefetching else None
                if self.quarantine_corrupt and ci in self.quarantined:
                    chunk = None
                else:
                    try:
                        chunk = self._load_prefetched(ci, raw, dtype)
                    except ChunkCorruptionError as e:
                        if not self.quarantine_corrupt:
                            raise
                        self._quarantine(e)
                        chunk = None
                raw = None  # decoded: drop the on-disk buffer (RAM bound)
                if pos + 1 < len(indices):
                    prefetching = start(indices[pos + 1])
                lease.beat()  # a delivered position is reader progress
                yield chunk
        finally:
            # an early exit must not leak the read in flight
            prefetcher.cancel()

    # the foreground single-stream reader: data/ingest.py's chunk_stream
    # takes it for streams <= 1 and degrades to it
    serial_chunk_reader = chunk_reader

    def _load_prefetched(self, ci: int, raw: Optional[np.ndarray], dtype):
        """Chunk ``ci`` from its prefetched bytes, or from a foreground
        load when there are none (short read, no library, bad header)."""
        if raw is None:
            return self.load_chunk(ci, dtype)
        try:
            out = self._finish_raw(ci, raw, dtype, self._path(ci))
        except OSError:
            # a transient failure on the prefetched buffer: re-read
            # through load_chunk's bounded retry
            return self.load_chunk(ci, dtype)
        _count_read("prefetch")
        return out

    def epoch(self, batch_size: int, rng: np.random.Generator,
              n_repetitions: int = 1, dtype=np.float32) -> Iterator:
        """Batches over all chunks, chunk order shuffled per repetition —
        the same rng draws, in the same order, as the JAX store. With
        ``quarantine_corrupt`` a corrupt or ledger-known chunk is skipped
        (and draws nothing from ``rng``, as in the JAX store)."""
        order = np.concatenate([rng.permutation(self.n_chunks)
                                for _ in range(n_repetitions)])
        for chunk in self.chunk_reader(order, dtype):
            if chunk is not None:
                yield from self.batches(chunk, batch_size, rng)

    def _quarantine(self, err: ChunkCorruptionError) -> None:
        """Warn about a corrupt chunk and record it in the ledger, once. A
        failed ledger write (read-only store, full disk) loses only the
        durability: the in-memory set still protects this process."""
        if err.chunk_index in self.quarantined:
            return
        logger.warning("quarantining corrupt chunk %d (%s): %s — skipping "
                       "it for the rest of this run", err.chunk_index,
                       err.path, err.reason)
        self.quarantined.add(err.chunk_index)
        try:
            record_quarantine(self.folder, err.chunk_index, err.reason,
                              Path(err.path).name)
        except OSError as write_err:
            logger.warning("quarantine ledger write failed for chunk %d "
                           "(%s): the quarantine holds in memory only",
                           err.chunk_index, write_err)


def complete_chunk_count(folder: str | Path) -> int:
    """Number of leading complete chunks (``0.npy .. k-1.npy``) in a
    possibly unfinalized store. Chunk writes are sequential and atomic,
    so after a crash the durable prefix is exactly the resumable work:
    ``ChunkWriter(..., start_index=complete_chunk_count(folder))`` plus
    skipping the producer rows those chunks cover continues a harvest
    bitwise (tmp debris never matches ``<i>.npy``)."""
    folder = Path(folder)
    k = 0
    while (folder / f"{k}.npy").exists():
        k += 1
    return k


def clean_write_debris(folder: str | Path) -> int:
    """Remove the atomic-write tmp files (``.<name>.tmp.<pid>``) a killed
    writer left behind; returns how many. Safe by construction: no
    complete chunk has a dotted tmp name."""
    n = 0
    for tmp in Path(folder).glob(".*.tmp.*"):
        tmp.unlink(missing_ok=True)
        n += 1
    return n


def shuffled_batches(chunk, batch_size: int, rng: np.random.Generator,
                     drop_last: bool = True) -> Iterator:
    """Shuffled fixed-size batches of an in-RAM array or host tensor."""
    n = chunk.shape[0]
    perm = rng.permutation(n)
    if isinstance(chunk, torch.Tensor):
        perm = torch.from_numpy(perm)
    end = n - (n % batch_size) if drop_last else n
    for lo in range(0, end, batch_size):
        yield chunk[perm[lo:lo + batch_size]]


def window_stacks(batches: Iterable, k: int) -> Iterator:
    """Group [B, d] host batches into [K, B, d] stacks; the final short
    window flushes with however many batches remain."""
    stack = lambda bs: (torch.stack(bs) if isinstance(bs[0], torch.Tensor)
                        else np.stack(bs))
    buf: list = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield stack(buf)
            buf = []
    if buf:
        yield stack(buf)
