"""The sharded chunk store and the one store-opening entry point (the
port's copy of the JAX package's ``data/shard_store.py``, same layout and
byte-identical manifests, so each package opens the other's stores).

```
store/
  manifest.json            # store-level truth, written last, atomically
  shard-000/
    0.npy 1.npy ...        # an ordinary ChunkStore folder
    meta.json              # the shard's chunk digests (ChunkWriter.finalize)
    shard.digest           # the seal: sha256 of meta.json's bytes
    quarantine.json        # the shard's durable quarantine ledger
  shard-001/ ...
```

Each shard has one writer. A finished shard is sealed
(:func:`write_shard_digest`; crash barrier ``shard.finalize`` sits
between its meta and its seal), and :func:`build_store_manifest`
aggregates the sealed shards into ``manifest.json`` behind fault site
``shard.write``: its presence certifies a complete store, as meta.json
does for a flat folder. :class:`ShardedChunkStore` presents one
positional chunk index space (shard-major) with the ``ChunkStore``
reader contract: digest-verified loads, per-shard quarantine ledgers,
positional ``None`` for quarantined chunks, and multi-stream reads
through ``data/ingest.py::chunk_stream``. The pipeline's shard and group
harvests (``pipeline/steps.py``: ``run_shard_harvest``,
``run_group_harvest``) write the shards; a group's pooled view
(``groups/assign.py``) is a manifest whose shard names point into its
parent store (``../shard-000``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from sparse_coding_tpu_torch.data.chunk_store import (
    ChunkStore,
    shuffled_batches,
)
from sparse_coding_tpu_torch.data.ingest import chunk_stream
from sparse_coding_tpu_torch.data.ledger import load_quarantine
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.errors import (
    ChunkCorruptionError,
    ResilienceError,
)
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.resilience.manifest import bytes_sha256
from sparse_coding_tpu_torch.resilience.retry import retry_io

MANIFEST_NAME = "manifest.json"
SHARD_PREFIX = "shard-"
SHARD_DIGEST_NAME = "shard.digest"

register_fault_site("shard.write",
                    "sharded-store durable writes: the per-shard "
                    "shard.digest seal and the store-level manifest "
                    "(data/shard_store.py, inside the bounded-retry scope)")
register_crash_site("shard.finalize",
                    "a shard's meta.json is durable, its shard.digest seal "
                    "not yet written (data/shard_store.py "
                    "write_shard_digest)")


class ShardLayoutError(ResilienceError):
    """A sharded store's structure contradicts itself: a shard missing its
    meta or seal, a seal that no longer matches the meta bytes, shards
    disagreeing on activation width or dtype, or a manifest that lists no
    shards."""


def shard_name(i: int) -> str:
    return f"{SHARD_PREFIX}{int(i):03d}"


def shard_dirs(root: str | Path) -> list[Path]:
    """Shard directories in shard index order — numeric, not lexical:
    names pad to 3 digits, so past 999 a lexical sort would interleave
    ("shard-1000" < "shard-999") and permute the positional space."""
    def key(p: Path):
        suffix = p.name[len(SHARD_PREFIX):]
        return (int(suffix) if suffix.isdigit() else -1, p.name)

    return sorted((p for p in Path(root).glob(f"{SHARD_PREFIX}*")
                   if p.is_dir()), key=key)


def _durable_write(path: Path, text: str) -> None:
    def _once():
        fault_point("shard.write")
        atomic_write_text(path, text)

    retry_io(_once, attempts=3)


def write_shard_digest(shard_dir: str | Path) -> str:
    """Seal a finished shard: sha256(meta.json bytes) into
    ``shard.digest``. Idempotent — resealing an unchanged shard rewrites
    identical bytes, so a killed writer's restart converges bitwise."""
    shard_dir = Path(shard_dir)
    meta = shard_dir / "meta.json"
    if not meta.exists():
        raise ShardLayoutError(
            f"cannot seal {shard_dir}: no meta.json (unfinalized shard)")
    digest = bytes_sha256(meta.read_bytes())
    crash_barrier("shard.finalize")
    _durable_write(shard_dir / SHARD_DIGEST_NAME,
                   json.dumps({"meta_sha256": digest}, sort_keys=True) + "\n")
    return digest


def read_shard_digest(shard_dir: str | Path) -> Optional[str]:
    try:
        raw = json.loads((Path(shard_dir) / SHARD_DIGEST_NAME).read_text())
        return str(raw["meta_sha256"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def build_store_manifest(root: str | Path,
                         expect_shards: Optional[int] = None) -> dict:
    """Aggregate the sealed shards under ``root`` into ``manifest.json``
    (written last, atomically). Every shard must be sealed, its seal must
    still match its meta bytes, and the shards must agree on activation
    width and dtype. Byte-deterministic: a rebuild over an unchanged store
    rewrites identical bytes."""
    root = Path(root)
    dirs = shard_dirs(root)
    if not dirs:
        raise ShardLayoutError(f"no {SHARD_PREFIX}* directories in {root}")
    if expect_shards is not None and len(dirs) != int(expect_shards):
        raise ShardLayoutError(
            f"{root}: expected {expect_shards} shard(s), found {len(dirs)}")
    shards = []
    dim: Optional[int] = None
    dtype: Optional[str] = None
    total = 0
    for d in dirs:
        meta_path = d / "meta.json"
        if not meta_path.exists():
            raise ShardLayoutError(f"{d} has no meta.json (unfinalized)")
        meta_bytes = meta_path.read_bytes()
        sealed = read_shard_digest(d)
        if sealed is None:
            raise ShardLayoutError(f"{d} is not sealed (no shard.digest)")
        got = bytes_sha256(meta_bytes)
        if got != sealed:
            raise ShardLayoutError(
                f"{d}: meta.json changed after sealing "
                f"({got[:12]}… != {sealed[:12]}…) — damaged or tampered "
                "shard; re-harvest or re-seal it deliberately")
        meta = json.loads(meta_bytes)
        d_dim = int(meta["activation_dim"])
        d_dtype = str(meta.get("dtype", ""))
        if dim is None:
            dim, dtype = d_dim, d_dtype
        elif (d_dim, d_dtype) != (dim, dtype):
            raise ShardLayoutError(
                f"{d}: activation_dim/dtype {(d_dim, d_dtype)} disagrees "
                f"with earlier shards {(dim, dtype)}")
        n = int(meta["n_chunks"])
        total += n
        shards.append({"name": d.name, "n_chunks": n, "meta_sha256": got})
    manifest = {"version": 1, "kind": "sharded_chunk_store",
                "n_shards": len(shards), "n_chunks": total,
                "activation_dim": dim, "dtype": dtype, "shards": shards}
    _durable_write(root / MANIFEST_NAME,
                   json.dumps(manifest, indent=2, sort_keys=True))
    return manifest


def read_store_manifest(root: str | Path) -> Optional[dict]:
    path = Path(root) / MANIFEST_NAME
    if not path.exists():
        return None
    return json.loads(path.read_text())


class ShardedChunkStore:
    """Reader over a sharded store: one positional chunk index space
    (shard-major, in the manifest's shard order) with the ChunkStore
    contract, so the sweep runs over it unchanged. Corruption stays
    shard-local: digests and quarantine ledgers live in the owning
    shard, in its own coordinates."""

    def __init__(self, root: str | Path, quarantine_corrupt: bool = False,
                 verify_digests: bool = True):
        self.folder = Path(root)
        manifest = read_store_manifest(self.folder)
        if manifest is None:
            raise FileNotFoundError(
                f"no {MANIFEST_NAME} in {self.folder} — not a (complete) "
                "sharded store; build_store_manifest aggregates sealed "
                "shards")
        if not isinstance(manifest, dict) or not manifest.get("shards"):
            raise ShardLayoutError(
                f"{self.folder}/{MANIFEST_NAME} lists no shards: not a "
                "sharded store's manifest")
        self.meta = manifest
        self.quarantine_corrupt = bool(quarantine_corrupt)
        self.shards: list[ChunkStore] = []
        self._offsets: list[int] = []
        off = 0
        for s in manifest["shards"]:
            store = ChunkStore(self.folder / s["name"],
                               quarantine_corrupt=quarantine_corrupt,
                               verify_digests=verify_digests)
            if store.n_chunks != int(s["n_chunks"]):
                raise ShardLayoutError(
                    f"{store.folder}: meta says {store.n_chunks} chunk(s), "
                    f"manifest says {s['n_chunks']} — stale manifest?")
            self._offsets.append(off)
            off += int(s["n_chunks"])
            self.shards.append(store)
        self.n_total = off
        self.activation_dim = int(manifest["activation_dim"])

    @property
    def n_chunks(self) -> int:
        return self.n_total

    @property
    def quarantined(self) -> set[int]:
        """Global indices of quarantined chunks, from every shard's
        ledger-backed set."""
        out: set[int] = set()
        for store, off in zip(self.shards, self._offsets):
            out.update(off + li for li in store.quarantined)
        return out

    def _locate(self, i: int) -> tuple[ChunkStore, int]:
        i = int(i)
        if not 0 <= i < self.n_total:
            raise IndexError(f"chunk {i} out of range [0, {self.n_total})")
        for store, off in zip(reversed(self.shards),
                              reversed(self._offsets)):
            if i >= off:
                return store, i - off
        raise IndexError(i)  # unreachable: offsets start at 0

    def _path(self, i: int) -> Path:
        store, local = self._locate(i)
        return store._path(local)

    def load_chunk(self, i: int, dtype=np.float32):
        store, local = self._locate(i)
        try:
            return store.load_chunk(local, dtype)
        except ChunkCorruptionError as e:
            # re-typed with the global index; the path names the shard file
            raise ChunkCorruptionError(int(i), e.path, e.reason) from e

    def _quarantine(self, err: ChunkCorruptionError) -> None:
        """Route a global-index quarantine into the owning shard's durable
        ledger, in the shard's own coordinates."""
        store, local = self._locate(err.chunk_index)
        store._quarantine(ChunkCorruptionError(local, err.path, err.reason))

    def chunk_mean(self, i: int = 0) -> np.ndarray:
        return self.load_chunk(i).mean(axis=0)

    @property
    def center(self) -> Optional[np.ndarray]:
        # shards are written uncentered: each writer sees only its rows
        return None

    def batches(self, chunk, batch_size: int, rng: np.random.Generator,
                drop_last: bool = True) -> Iterator:
        return shuffled_batches(chunk, batch_size, rng, drop_last)

    def chunk_reader(self, indices, dtype=np.float32) -> Iterator:
        """Multi-stream reader (``data/ingest.py::chunk_stream``): decodes
        overlap across shards. There is no serial reader of its own: the
        ingest layer's generic foreground loop serves streams <= 1 and a
        degraded stream."""
        return chunk_stream(self, indices, dtype)

    def epoch(self, batch_size: int, rng: np.random.Generator,
              n_repetitions: int = 1, dtype=np.float32) -> Iterator:
        order = np.concatenate([rng.permutation(self.n_chunks)
                                for _ in range(n_repetitions)])
        for chunk in self.chunk_reader(order, dtype):
            if chunk is not None:
                yield from self.batches(chunk, batch_size, rng)

    def shard_quarantine_ledgers(self) -> dict[str, dict[int, dict]]:
        """{shard name: its ledger entries}."""
        return {s.folder.name: load_quarantine(s.folder)
                for s in self.shards}


def first_sound_chunk(store) -> int:
    """Index of the first chunk the store can deliver: ledger-quarantined
    positions are skipped, so one-chunk consumers (sweep centering, eval
    batches) ride a scrub-repaired store. Raises when every chunk is
    quarantined."""
    quarantined = getattr(store, "quarantined", None) or set()
    try:
        return next(i for i in range(store.n_chunks)
                    if i not in quarantined)
    except StopIteration:
        raise RuntimeError(
            f"{getattr(store, 'folder', store)}: every chunk is "
            "quarantined — nothing sound to read") from None


def open_store(folder: str | Path, **kwargs):
    """The one store-opening entry point: a folder with a store-level
    ``manifest.json`` opens as a :class:`ShardedChunkStore`, any other as
    a flat :class:`ChunkStore`; ``kwargs`` go to either
    (``quarantine_corrupt=True`` trains through corrupt chunks)."""
    folder = Path(folder)
    if (folder / MANIFEST_NAME).exists():
        return ShardedChunkStore(folder, **kwargs)
    return ChunkStore(folder, **kwargs)
