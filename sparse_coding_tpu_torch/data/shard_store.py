"""Store-opening entry point (the flat-layout subset of the JAX package's
``data/shard_store.py``)."""

from __future__ import annotations

from pathlib import Path

from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

MANIFEST_NAME = "manifest.json"


def open_store(folder: str | Path, **kwargs) -> ChunkStore:
    """Open a flat chunk folder; ``kwargs`` go to :class:`ChunkStore`
    (``quarantine_corrupt=True`` trains through corrupt chunks). A
    store-level ``manifest.json`` marks the sharded layout, whose reader
    is not ported yet."""
    folder = Path(folder)
    if (folder / MANIFEST_NAME).exists():
        raise NotImplementedError(
            f"{folder} is a sharded store (manifest.json); the sharded "
            "reader waits for a later slice of the port (ROADMAP.md "
            "queue 1)")
    return ChunkStore(folder, **kwargs)
