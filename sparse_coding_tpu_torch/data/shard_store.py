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
            "queue 1, item 2)")
    return ChunkStore(folder, **kwargs)


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
