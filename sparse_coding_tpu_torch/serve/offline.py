"""Offline high-throughput batch scoring over the serving engine (the
port's copy of the JAX package's ``serve/offline.py``).

Bulk jobs (score a whole activation dump against a registry model) reuse
the SAME captured bucket programs the online path serves from — no
separate program set, no queue: the driver slices the input into
largest-bucket slabs and calls :meth:`ServingEngine.run_padded` directly
from the caller thread, so a nightly re-scoring job keeps the recompile
counter at 0 and exercises exactly the graphs production traffic replays.

Accepts an in-RAM array or a ChunkStore-like object with ``n_chunks`` /
``load_chunk`` (the data-layer streaming contract), processing one chunk at
a time with bounded memory.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np

from sparse_coding_tpu_torch.serve.engine import (
    ServingEngine,
    op_rows_axis,
)


def _iter_arrays(activations: Any) -> Iterator[np.ndarray]:
    if hasattr(activations, "n_chunks") and hasattr(activations,
                                                    "load_chunk"):
        for i in range(activations.n_chunks):
            yield np.asarray(activations.load_chunk(i))
    else:
        yield np.asarray(activations)


def score_offline(engine: ServingEngine, model: str, activations: Any,
                  op: str = "encode") -> Any:
    """Score ``activations`` ([rows, width] array or chunk store) through
    ``model``'s captured bucket programs. Returns the concatenated result
    with the same leading row count (a (values, indices) pair for
    ``op="topk"``); the tail slab pads into the smallest covering bucket
    exactly like an online partial flush."""
    slab_rows = engine._buckets[-1]
    entry = engine._registry.get(model)
    width = engine._op_width(entry, op)
    pieces: list[Any] = []
    for arr in _iter_arrays(activations):
        if arr.ndim != 2 or arr.shape[1] != width:
            raise ValueError(f"offline input must be [rows, {width}], got "
                             f"{arr.shape}")
        for start in range(0, arr.shape[0], slab_rows):
            slab = np.ascontiguousarray(
                arr[start:start + slab_rows]).astype(engine._np_dtype,
                                                     copy=False)
            _, host = engine.run_padded(model, op, slab)
            pieces.append(host)
    if not pieces:
        raise ValueError("no rows to score")
    rows_axis = op_rows_axis(entry, op)
    if isinstance(pieces[0], tuple):
        return tuple(np.concatenate(leaves, axis=rows_axis)
                     for leaves in zip(*pieces))
    return np.concatenate(pieces, axis=rows_axis)
