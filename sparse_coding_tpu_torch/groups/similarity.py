"""Streaming pairwise angular similarity between harvested layers (the
port's copy of the JAX package's ``groups/similarity.py``).

The Group-SAE grouping signal (arXiv 2410.21508 §3: layers whose
residual streams point the same way can share one SAE) is the mean
angular similarity ``1 - arccos(cos θ)/π`` between ROW-ALIGNED
activations of two layers: every ``harvest-<i>`` writer replays the
same producer stream, so row ``r`` of shard ``i`` and row ``r`` of shard
``j`` are the same input observed at two depths, and the cosine between
them is meaningful.

The pass is host numpy with float64 accumulators, as in the JAX package,
so the ``[L, L]`` matrix is bitwise the JAX one over the same store. It
never touches the card: the ``group`` step must run on a host whose card
is wedged. Chunk reads go through the flat
:class:`~sparse_coding_tpu_torch.data.chunk_store.ChunkStore` per shard,
decoded to float32 numpy, so every sampled chunk is digest-verified
exactly as the sweep would verify it. Every read sits behind fault site
``groups.similarity``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.resilience import lease
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.resilience.retry import retry_io

register_fault_site("groups.similarity",
                    "group-SAE similarity pass — every digest-verified "
                    "sampled-chunk read feeding the pairwise "
                    "layer-similarity accumulation (groups/similarity.py)")

_NORM_EPS = 1e-8  # models/learned_dict.py _NORM_EPS


class GroupStoreError(ValueError):
    """The multi-tap store cannot support a grouping pass: missing
    manifest, shards disagreeing on chunk count (row alignment would be
    meaningless), or fewer than two layers."""


def layer_taps(store_dir: str | Path) -> list[dict]:
    """Per-layer tap records for a multi-tap sharded store, in shard
    (= layer) order: ``{"shard", "tap", "layer", "layer_loc",
    "n_chunks"}``. Taps come from each shard's ``meta.json`` (the group
    harvest stamps them at finalize); a shard without them falls back to
    its positional index so similarity still runs."""
    from sparse_coding_tpu_torch.data.shard_store import read_store_manifest

    store_dir = Path(store_dir)
    manifest = read_store_manifest(store_dir)
    if manifest is None or manifest.get("kind") != "sharded_chunk_store":
        raise GroupStoreError(
            f"{store_dir}: no sharded-store manifest — the group pass "
            "needs the multi-tap store's completion marker "
            "(build_store_manifest)")
    out = []
    for i, s in enumerate(manifest["shards"]):
        meta = json.loads((store_dir / s["name"] / "meta.json").read_text())
        out.append({
            "shard": str(s["name"]),
            "tap": str(meta.get("tap", f"layer.{i}")),
            "layer": int(meta.get("layer", i)),
            "layer_loc": str(meta.get("layer_loc", "residual")),
            "n_chunks": int(s["n_chunks"]),
        })
    return out


def _sample_rows(rng: np.random.Generator, n_rows: int,
                 n_sample_rows: int) -> np.ndarray:
    take = min(int(n_sample_rows), int(n_rows))
    return np.sort(rng.permutation(n_rows)[:take])


def layer_similarity(store_dir: str | Path, *, n_sample_chunks: int = 1,
                     n_sample_rows: int = 2048, seed: int = 0,
                     taps: Optional[list[dict]] = None) -> dict:
    """Mean pairwise angular similarity between every layer pair.

    Returns ``{"matrix": [L, L] float64 (diag exactly 1), "taps",
    "layers", "layer_loc", "n_rows", "chunk_indices"}``. Deterministic:
    the sampled chunk indices and the per-chunk row subset derive only
    from ``seed`` — two passes over the same store agree bitwise."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

    store_dir = Path(store_dir)
    taps = layer_taps(store_dir) if taps is None else taps
    n_layers = len(taps)
    if n_layers < 2:
        raise GroupStoreError(
            f"{store_dir}: {n_layers} layer shard(s) — grouping needs at "
            "least two harvested layers")
    n_chunks = {t["n_chunks"] for t in taps}
    if len(n_chunks) != 1:
        raise GroupStoreError(
            f"{store_dir}: shards disagree on chunk count ({sorted(n_chunks)})"
            " — rows are not aligned across layers; re-harvest")
    n_chunks = n_chunks.pop()
    rng = np.random.default_rng(int(seed))
    take_chunks = min(int(n_sample_chunks), n_chunks)
    chunk_indices = sorted(int(c) for c in
                           rng.permutation(n_chunks)[:take_chunks])
    stores = [ChunkStore(store_dir / t["shard"]) for t in taps]

    acc = np.zeros((n_layers, n_layers), dtype=np.float64)
    rows_total = 0
    with obs.span("groups.similarity", layers=n_layers,
                  chunks=len(chunk_indices)):
        for ci in chunk_indices:
            row_rng = np.random.default_rng([int(seed), int(ci)])
            rows: Optional[np.ndarray] = None
            units = []
            for store in stores:
                def _read(store=store):
                    fault_point("groups.similarity")
                    return np.asarray(store.load_chunk(ci, np.float32))

                chunk = retry_io(_read, attempts=3)
                if rows is None:
                    rows = _sample_rows(row_rng, chunk.shape[0],
                                        n_sample_rows)
                elif chunk.shape[0] < (int(rows[-1]) + 1 if len(rows) else 0):
                    raise GroupStoreError(
                        f"{store_dir}: chunk {ci} row counts disagree "
                        f"across layers — rows are not aligned")
                x = chunk[rows]
                norm = np.linalg.norm(x, axis=1, keepdims=True)
                units.append(x / np.clip(norm, _NORM_EPS, None))
                lease.beat()  # one digest-verified layer-chunk delivered
            n = units[0].shape[0]
            for i in range(n_layers):
                for j in range(i + 1, n_layers):
                    cos = np.clip(np.sum(units[i] * units[j], axis=1),
                                  -1.0, 1.0)
                    ang = 1.0 - np.arccos(cos) / np.pi
                    acc[i, j] += float(np.sum(ang, dtype=np.float64))
            rows_total += n
    if rows_total == 0:
        raise GroupStoreError(f"{store_dir}: sampled zero rows")
    matrix = acc / rows_total
    matrix = matrix + matrix.T
    np.fill_diagonal(matrix, 1.0)
    return {
        "matrix": matrix,
        "taps": [t["tap"] for t in taps],
        "layers": [t["layer"] for t in taps],
        "layer_loc": taps[0]["layer_loc"],
        "n_rows": int(rows_total),
        "chunk_indices": chunk_indices,
    }
