"""Deterministic adjacent-layer greedy grouping → durable ``groups.json``
(the port's copy of the JAX package's ``groups/assign.py``, writing the
same bytes from the same store).

The paper's assignment (arXiv 2410.21508 §3.1): start with every layer
its own group, repeatedly merge the ADJACENT pair with the highest
average-linkage angular similarity until G groups remain. Adjacency is
layer order — a group is always a contiguous layer range — and ties
break to the lowest index, so the assignment is a pure function of the
similarity matrix.

Durable layout (mirrors catalog/build.py's finalize discipline):

```
store/                       # the multi-tap sharded store (taps ARE shards)
  manifest.json              # store-level truth (data/shard_store.py)
  shard-<i>/                 # layer i's chunk folder, sealed
  similarity.npy             # the [L, L] float64 matrix, durable FIRST
  group-<g>/manifest.json    # pooled view: a sharded_chunk_store manifest
                             # whose shard names are RELATIVE ("../shard-000")
                             # so open_store() trains on the pool unchanged
  groups.json                # completion marker: written LAST, sort_keys,
                             # self-digested (payload_sha256), behind crash
                             # barrier ``groups.finalize``
```

Every durable write before the marker sits behind fault site
``groups.build`` (bounded retry); the build is byte-deterministic —
rebuilding over the same store rewrites identical bytes, so a SIGKILL at
crash barrier ``groups.finalize`` costs only the rebuild.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.groups.similarity import layer_similarity, layer_taps
from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_save_npy,
    atomic_write_text,
)
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.faults import fault_point, register_fault_site
from sparse_coding_tpu_torch.resilience.manifest import (
    bytes_sha256,
    check_payload_digest,
    embed_payload_digest,
)
from sparse_coding_tpu_torch.resilience.retry import retry_io

register_fault_site("groups.build",
                    "group-SAE assignment build I/O — the durable writes "
                    "of similarity.npy and the per-group pooled-store "
                    "manifests, before groups.json (groups/assign.py)")
register_crash_site("groups.finalize",
                    "group assignment build — similarity.npy and every "
                    "per-group pooled-store manifest durable, groups.json "
                    "(the completion marker) not yet written "
                    "(groups/assign.py)")

GROUPS_NAME = "groups.json"
GROUPS_VERSION = 1
SIMILARITY_NAME = "similarity.npy"


class GroupBuildError(ValueError):
    """Typed grouping failure: an impossible target G, or a
    ``groups.json`` whose embedded digest no longer matches its payload
    (the assignment cannot be trusted)."""


def group_name(g: int) -> str:
    return f"group-{int(g):03d}"


def greedy_adjacent_groups(matrix: np.ndarray,
                           n_groups: int) -> list[list[int]]:
    """Merge adjacent groups by highest average linkage until
    ``n_groups`` remain. Returns contiguous layer-index lists in layer
    order. Deterministic: strict ``>`` comparison breaks score ties to
    the lowest adjacent-pair index."""
    matrix = np.asarray(matrix, dtype=np.float64)
    n_layers = int(matrix.shape[0])
    if not 1 <= int(n_groups) <= n_layers:
        raise GroupBuildError(
            f"n_groups={n_groups} out of range [1, {n_layers}]")
    groups: list[list[int]] = [[i] for i in range(n_layers)]
    while len(groups) > int(n_groups):
        best_k, best_score = 0, -np.inf
        for k in range(len(groups) - 1):
            pair = matrix[np.ix_(groups[k], groups[k + 1])]
            score = float(pair.mean())
            if score > best_score:
                best_k, best_score = k, score
        groups[best_k:best_k + 2] = [groups[best_k] + groups[best_k + 1]]
    return groups


def _durable_write_text(path: Path, text: str) -> None:
    def _once():
        fault_point("groups.build")
        atomic_write_text(path, text)

    retry_io(_once, attempts=3)


def _durable_save_npy(path: Path, arr: np.ndarray) -> None:
    def _once():
        fault_point("groups.build")
        atomic_save_npy(path, arr)

    retry_io(_once, attempts=3)


def build_groups(store_dir: str | Path, *, n_groups: int,
                 n_sample_chunks: int = 1, n_sample_rows: int = 2048,
                 seed: int = 0) -> dict:
    """Similarity pass + greedy assignment + durable artifacts; returns
    the ``groups.json`` payload. Byte-deterministic and re-runnable from
    scratch at any instant (the crash-only step contract): a rebuild
    over the same store rewrites every artifact bit for bit."""
    from sparse_coding_tpu_torch.data.shard_store import read_store_manifest

    store_dir = Path(store_dir)
    taps = layer_taps(store_dir)
    manifest = read_store_manifest(store_dir)
    shards_by_name = {s["name"]: s for s in manifest["shards"]}
    with obs.span("groups.build", layers=len(taps), n_groups=int(n_groups)):
        sim = layer_similarity(store_dir, n_sample_chunks=n_sample_chunks,
                               n_sample_rows=n_sample_rows, seed=seed,
                               taps=taps)
        assignment = greedy_adjacent_groups(sim["matrix"], n_groups)

        _durable_save_npy(store_dir / SIMILARITY_NAME,
                          np.asarray(sim["matrix"], dtype=np.float64))
        files = {SIMILARITY_NAME:
                 bytes_sha256((store_dir / SIMILARITY_NAME).read_bytes())}

        group_rows = []
        for g, members in enumerate(assignment):
            gname = group_name(g)
            gdir = store_dir / gname
            gdir.mkdir(parents=True, exist_ok=True)
            # the pooled view: shard names are RELATIVE into the parent
            # store (ShardedChunkStore resolves `folder / name`), so ONE
            # set of chunk bytes backs both the per-layer and the pooled
            # readers — no copies, digests verified where they live
            shard_entries = []
            for li in members:
                src = shards_by_name[taps[li]["shard"]]
                shard_entries.append({"name": f"../{src['name']}",
                                      "n_chunks": int(src["n_chunks"]),
                                      "meta_sha256": str(src["meta_sha256"])})
            g_manifest = {
                "version": 1, "kind": "sharded_chunk_store",
                "n_shards": len(shard_entries),
                "n_chunks": sum(e["n_chunks"] for e in shard_entries),
                "activation_dim": int(manifest["activation_dim"]),
                "dtype": str(manifest["dtype"]),
                "shards": shard_entries,
                "group": {"id": g, "name": gname,
                          "layers": [taps[li]["layer"] for li in members],
                          "taps": [taps[li]["tap"] for li in members]},
            }
            text = json.dumps(g_manifest, indent=2, sort_keys=True)
            _durable_write_text(gdir / "manifest.json", text)
            files[f"{gname}/manifest.json"] = bytes_sha256(text.encode())
            group_rows.append({
                "id": g, "name": gname,
                "layers": [taps[li]["layer"] for li in members],
                "taps": [taps[li]["tap"] for li in members],
                "shards": [taps[li]["shard"] for li in members],
                "n_chunks": g_manifest["n_chunks"],
            })

        payload = embed_payload_digest({
            "version": GROUPS_VERSION,
            "kind": "group_assignment",
            "layer_loc": sim["layer_loc"],
            "layers": sim["layers"],
            "taps": sim["taps"],
            "n_layers": len(taps),
            "n_groups": len(group_rows),
            "groups": group_rows,
            "params": {"seed": int(seed),
                       "n_sample_chunks": int(n_sample_chunks),
                       "n_sample_rows": int(n_sample_rows),
                       "n_rows_sampled": int(sim["n_rows"]),
                       "chunk_indices": list(sim["chunk_indices"])},
            "files": files,
        })
        # worst instant: every pooled manifest + similarity.npy durable,
        # the completion marker not yet written — a SIGKILL here must
        # leave a restart that rebuilds to the bitwise-identical marker
        crash_barrier("groups.finalize")
        atomic_write_text(store_dir / GROUPS_NAME,
                          json.dumps(payload, indent=2, sort_keys=True))
    return payload


def load_groups(store_dir: str | Path, verify: bool = True) -> dict:
    """Read ``groups.json``; with ``verify`` the embedded payload digest
    must match (a tampered/rotted assignment raises typed instead of
    silently steering tenants at the wrong shards)."""
    path = Path(store_dir) / GROUPS_NAME
    if not path.exists():
        raise FileNotFoundError(
            f"no {GROUPS_NAME} at {path} (incomplete group build?)")
    payload = json.loads(path.read_text())
    if verify and check_payload_digest(payload) == "mismatch":
        raise GroupBuildError(
            f"{path}: embedded payload digest mismatch — the group "
            "assignment cannot be trusted; rebuild it (delete the file "
            "and re-run the group step)")
    return payload
