"""Catalog build: sweep artifacts -> a byte-deterministic on-disk index
(the JAX package's ``catalog/build.py``).

The JAX build is numpy on the host. At a language model's width that is
hours (16 dicts of n=8,192 at d=2,048: ≈ 66 TFLOP of cross-dict products
and 2.2 TFLOP of encodes per 65,536 rows), so here the encodes and the
matching run in torch on the build's ``device`` (default: the card),
with the JAX build's float64 accumulators, record order, chunk order and
quarantine skipping. The encode formulas are the JAX build's
(``encode_np``); ``encode_np``, ``decoder_rows_np`` and ``mmcs_np`` keep
its numpy-in, numpy-out interface and run on the CPU.

Determinism contract: records are processed in artifact order, chunks in
ascending index order (quarantined positions skipped — the quarantine
set is durable store state, so two builds over the same store agree),
accumulators are float64 cast once to float32, ties in the matching go
to the first maximum (``torch.max`` returns the first index, as
``np.argmax`` does; an equal cosine in a later dict never displaces an
earlier one), every array is written as a raw ``.npy`` through
``resilience.atomic.atomic_save_npy``, and ``index.json`` is
``json.dumps(..., sort_keys=True)``. Two builds from the same artifact
set + store on one device are byte-identical, across a SIGKILL at
``catalog.finalize`` too.

Diverged members (``hyperparams["diverged"]=True`` — the training
guardian's quarantine tag) are dropped before any stats are computed, as
``load_learned_dicts(skip_diverged=True)`` drops them. Records are read
through the artifacts' restricted unpickler (``utils/artifacts.py``),
which never imports the JAX package.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch import obs, resolve_device
from sparse_coding_tpu_torch.models.learned_dict import (
    normalize_rows,
    topk_sparsify,
)
from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_save_npy,
    atomic_write_text,
)
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.utils.artifacts import load_records

Tensor = torch.Tensor

register_fault_site("catalog.build",
                    "catalog build I/O — each artifact-set read and every "
                    "chunk-stats accumulation step (catalog/build.py)")
register_crash_site("catalog.finalize",
                    "catalog build — every per-dict/cross-dict .npy array "
                    "durable, index.json (the completion marker) not yet "
                    "written")

INDEX_NAME = "index.json"
INDEX_VERSION = 1
ENCODE_CLASSES = ("TiedSAE", "TiedCenteredSAE", "ReverseSAE", "UntiedSAE",
                  "RandomDict", "TopKLearnedDict")


class CatalogBuildError(ValueError):
    """Typed build failure: unsupported dictionary class or empty input."""


def _read_records(path: str | Path) -> list[dict]:
    fault_point("catalog.build")
    return load_records(path)


def _kept(records: list[dict], skip_diverged: bool) -> list[dict]:
    return [r for r in records
            if not (skip_diverged and r["hyperparams"].get("diverged"))]


def load_catalog_records(path: str | Path,
                         skip_diverged: bool = True) -> list[dict]:
    """A ``learned_dicts.pkl`` artifact (written by the port or the JAX
    package) as raw records, the diverged members dropped."""
    return _kept(_read_records(path), skip_diverged)


def _field(rec: dict, name: str, device) -> Tensor:
    return torch.as_tensor(np.asarray(rec["fields"][name], np.float32),
                           device=device)


def decoder_rows(rec: dict, device="cpu") -> Tensor:
    """Normalized decoder rows [n_feats, d] of one artifact record, as the
    dict classes' ``get_learned_dict()`` gives them: the Identity and
    Rotation matrices verbatim, every SAE's and RandomDict's rows
    normalized."""
    fields = rec["fields"]
    for name in ("dictionary", "encoder", "eye", "pm_eye", "rotation"):
        if name in fields:
            d = _field(rec, name, device)
            return d if name in ("eye", "pm_eye", "rotation") \
                else normalize_rows(d)
    raise CatalogBuildError(
        f"record class {rec['cls']!r} carries no decoder matrix "
        f"(fields: {sorted(fields)})")


def _encoder(rec: dict, device) -> tuple:
    """(weights [n, d], bias or None, top-k or None) of one record's
    encode on ``device``."""
    cls = rec["cls"]
    if cls in ("TiedSAE", "TiedCenteredSAE", "ReverseSAE"):
        # relu(x @ normalize_rows(D).T + encoder_bias)
        return (normalize_rows(_field(rec, "dictionary", device)),
                _field(rec, "encoder_bias", device), None)
    if cls == "UntiedSAE":
        # relu(x @ encoder.T + encoder_bias)
        return (_field(rec, "encoder", device),
                _field(rec, "encoder_bias", device), None)
    if cls == "RandomDict":
        return normalize_rows(_field(rec, "dictionary", device)), None, None
    if cls == "TopKLearnedDict":
        # the top-k scores, ReLU'd, scattered into zeros
        return (normalize_rows(_field(rec, "dictionary", device)), None,
                int(rec["static"].get("k", 8)))
    raise CatalogBuildError(
        f"no catalog encode for class {cls!r}; supported: "
        + ", ".join(ENCODE_CLASSES))


def _encode(encoder: tuple, x: Tensor) -> Tensor:
    w, bias, k = encoder
    scores = x @ w.T
    if k is not None:
        return topk_sparsify(scores, k)
    return torch.relu(scores if bias is None else scores + bias)


def encode_np(rec: dict, x: np.ndarray) -> np.ndarray:
    """A record's encode of ``x`` [rows, d], numpy in and out, on the
    CPU."""
    x = torch.from_numpy(np.asarray(x, np.float32))
    return _encode(_encoder(rec, "cpu"), x).numpy()


def decoder_rows_np(rec: dict) -> np.ndarray:
    """:func:`decoder_rows` as a numpy array."""
    return decoder_rows(rec).numpy()


def mmcs_np(rows_a: np.ndarray, rows_b: np.ndarray) -> float:
    """``metrics/core.py`` ``mmcs(a, b)``: the mean over a's atoms of the
    max cosine to any b atom. Inputs are already row-normalized."""
    sims = torch.from_numpy(np.asarray(rows_a)) @ torch.from_numpy(
        np.asarray(rows_b)).T
    return float(sims.amax(dim=-1).mean())


def _sanitize_hyperparams(hyper: dict) -> dict:
    return {k: v for k, v in sorted(hyper.items())
            if isinstance(v, (bool, int, float, str))}


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with path.open("rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _dict_tag(i: int) -> str:
    return f"d{i:03d}"


def _normalize_artifacts(artifact_path,
                         group: Optional[str]) -> list[tuple[Path, object]]:
    """Accept one path, a list of paths, or a list of ``(path, group)``
    pairs; return ``[(Path, group_label), ...]`` in input order. The
    bare forms inherit the build-level ``group`` label."""
    if isinstance(artifact_path, (str, Path)):
        return [(Path(artifact_path), group)]
    out = []
    for item in artifact_path:
        if isinstance(item, (tuple, list)):
            path, label = item
            out.append((Path(path), label))
        else:
            out.append((Path(item), group))
    if not out:
        raise CatalogBuildError("empty artifact list")
    return out


def _matching(rows: list[Tensor], deads: list[Tensor]) -> dict:
    """The cross-dict arrays: ``mmcs.npy`` (the pairwise MMCS matrix,
    ``metrics/core.py`` ``mmcs_from_list``: entry [i, j] = [j, i] =
    mmcs(rows i, rows j) for j < i) and, per dict, the nearest live
    partner feature in the other dicts of its width (dead partner atoms
    excluded, so a dead feature is never offered as a neighbor; -1/-1/0
    with no partner). One product per ordered pair serves both."""
    m = len(rows)
    dev = rows[0].device
    mmcs = torch.eye(m, dtype=torch.float32, device=dev)
    files = {}
    for i in range(m):
        n_i = rows[i].shape[0]
        best_cos = torch.full((n_i,), -torch.inf, device=dev)
        best_dict = torch.full((n_i,), -1, dtype=torch.int32, device=dev)
        best_feat = torch.full((n_i,), -1, dtype=torch.int32, device=dev)
        for j in range(m):
            if j == i:
                continue
            same_width = rows[j].shape[1] == rows[i].shape[1]
            if j < i and not same_width:
                raise CatalogBuildError(
                    f"dicts {j} and {i} have different widths "
                    f"({rows[j].shape[1]}, {rows[i].shape[1]}): no MMCS")
            if not same_width:
                continue
            sims = rows[i] @ rows[j].T
            if j < i:
                mmcs[i, j] = mmcs[j, i] = sims.amax(dim=-1).mean()
            sims[:, deads[j]] = -torch.inf
            cos_j, feat_j = sims.max(dim=1)
            better = cos_j > best_cos
            best_cos = torch.where(better, cos_j, best_cos)
            best_dict = torch.where(better, j, best_dict)
            best_feat = torch.where(better, feat_j.to(torch.int32), best_feat)
        tag = _dict_tag(i)
        files[f"{tag}_match_dict.npy"] = best_dict
        files[f"{tag}_match_feat.npy"] = best_feat
        files[f"{tag}_match_cos.npy"] = torch.where(
            torch.isfinite(best_cos), best_cos, 0.0)
    files["mmcs.npy"] = mmcs
    return files


@torch.no_grad()
def build_catalog(artifact_path, store_dir: str | Path,
                  out_dir: str | Path, *, dead_threshold: float = 0.0,
                  experiment: Optional[str] = None,
                  group: Optional[str] = None, device=None) -> dict:
    """Build the feature index for one or more sweep artifact sets on
    ``device`` (default: the card).

    ``artifact_path`` is one ``learned_dicts.pkl`` path, a list of them,
    or a list of ``(path, group_label)`` pairs (a group's dictionaries
    indexed together with their baselines, so the cross-dict arrays pair
    them directly). Every index row carries a ``group`` label (the
    pair's, else the build-level ``group=``, else None); records
    concatenate in artifact order.

    Streams every sound chunk of ``store_dir`` once through
    ``data/ingest.chunk_stream``, accumulating per-feature activation
    counts and magnitude sums for every non-diverged record, then computes
    the cross-dict matching arrays and writes:

    - per dict ``i`` (tag ``d{i:03d}``): ``<tag>_rows.npy`` (normalized
      decoder rows), ``<tag>_freq.npy`` (activation frequency),
      ``<tag>_mag.npy`` (mean magnitude over firing events),
      ``<tag>_dead.npy`` (bool: frequency <= ``dead_threshold``),
      ``<tag>_match_dict.npy`` / ``<tag>_match_feat.npy`` /
      ``<tag>_match_cos.npy`` (nearest live partner feature across the
      other dicts; -1/-1/0 with a single dict);
    - ``mmcs.npy``: the pairwise MMCS matrix;
    - ``index.json`` — written LAST, behind the ``catalog.finalize``
      crash barrier: the completion marker and the manifest (schema +
      per-file sha256 digests).

    Returns the index metadata dict.
    """
    from sparse_coding_tpu_torch.data.ingest import chunk_stream
    from sparse_coding_tpu_torch.data.shard_store import open_store

    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    artifacts = _normalize_artifacts(artifact_path, group)
    with obs.span("catalog.build"):
        records, labels = [], []
        n_dropped = 0
        for path, label in artifacts:
            every = _read_records(path)
            recs = _kept(every, skip_diverged=True)
            n_dropped += len(every) - len(recs)
            records.extend(recs)
            labels.extend([label] * len(recs))
        if not records:
            raise CatalogBuildError(
                "no non-diverged records in "
                f"{[str(p) for p, _ in artifacts]}")
        rows_norm = [decoder_rows(rec, dev) for rec in records]
        encoders = [_encoder(rec, dev) for rec in records]
        store = open_store(store_dir, quarantine_corrupt=True)
        counts = [torch.zeros(r.shape[0], dtype=torch.int64, device=dev)
                  for r in rows_norm]
        mags = [torch.zeros(r.shape[0], dtype=torch.float64, device=dev)
                for r in rows_norm]
        rows_total = 0
        chunks_read = 0
        for chunk in chunk_stream(store, range(store.n_chunks)):
            if chunk is None:  # quarantined position (durable store state)
                continue
            fault_point("catalog.build")
            x = torch.from_numpy(np.asarray(chunk, dtype=np.float32)).to(dev)
            for i, enc in enumerate(encoders):
                codes = _encode(enc, x)
                counts[i] += (codes > 0).sum(dim=0)
                mags[i] += codes.sum(dim=0, dtype=torch.float64)
            rows_total += x.shape[0]
            chunks_read += 1
        if rows_total == 0:
            raise CatalogBuildError(
                f"store {store_dir} delivered zero rows (all chunks "
                "quarantined?)")

        meta_dicts = []
        files: dict[str, Tensor] = {}
        deads = []
        threshold = float(np.float32(dead_threshold))
        for i, rec in enumerate(records):
            tag = _dict_tag(i)
            freq = (counts[i].double() / rows_total).float()
            mag = (mags[i] / counts[i].clamp_min(1)).float()
            dead = freq <= threshold
            deads.append(dead)
            for suffix, arr in (("rows", rows_norm[i]), ("freq", freq),
                                ("mag", mag), ("dead", dead)):
                files[f"{tag}_{suffix}.npy"] = arr
            meta_dicts.append({
                "tag": tag, "cls": rec["cls"],
                "group": (None if labels[i] is None else str(labels[i])),
                "n_feats": int(rows_norm[i].shape[0]),
                "d_activation": int(rows_norm[i].shape[1]),
                "n_dead": int(dead.sum()),
                "hyperparams": _sanitize_hyperparams(rec["hyperparams"])})
        files.update(_matching(rows_norm, deads))

        for name, arr in files.items():
            atomic_save_npy(out / name, arr.cpu().numpy())
        index = {
            "version": INDEX_VERSION,
            "experiment": experiment,
            "dead_threshold": float(dead_threshold),
            "n_rows": int(rows_total),
            "n_chunks_read": int(chunks_read),
            "quarantined_chunks": sorted(int(c) for c in store.quarantined),
            "dropped_diverged": int(n_dropped),
            "dicts": meta_dicts,
            "files": {name: _sha256(out / name) for name in sorted(files)},
        }
        # every array durable, the completion marker not yet written: a
        # SIGKILL here leaves a restart that rebuilds the identical index
        crash_barrier("catalog.finalize")
        atomic_write_text(out / INDEX_NAME,
                          json.dumps(index, indent=2, sort_keys=True))
    return index


class CatalogIndex:
    """Read-side handle on a built catalog directory.

    Loads ``index.json`` plus every array eagerly (catalog arrays are
    per-feature vectors — tiny next to the chunk store). ``verify=True``
    re-hashes each array file against the manifest digests, turning a
    torn or stale directory into a typed error instead of silent garbage.
    """

    def __init__(self, root: Path, meta: dict,
                 arrays: dict[str, np.ndarray]):
        self.root = root
        self.meta = meta
        self._arrays = arrays

    @classmethod
    def load(cls, root: str | Path, verify: bool = False) -> "CatalogIndex":
        root = Path(root)
        marker = root / INDEX_NAME
        if not marker.exists():
            raise FileNotFoundError(
                f"no catalog index at {marker} (incomplete build?)")
        meta = json.loads(marker.read_text())
        arrays = {}
        for name, digest in meta["files"].items():
            path = root / name
            if verify and _sha256(path) != digest:
                raise CatalogBuildError(
                    f"catalog array {name} does not match its index.json "
                    "digest (torn or stale build directory)")
            arrays[name] = np.load(path)
        return cls(root, meta, arrays)

    @property
    def n_dicts(self) -> int:
        return len(self.meta["dicts"])

    def _arr(self, i: int, suffix: str) -> np.ndarray:
        return self._arrays[f"{_dict_tag(i)}_{suffix}.npy"]

    def rows(self, i: int) -> np.ndarray:
        return self._arr(i, "rows")

    def freq(self, i: int) -> np.ndarray:
        return self._arr(i, "freq")

    def mag(self, i: int) -> np.ndarray:
        return self._arr(i, "mag")

    def dead(self, i: int) -> np.ndarray:
        return self._arr(i, "dead")

    def mmcs_matrix(self) -> np.ndarray:
        return self._arrays["mmcs.npy"]

    def feature_stats(self, dict_i: int, feature_id: int) -> dict:
        """One feature's full stat row."""
        f = int(feature_id)
        return {
            "dict": int(dict_i),
            "feature": f,
            "freq": float(self.freq(dict_i)[f]),
            "mag": float(self.mag(dict_i)[f]),
            "dead": bool(self.dead(dict_i)[f]),
            "match_dict": int(self._arr(dict_i, "match_dict")[f]),
            "match_feat": int(self._arr(dict_i, "match_feat")[f]),
            "match_cos": float(self._arr(dict_i, "match_cos")[f]),
        }
