"""Dictionary-geometry analyses (the JAX package's
``metrics/geometry.py``): clustering of dictionary atoms (t-SNE + KMeans,
agglomerative; sklearn on the host) and the activity and kurtosis
censuses over many dicts.

The censuses take an array, a tensor or a store and stream it through
``metrics/core.iter_slabs`` chunk-outer, dict-inner: the store is read
once for all the dicts, each slab encoded by every dict on the device,
the counts and moment sums kept there and read once at the end."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.metrics.core import (
    _batches,
    _finalize_moments,
    _host,
    _moment_terms,
    calc_feature_n_active,
    iter_slabs,
)
from sparse_coding_tpu_torch.models.learned_dict import LearnedDict
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts


def cluster_vectors(model: LearnedDict, n_clusters: int = 100,
                    top_clusters: int = 10, perplexity: float = 30.0,
                    seed: int = 0,
                    save_loc: Optional[str | Path] = None) -> list[list[int]]:
    """t-SNE embed the dictionary's atoms, KMeans them, return the
    largest clusters' member indices."""
    from sklearn.cluster import KMeans
    from sklearn.manifold import TSNE

    d = _host(model.get_learned_dict())
    n = d.shape[0]
    perplexity = min(perplexity, max(2.0, (n - 1) / 3))
    emb = TSNE(n_components=2, perplexity=perplexity,
               random_state=seed).fit_transform(d)
    n_clusters = min(n_clusters, n)
    km = KMeans(n_clusters=n_clusters, random_state=seed, n_init=4).fit(emb)
    clusters: dict[int, list[int]] = {}
    for idx, label in enumerate(km.labels_):
        clusters.setdefault(int(label), []).append(idx)
    largest = sorted(clusters.values(), key=len, reverse=True)[:top_clusters]
    if save_loc is not None:
        Path(save_loc).parent.mkdir(parents=True, exist_ok=True)
        with open(save_loc, "w") as fh:
            for ci, members in enumerate(largest):
                fh.write(f"cluster {ci} (n={len(members)}): {members}\n")
    return largest


def hierarchical_cluster_vectors(vectors, n_clusters: int = 100) -> np.ndarray:
    """Agglomerative clustering labels over atom vectors."""
    from sklearn.cluster import AgglomerativeClustering

    v = _host(vectors)
    n_clusters = min(n_clusters, v.shape[0])
    return AgglomerativeClustering(n_clusters=n_clusters).fit(v).labels_


def _scalar_hypers(hyper: dict) -> dict:
    return {k: v for k, v in hyper.items()
            if isinstance(v, (int, float, str, bool))}


@torch.no_grad()
def activity_sweep(dict_files: Sequence[str | Path], activations,
                   threshold: int = 10, batch_size: int = 1000,
                   device=None) -> list[dict]:
    """Ever-active feature counts (active in more than ``threshold``
    rows) of every dict in the artifact files, over an array or a store,
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    dicts = [(ld, hyper, str(path), j) for path in dict_files
             for j, (ld, hyper) in enumerate(load_learned_dicts(
                 path, device=dev))]
    if not dicts:
        return []
    counts = [torch.zeros(int(ld.n_feats), dtype=torch.int64, device=dev)
              for ld, *_ in dicts]
    for slab in iter_slabs(activations, batch_size, dev):
        for batch in _batches(slab, batch_size):
            for i, (ld, *_) in enumerate(dicts):
                counts[i] += calc_feature_n_active(ld.encode(batch))
    n_active = torch.stack([(c > threshold).sum() for c in counts]).tolist()
    return [{**_scalar_hypers(hyper), "n_ever_active": int(n),
             "n_feats": int(ld.n_feats),
             # provenance, so a census over many files splits back
             "artifact": path, "member": member}
            for (ld, hyper, path, member), n in zip(dicts, n_active)]


@torch.no_grad()
def kurtosis_sweep(dict_files: Sequence[str | Path], activations,
                   batch_size: int = 1000, device=None) -> list[dict]:
    """Per-dict feature-kurtosis summaries over an array or a store, on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    dicts = [(ld, hyper) for path in dict_files
             for ld, hyper in load_learned_dicts(path, device=dev)]
    if not dicts:
        return []
    sums = [[torch.zeros(int(ld.n_feats), dtype=torch.float32, device=dev)
             for _ in range(5)] for ld, _ in dicts]
    k = 0
    for slab in iter_slabs(activations, batch_size, dev):
        for batch in _batches(slab, batch_size):
            for i, (ld, _) in enumerate(dicts):
                for acc, term in zip(sums[i], _moment_terms(ld.encode(batch))):
                    acc += term
            k += 1
    out = []
    for (ld, hyper), carry in zip(dicts, sums):
        _, _, _, skew, kurt, _ = _finalize_moments(tuple(carry), k)
        # the median of an even count averages the middle two, as
        # jnp.median does (torch.median takes the lower one)
        stats = torch.stack([kurt.mean(), torch.quantile(kurt, 0.5),
                             skew.mean()])
        mean_k, median_k, mean_s = stats.tolist()
        out.append({**_scalar_hypers(hyper), "mean_kurtosis": mean_k,
                    "median_kurtosis": median_k, "mean_skew": mean_s})
    return out
