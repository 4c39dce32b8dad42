"""Baseline dictionary suite runner (the JAX package's
``train/baselines.py``): per (layer, layer_loc) chunk folder, fit PCA on
the device and ICA on the host (sklearn), export top-k dicts matched to a
trained SAE's measured sparsity, and save the ``RandomDict`` and
``IdentityReLU`` nulls.

Artifacts: one ``learned_dicts.pkl``-format file per baseline in the
output folder, each skipped when it exists (``remake`` refits), so a
crashed run refits only what is missing and a re-run returns every
dict. ``RandomDict`` is drawn from a CPU ``torch.Generator`` seeded with
``seed``: other numbers than the JAX package's ``jax.random`` draw, the
same on the card and the CPU."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.data.shard_store import (
    first_sound_chunk,
    open_store,
)
from sparse_coding_tpu_torch.metrics.core import mean_nonzero_activations
from sparse_coding_tpu_torch.models import IdentityReLU, RandomDict
from sparse_coding_tpu_torch.models.ica import ICAEncoder
from sparse_coding_tpu_torch.models.pca import BatchedPCA, fit_pca
from sparse_coding_tpu_torch.utils.artifacts import (
    load_learned_dicts,
    save_learned_dicts,
)


def measure_sae_sparsity(learned_dict, chunk: np.ndarray,
                         batch_size: int = 8192) -> float:
    """Total firing frequency of a trained SAE over the chunk's first
    65,536 rows, on the dict's device — the sparsity budget of the top-k
    baseline exports."""
    dev = learned_dict.get_learned_dict().device
    acts = torch.as_tensor(np.asarray(chunk[:min(chunk.shape[0], 65536)],
                                      np.float32), device=dev)
    return float(mean_nonzero_activations(learned_dict, acts).sum())


def run_layer_baselines(
    chunk_folder: str | Path,
    output_folder: str | Path,
    sparsity: int = 128,
    reference_dict=None,
    max_ica_samples: int = 200_000,
    remake: bool = False,
    seed: int = 0,
    device=None,
) -> dict[str, object]:
    """Fit and export every baseline for one chunk folder, the device
    parts on ``device`` (default: the card). Returns {name: LearnedDict}."""
    dev = resolve_device(device)
    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    store = open_store(chunk_folder)
    chunk = store.load_chunk(first_sound_chunk(store))
    d = store.activation_dim

    if reference_dict is not None:
        sparsity = max(1, int(round(measure_sae_sparsity(
            reference_dict.to(dev), chunk))))

    results: dict[str, object] = {}

    def artifact(name):
        return out / f"{name}.pkl"

    def save(name, ld):
        save_learned_dicts([(ld, {"baseline": name, "sparsity": sparsity})],
                           artifact(name))
        results[name] = ld

    def cached(name) -> bool:
        if artifact(name).exists() and not remake:
            results[name] = load_learned_dicts(artifact(name),
                                               device=dev)[0][0]
            return True
        return False

    if not all(cached(n) for n in ("pca", "pca_topk", "pca_rotation")):
        pca = BatchedPCA(d, device=dev)
        pca.state = fit_pca(chunk, batch_size=512, device=dev)
        save("pca", pca.to_learned_dict(sparsity=d))  # full rank
        save("pca_topk", pca.to_topk_dict(sparsity))
        save("pca_rotation", pca.to_rotation_dict())

    if not all(cached(n) for n in ("ica", "ica_topk")):
        ica = ICAEncoder.train(np.asarray(chunk[:max_ica_samples]),
                               device=dev)
        save("ica", ica)
        save("ica_topk", ica.to_topk_dict(sparsity))

    if not cached("random"):
        save("random", RandomDict.create(
            torch.Generator().manual_seed(seed), d).to(dev))
    if not cached("identity_relu"):
        save("identity_relu", IdentityReLU.create(d, device=dev))

    return results


def run_all_baselines(
    chunks_root: str | Path,
    output_root: str | Path,
    layers: Sequence[int],
    layer_locs: Sequence[str] = ("residual",),
    sparsity: int = 128,
    reference_dicts: Optional[dict] = None,
    **kwargs,
) -> None:
    """Every (layer, layer_loc): ``{chunks_root}/{loc}.{layer}`` into
    ``{output_root}/l{layer}_{loc}``."""
    for layer in layers:
        for loc in layer_locs:
            ref = (reference_dicts or {}).get((layer, loc))
            run_layer_baselines(Path(chunks_root) / f"{loc}.{layer}",
                                Path(output_root) / f"l{layer}_{loc}",
                                sparsity=sparsity, reference_dict=ref,
                                **kwargs)
