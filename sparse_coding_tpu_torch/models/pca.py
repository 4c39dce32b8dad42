"""Streaming PCA and the PCA-based dictionaries (the JAX package's
``models/pca.py``): a numerically stable streaming covariance over
fixed-size batches, ``eigh`` on the state's device, and the exported
dictionaries — top-k PCA codes, a rotation, a ±rotation tied SAE, and the
whitening transform the centered SAE sweep trains in.

``eigh`` fixes each eigenvector only up to its sign: compare
``rot.T · diag(λ) · rot`` and the eigenvalues across implementations,
never the raw vectors."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.models.learned_dict import (
    LearnedDict,
    Rotation,
    TiedSAE,
    TopKLearnedDict,
    normalize_rows,
)
from sparse_coding_tpu_torch.models.sae import clip


@dataclasses.dataclass
class PCAState:
    """Streaming moment state."""

    cov: torch.Tensor  # [d, d]
    mean: torch.Tensor  # [d]
    n_samples: torch.Tensor  # 0-d

    @classmethod
    def create(cls, n_dims: int, dtype=torch.float32,
               device=None) -> "PCAState":
        device = resolve_device(device)
        z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
        return cls(cov=z((n_dims, n_dims)), mean=z((n_dims,)), n_samples=z(()))


def pca_update(state: PCAState, batch: torch.Tensor) -> PCAState:
    """One batch into the streaming covariance: the mean shifts by the
    batch's correction, and the old and new covariances are weighted by
    their sample counts."""
    b = batch.shape[0]
    corrected = batch - state.mean
    total = state.n_samples + b
    new_mean = state.mean + torch.mean(corrected, dim=0) * b / total
    cov_update = (corrected.T @ (batch - new_mean)) / b
    return PCAState(cov=state.cov * (state.n_samples / total)
                    + cov_update * (b / total),
                    mean=new_mean, n_samples=total)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


def fit_pca(activations, batch_size: int = 512, device=None) -> PCAState:
    """The streaming state over a dataset, in batches of ``batch_size``
    and one tail batch, in row order, on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    acts = _as_tensor(activations, device)
    state = PCAState.create(acts.shape[-1], device=device)
    n = (acts.shape[0] // batch_size) * batch_size
    for lo in range(0, n, batch_size):
        state = pca_update(state, acts[lo:lo + batch_size])
    if acts.shape[0] > n:
        state = pca_update(state, acts[n:])
    return state


def fit_mean(activations, batch_size: int = 512, device=None) -> torch.Tensor:
    return fit_pca(activations, batch_size, device).mean


class BatchedPCA:
    """Stateful wrapper: ``train_batch``, ``get_pca`` and the exports, its
    state on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, n_dims: int, device=None):
        self.n_dims = n_dims
        self.state = PCAState.create(n_dims, device=device)

    def train_batch(self, activations) -> None:
        self.state = pca_update(self.state,
                                _as_tensor(activations, self.state.mean.device))

    def get_mean(self) -> torch.Tensor:
        return self.state.mean

    def get_pca(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(eigenvalues ascending, eigenvectors as columns), in the
        state's dtype. The solve runs in float64: the card's float32
        ``eigh`` lands 1.6e-4 of the largest eigenvalue away from a
        float64 solve of the same matrix (an H100 80GB HBM3), where the
        CPU's lands 1.6e-7."""
        cov = self.state.cov
        vals, vecs = torch.linalg.eigh(((cov + cov.T) / 2).double())
        return vals.to(cov.dtype), vecs.to(cov.dtype)

    def get_centering_transform(self):
        """(mean, eigenvectors as columns, 1/√max(λ, 1e-6)): the whitening
        transform of the centered SAE sweep."""
        eigvals, eigvecs = self.get_pca()
        return self.get_mean(), eigvecs, 1.0 / torch.sqrt(clip(eigvals, 1e-6))

    def get_dict(self) -> torch.Tensor:
        """Eigenvectors as rows, in descending eigenvalue order."""
        eigvals, eigvecs = self.get_pca()
        return eigvecs[:, torch.argsort(-eigvals)].T

    def to_learned_dict(self, sparsity: int) -> "PCAEncoder":
        return PCAEncoder(pca_dict=normalize_rows(self.get_dict()),
                          k=sparsity)

    def to_topk_dict(self, sparsity: int) -> TopKLearnedDict:
        """± eigenvector TopK dict."""
        d = self.get_dict()
        return TopKLearnedDict(dictionary=torch.cat([d, -d], dim=0),
                               k=sparsity)

    def to_rotation_dict(self, n_components: Optional[int] = None) -> Rotation:
        return Rotation(rotation=self.get_dict()[:n_components or self.n_dims])

    def to_pve_rotation_dict(self,
                             n_components: Optional[int] = None) -> TiedSAE:
        """±rotation tied SAE with mean-centering."""
        n = n_components or self.n_dims
        dirs = self.get_dict()[:n]
        return TiedSAE(dictionary=torch.cat([dirs, -dirs], dim=0),
                       encoder_bias=torch.zeros(2 * n, device=dirs.device),
                       centering_trans=self.get_mean())


@dataclasses.dataclass
class PCAEncoder(LearnedDict):
    """Top-k-by-|score| sparse PCA codes, keeping their signed values."""

    pca_dict: torch.Tensor  # [n, d], rows normalized
    k: int = 8

    def get_learned_dict(self) -> torch.Tensor:
        return self.pca_dict

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        scores = x @ self.pca_dict.T
        _, idx = torch.topk(torch.abs(scores), self.k, dim=-1)
        return torch.zeros_like(scores).scatter(
            -1, idx, torch.gather(scores, -1, idx))
