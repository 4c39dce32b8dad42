"""Synthetic sparse-dictionary data (the JAX package's
``data/synthetic.py``: ``RandomDatasetGenerator`` and
``SparseMixDataset``).

A unit-norm ground-truth dictionary, sparse codes with geometric-decay
inclusion probabilities (optionally correlated through a Gaussian
copula), data = (codes · strengths) @ feats; ``SparseMixDataset`` adds
multivariate-normal noise. Batches are drawn on the
generator's device from an explicit ``torch.Generator``; the numbers differ
from ``jax.random``'s for the same seed, the distribution does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def generate_rand_feats(generator: torch.Generator, feat_dim: int,
                        num_feats: int, device="cpu") -> torch.Tensor:
    """Unit-norm ground-truth feature dictionary [num_feats, feat_dim]."""
    feats = torch.randn((num_feats, feat_dim), generator=generator,
                        device=device)
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def corr_from_uniform(m: torch.Tensor) -> torch.Tensor:
    """A square matrix of uniform draws → the correlation matrix: its
    symmetric part, shifted by 1.001·|λ_min| when that is negative. The
    deterministic half of :func:`generate_corr_matrix`."""
    m = (m + m.T) / 2.0
    min_eig = torch.linalg.eigvalsh(m).min()
    if min_eig < 0:
        m = m - 1.001 * min_eig * torch.eye(m.shape[0], dtype=m.dtype,
                                            device=m.device)
    return m


def generate_corr_matrix(generator: torch.Generator, num_feats: int,
                         device="cpu") -> torch.Tensor:
    """Random symmetric matrix shifted to be positive definite."""
    return corr_from_uniform(torch.rand((num_feats, num_feats),
                                        generator=generator, device=device))


def noise_batch(generator: torch.Generator, noise_chol: torch.Tensor,
                scale: float, batch_size: int) -> torch.Tensor:
    """Multivariate-normal noise: scale · (z @ Lᵀ), z standard normal."""
    z = torch.randn((batch_size, noise_chol.shape[0]), generator=generator,
                    device=noise_chol.device, dtype=noise_chol.dtype)
    return scale * (z @ noise_chol.T)


@dataclasses.dataclass
class RandomDatasetGenerator:
    """Usage::

        g = torch.Generator(device).manual_seed(0)
        gen = RandomDatasetGenerator.create(g, d, n, num_nonzero, decay)
        batch = gen.batch(g, batch_size)
    """

    feats: torch.Tensor  # [n, d] ground-truth dictionary
    decay: torch.Tensor  # [n]
    corr_chol: Optional[torch.Tensor]
    frac_nonzero: float = 0.0
    correlated: bool = False

    @classmethod
    def create(cls, generator: torch.Generator, activation_dim: int,
               n_ground_truth_components: int, feature_num_nonzero: int,
               feature_prob_decay: float,
               correlated: bool = False) -> "RandomDatasetGenerator":
        device = generator.device
        n = n_ground_truth_components
        feats = generate_rand_feats(generator, activation_dim, n, device)
        decay = feature_prob_decay ** torch.arange(n, dtype=torch.float32,
                                                   device=device)
        corr_chol = None
        if correlated:
            corr_chol = torch.linalg.cholesky(
                generate_corr_matrix(generator, n, device))
        return cls(feats=feats, decay=decay, corr_chol=corr_chol,
                   frac_nonzero=feature_num_nonzero / n,
                   correlated=correlated)

    def batch_with_codes(self, generator: torch.Generator, batch_size: int):
        n = self.feats.shape[0]
        dev = self.feats.device
        rand = lambda: torch.rand((batch_size, n), generator=generator,
                                  device=dev)
        if self.correlated:
            z = self.corr_chol @ torch.randn((n,), generator=generator,
                                             device=dev)
            probs = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0))) * self.decay
            probs = probs * (self.frac_nonzero / probs.mean())
        else:
            probs = self.decay * self.frac_nonzero
        thresh, values = rand(), rand()
        codes = torch.where(thresh <= probs, values, torch.zeros((), device=dev))
        if self.correlated:
            # no all-zero rows: switch one random coefficient on
            empty = (codes > 0).sum(dim=-1) == 0
            idx = torch.randint(0, n, (batch_size,), generator=generator,
                                device=dev)
            fix = torch.nn.functional.one_hot(idx, n).bool() & empty[:, None]
            codes = torch.where(fix, torch.ones((), device=dev), codes)
        data = (codes * rand()) @ self.feats
        return codes, data

    def batch(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        return self.batch_with_codes(generator, batch_size)[1]


@dataclasses.dataclass
class SparseMixDataset:
    """Correlated sparse codes plus covariance noise: data = the
    correlated generator's batch + ``noise_magnitude_scale`` · N(0, Σ),
    Σ the identity unless ``noise_covariance`` is given."""

    base: RandomDatasetGenerator
    noise_chol: torch.Tensor  # [d, d]
    noise_magnitude_scale: float = 0.0

    @classmethod
    def create(cls, generator: torch.Generator, activation_dim: int,
               n_sparse_components: int, feature_num_nonzero: int,
               feature_prob_decay: float, noise_magnitude_scale: float,
               noise_covariance: Optional[torch.Tensor] = None
               ) -> "SparseMixDataset":
        base = RandomDatasetGenerator.create(
            generator, activation_dim, n_sparse_components,
            feature_num_nonzero, feature_prob_decay, correlated=True)
        device = generator.device
        noise_chol = (torch.eye(activation_dim, device=device)
                      if noise_covariance is None else
                      torch.linalg.cholesky(torch.as_tensor(
                          noise_covariance, dtype=torch.float32,
                          device=device)))
        return cls(base=base, noise_chol=noise_chol,
                   noise_magnitude_scale=float(noise_magnitude_scale))

    @property
    def feats(self) -> torch.Tensor:
        return self.base.feats

    def batch(self, generator: torch.Generator,
              batch_size: int) -> torch.Tensor:
        sparse = self.base.batch(generator, batch_size)
        return sparse + noise_batch(generator, self.noise_chol,
                                    self.noise_magnitude_scale, batch_size)
