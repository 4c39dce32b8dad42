"""Direct coefficient optimization (ISTA/FISTA) over a fixed dictionary
(the JAX package's ``models/direct_coef.py``): sparse codes that
minimize ½‖x − cD‖² + α‖c‖₁ directly, with no learned encoder — an
upper bound on what any amortized encoder reaches with the same
dictionary.

The power iteration (16 steps) and the FISTA loop are fixed-count loops
of device operations: the momentum scalars depend on the step count
only, so they are computed on the host in float32, as the JAX scan
carries them, and nothing waits for the device inside the loops."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sparse_coding_tpu_torch.models.learned_dict import (
    LearnedDict,
    normalize_rows,
)

POWER_ITERS = 16


def _soft_threshold(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.relu(torch.abs(x) - t)


def fista_codes(dictionary: torch.Tensor, x: torch.Tensor, l1_alpha: float,
                n_iters: int = 50, nonneg: bool = False) -> torch.Tensor:
    """FISTA for c* = argmin ½‖x − cD‖² + α‖c‖₁, D row-normalized [n, d];
    step 1/L with L = ‖DDᵀ‖₂ from a power iteration."""
    d = normalize_rows(dictionary)
    gram = d @ d.T  # [n, n]
    n = gram.shape[0]
    v = torch.full((n,), 1.0 / float(np.sqrt(np.float32(n))),
                   dtype=gram.dtype, device=gram.device)
    for _ in range(POWER_ITERS):
        v = gram @ v
        v = v / (torch.linalg.vector_norm(v) + 1e-8)
    lipschitz = torch.clamp(v @ gram @ v, min=1e-6)
    step = 1.0 / lipschitz
    thresh = l1_alpha * step
    xd = x @ d.T  # [b, n]

    def prox(z):
        out = _soft_threshold(z, thresh)
        return torch.relu(out) if nonneg else out

    c = y = torch.zeros_like(xd)
    t = np.float32(1.0)
    for _ in range(n_iters):
        grad = y @ gram - xd
        c_new = prox(y - step * grad)
        t_new = (np.float32(1.0) + np.sqrt(np.float32(1.0)
                                           + np.float32(4.0) * t * t)
                 ) / np.float32(2.0)
        y = c_new + float((t - np.float32(1.0)) / t_new) * (c_new - c)
        c, t = c_new, t_new
    return c


@dataclasses.dataclass
class DirectCoefOptimizer(LearnedDict):
    """Inference dict whose encode runs FISTA."""

    dictionary: torch.Tensor
    l1_alpha: float = 1e-3
    n_iters: int = 50
    nonneg: bool = True

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return fista_codes(self.dictionary, x, self.l1_alpha,
                           n_iters=self.n_iters, nonneg=self.nonneg)
