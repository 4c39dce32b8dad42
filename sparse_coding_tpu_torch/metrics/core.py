"""Core dictionary metrics (subset of the JAX package's
``metrics/core.py``)."""

from __future__ import annotations

from typing import Sequence

import torch

from sparse_coding_tpu_torch.models.learned_dict import LearnedDict


def fraction_variance_unexplained(model: LearnedDict,
                                  batch: torch.Tensor) -> torch.Tensor:
    """FVU = E‖x − x̂‖² / E‖x − x̄‖²."""
    x_hat = model.predict(batch)
    residuals = torch.mean(torch.square(batch - x_hat))
    total = torch.mean(torch.square(batch - batch.mean(dim=0)))
    return residuals / total


def mean_l0(model: LearnedDict, batch: torch.Tensor) -> torch.Tensor:
    """Mean active features per sample."""
    c = model.encode(model.center(batch))
    return (c != 0).to(torch.float32).sum(dim=-1).mean()


def mean_nonzero_activations(model: LearnedDict,
                             batch: torch.Tensor) -> torch.Tensor:
    """Per-feature firing frequency."""
    c = model.encode(model.center(batch))
    return (c != 0).to(torch.float32).mean(dim=0)


def mcs_duplicates(ground: LearnedDict, model: LearnedDict) -> torch.Tensor:
    """Max cosine similarity of each model atom to any ground atom."""
    sims = model.get_learned_dict() @ ground.get_learned_dict().T
    return sims.max(dim=-1).values


def mmcs(model: LearnedDict, model2: LearnedDict) -> torch.Tensor:
    """Mean max cosine similarity of ``model``'s atoms to ``model2``'s."""
    return mcs_duplicates(model2, model).mean()


def mmcs_from_list(dicts: Sequence[LearnedDict]) -> torch.Tensor:
    """Symmetric pairwise MMCS matrix (ones on the diagonal)."""
    n = len(dicts)
    out = torch.eye(n, dtype=torch.float32)
    for i in range(n):
        for j in range(i):
            out[i, j] = out[j, i] = float(mmcs(dicts[i], dicts[j]))
    return out
