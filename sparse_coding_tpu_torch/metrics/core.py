"""Core dictionary metrics (subset of the JAX package's
``metrics/core.py``)."""

from __future__ import annotations

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
