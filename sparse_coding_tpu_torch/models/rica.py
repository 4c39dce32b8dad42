"""Reconstruction ICA (the JAX package's ``models/rica.py``): a tied
linear code with smooth-L1 (or L1) sparsity, as a signature that trains
in the same ensembles as the SAEs. ``sparsity_loss`` is a static buffer
(a string), so it keys the member's bucket."""

from __future__ import annotations

import dataclasses

import torch

from sparse_coding_tpu_torch.models import learned_dict as ld
from sparse_coding_tpu_torch.models.sae import _glorot, _mse, _to
from sparse_coding_tpu_torch.models.signatures import make_aux, register


def _smooth_l1(c: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1 against zero, the elementwise mean."""
    absc = torch.abs(c)
    return torch.mean(torch.where(absc < beta, 0.5 * c * c / beta,
                                  absc - 0.5 * beta))


@register("rica")
class RICA:
    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, sparsity_coef: float = 0.0,
             sparsity_loss: str = "smooth_l1", dtype=torch.float32,
             device="cpu"):
        params = {"weights": _glorot(generator,
                                     (n_dict_components, activation_size),
                                     dtype)}
        params, buffers = _to(params, {"sparsity_coef": torch.tensor(
            sparsity_coef, dtype=dtype)}, device)
        return params, {**buffers, "sparsity_loss": str(sparsity_loss)}

    @staticmethod
    def loss(params, buffers, batch):
        w = params["weights"]
        c = batch @ w.T
        l_reconstruction = _mse(c @ w, batch)
        l_sparsity = (torch.mean(torch.abs(c))
                      if buffers["sparsity_loss"] == "l1" else _smooth_l1(c))
        total = l_reconstruction + buffers["sparsity_coef"] * l_sparsity
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_sparsity": l_sparsity}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> "RICADict":
        return RICADict(weights=params["weights"])


@dataclasses.dataclass
class RICADict(ld.LearnedDict):
    weights: torch.Tensor

    def get_learned_dict(self) -> torch.Tensor:
        return ld.normalize_rows(self.weights)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weights.T
