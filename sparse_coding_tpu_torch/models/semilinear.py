"""Semi-linear SAE (the JAX package's ``models/semilinear.py``): a
two-layer ReLU MLP encoder and a normalized linear decoder."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sparse_coding_tpu_torch.models import learned_dict as ld
from sparse_coding_tpu_torch.models.sae import (
    _glorot,
    _l1,
    _mse,
    _normalize,
    _to,
)
from sparse_coding_tpu_torch.models.signatures import make_aux, register


def _mlp(x, w0, b0, w1, b1):
    return torch.relu(torch.relu(x @ w0.T + b0) @ w1.T + b1)


@register("semilinear_sae")
class SemiLinearSAE:
    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             hidden_size: Optional[int] = None, dtype=torch.float32,
             device="cpu"):
        hidden = hidden_size or n_dict_components
        params = {
            "enc0_w": _glorot(generator, (hidden, activation_size), dtype),
            "enc0_b": torch.zeros((hidden,), dtype=dtype),
            "enc1_w": _glorot(generator, (n_dict_components, hidden), dtype),
            "enc1_b": torch.zeros((n_dict_components,), dtype=dtype),
            "decoder": _glorot(generator,
                               (n_dict_components, activation_size), dtype),
        }
        buffers = {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype)}
        return _to(params, buffers, device)

    @staticmethod
    def encode(params, batch):
        return _mlp(batch, params["enc0_w"], params["enc0_b"],
                    params["enc1_w"], params["enc1_b"])

    @staticmethod
    def loss(params, buffers, batch):
        c = SemiLinearSAE.encode(params, batch)
        x_hat = c @ _normalize(params["decoder"])
        l_reconstruction = _mse(x_hat, batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        total = l_reconstruction + l_l1
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> "SemiLinearDict":
        return SemiLinearDict(enc0_w=params["enc0_w"], enc0_b=params["enc0_b"],
                              enc1_w=params["enc1_w"], enc1_b=params["enc1_b"],
                              dictionary=params["decoder"])


@dataclasses.dataclass
class SemiLinearDict(ld.LearnedDict):
    enc0_w: torch.Tensor
    enc0_b: torch.Tensor
    enc1_w: torch.Tensor
    enc1_b: torch.Tensor
    dictionary: torch.Tensor

    def get_learned_dict(self) -> torch.Tensor:
        return ld.normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return _mlp(x, self.enc0_w, self.enc0_b, self.enc1_w, self.enc1_b)
