"""Nonnegative-dictionary SAE (the JAX package's ``models/positive.py``):
a tied SAE whose encoder is projected onto ≥ 0 inside the loss (the
gradient flows through the ReLU), on inputs shifted by a fixed +0.18 held
as a buffer."""

from __future__ import annotations

import torch

from sparse_coding_tpu_torch.models import learned_dict as ld
from sparse_coding_tpu_torch.models.sae import (
    _glorot,
    _l1,
    _mse,
    _safe_norm,
    _to,
    clip,
)
from sparse_coding_tpu_torch.models.signatures import make_aux, register

INPUT_SHIFT = 0.18


@register("positive_tied_sae")
class FunctionalPositiveTiedSAE:
    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             bias_decay: float = 0.0, dtype=torch.float32, device="cpu"):
        params = {
            "encoder": torch.abs(_glorot(
                generator, (n_dict_components, activation_size), dtype)),
            "encoder_bias": -torch.ones((n_dict_components,), dtype=dtype),
        }
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype),
            "input_shift": torch.tensor(INPUT_SHIFT, dtype=dtype),
        }
        return _to(params, buffers, device)

    @staticmethod
    def loss(params, buffers, batch):
        encoder = torch.relu(params["encoder"])
        norms = clip(torch.linalg.vector_norm(encoder, dim=-1, keepdim=True),
                     1e-8)
        dictionary = encoder / norms
        shifted = batch + buffers["input_shift"]
        c = torch.relu(shifted @ dictionary.T + params["encoder_bias"])
        x_hat = c @ dictionary
        l_reconstruction = _mse(x_hat - buffers["input_shift"], batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        l_bias_decay = buffers["bias_decay"] * _safe_norm(
            params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1, "l_bias_decay": l_bias_decay}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.TiedSAE:
        return ld.TiedSAE(dictionary=torch.relu(params["encoder"]),
                          encoder_bias=params["encoder_bias"])
