"""Trainable SAE families: the tied and untied SAEs of the JAX package's
``models/sae.py``, as plain functions over dicts of tensors.

Members use the JAX layout: ``encoder [n, d]``, ``encoder_bias [n]`` (and
``decoder [n, d]`` untied); buffers ``l1_alpha``, ``bias_decay`` (0-d)
and, for the tied SAE, the identity-centering ``center_rot [d, d]``,
``center_trans [d]``, ``center_scale [d]``. ``loss`` is written so
``torch.func.vmap`` + ``grad`` can run it over a stacked member axis (the
ensemble's autodiff reference path).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sparse_coding_tpu_torch.models import learned_dict as ld
from sparse_coding_tpu_torch.models.signatures import make_aux, register

_EPS = 1e-8


def _glorot(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    """Xavier-uniform on [n, d] (torch.nn.init.xavier_uniform_'s limit),
    drawn on the CPU from ``generator`` so an init is device-independent."""
    fan_out, fan_in = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                    generator=generator)


def _normalize(d: torch.Tensor) -> torch.Tensor:
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=_EPS)


def _mse(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(x_hat - x))


def _l1(c: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(torch.abs(c), dim=-1))


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    """L2 norm with a finite gradient at 0 (the JAX package's documented
    safe-norm form)."""
    return torch.sqrt(torch.sum(torch.square(v)) + _EPS * _EPS)


def _to(params: dict, buffers: dict, device) -> tuple[dict, dict]:
    return ({k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in buffers.items()})


@register("sae")
class FunctionalSAE:
    """Untied ReLU SAE."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             bias_decay: float = 0.0, dtype=torch.float32, device="cpu"):
        params = {
            "encoder": _glorot(generator, (n_dict_components, activation_size),
                               dtype),
            "encoder_bias": torch.zeros((n_dict_components,), dtype=dtype),
            "decoder": _glorot(generator, (n_dict_components, activation_size),
                               dtype),
        }
        buffers = {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype),
                   "bias_decay": torch.tensor(bias_decay, dtype=dtype)}
        return _to(params, buffers, device)

    @staticmethod
    def encode(params, buffers, batch):
        return torch.relu(batch @ params["encoder"].T + params["encoder_bias"])

    @staticmethod
    def loss(params, buffers, batch):
        c = FunctionalSAE.encode(params, buffers, batch)
        x_hat = c @ _normalize(params["decoder"])
        l_reconstruction = _mse(x_hat, batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        l_bias_decay = buffers["bias_decay"] * _safe_norm(
            params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1, "l_bias_decay": l_bias_decay}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.UntiedSAE:
        return ld.UntiedSAE(encoder=params["encoder"],
                            encoder_bias=params["encoder_bias"],
                            dictionary=params["decoder"])


@register("tied_sae")
class FunctionalTiedSAE:
    """Tied SAE: the encoder is the row-normalized dictionary, with an
    optional fixed centering transform."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             bias_decay: float = 0.0,
             rotation: Optional[torch.Tensor] = None,
             translation: Optional[torch.Tensor] = None,
             scaling: Optional[torch.Tensor] = None,
             dtype=torch.float32, device="cpu"):
        d = activation_size
        params = {
            "encoder": _glorot(generator, (n_dict_components, d), dtype),
            "encoder_bias": torch.zeros((n_dict_components,), dtype=dtype),
        }
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype),
            "center_rot": (rotation if rotation is not None
                           else torch.eye(d, dtype=dtype)),
            "center_trans": (translation if translation is not None
                             else torch.zeros((d,), dtype=dtype)),
            "center_scale": (scaling if scaling is not None
                             else torch.ones((d,), dtype=dtype)),
        }
        return _to(params, buffers, device)

    @staticmethod
    def center(buffers, batch):
        return (((batch - buffers["center_trans"]) @ buffers["center_rot"].T)
                * buffers["center_scale"])

    @staticmethod
    def encode(params, buffers, batch):
        dictionary = _normalize(params["encoder"])
        batch = FunctionalTiedSAE.center(buffers, batch)
        return torch.relu(batch @ dictionary.T + params["encoder_bias"])

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = _normalize(params["encoder"])
        batch_centered = FunctionalTiedSAE.center(buffers, batch)
        c = torch.relu(batch_centered @ dictionary.T + params["encoder_bias"])
        x_hat_centered = c @ dictionary
        l_reconstruction = _mse(x_hat_centered, batch_centered)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        l_bias_decay = buffers["bias_decay"] * _safe_norm(
            params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.TiedSAE:
        return ld.TiedSAE(dictionary=params["encoder"],
                          encoder_bias=params["encoder_bias"],
                          centering_rot=buffers["center_rot"],
                          centering_trans=buffers["center_trans"],
                          centering_scale=buffers["center_scale"])
