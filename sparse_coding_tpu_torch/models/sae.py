"""Trainable SAE families of the JAX package's ``models/sae.py`` — the
tied, untied and masked-tied SAEs the kernels train, and the tied-centered,
thresholding, masked-untied and reverse SAEs that train on autodiff — as
plain functions over dicts of tensors.

Members use the JAX layout: ``encoder [n, d]``, ``encoder_bias [n]`` (and
``decoder [n, d]`` untied); buffers ``l1_alpha``, ``bias_decay`` (0-d),
for the tied SAE the identity-centering ``center_rot [d, d]``,
``center_trans [d]``, ``center_scale [d]``, and for the masked-tied SAE
``dict_size`` (0-d int32) and ``coef_mask [n_stack]`` (bool). ``loss`` is written so
``torch.func.vmap`` + ``grad`` can run it over a stacked member axis (the
ensemble's autodiff reference path).
"""

from __future__ import annotations

import dataclasses
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


@register("masked_tied_sae")
class FunctionalMaskedTiedSAE:
    """Tied SAE padded to ``n_components_stack`` rows with a coefficient
    mask, so members of different dictionary sizes share one bucket.
    ``coef_mask`` is True for the ACTIVE coefficients."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, n_components_stack: int,
             l1_alpha: float, bias_decay: float = 0.0, dtype=torch.float32,
             device="cpu"):
        params = {
            "encoder": _glorot(generator,
                               (n_components_stack, activation_size), dtype),
            "encoder_bias": torch.zeros((n_components_stack,), dtype=dtype),
        }
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype),
            "dict_size": torch.tensor(n_dict_components, dtype=torch.int32),
            "coef_mask": torch.arange(n_components_stack) < n_dict_components,
        }
        return _to(params, buffers, device)

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = _normalize(params["encoder"])
        c = torch.relu(batch @ dictionary.T + params["encoder_bias"])
        c = torch.where(buffers["coef_mask"], c, 0.0)
        x_hat = c @ dictionary
        l_reconstruction = _mse(x_hat, batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        total = l_reconstruction + l_l1
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.TiedSAE:
        n = int(buffers["dict_size"])
        return ld.TiedSAE(dictionary=params["encoder"][:n],
                          encoder_bias=params["encoder_bias"][:n])


@register("tied_centered_sae")
class FunctionalTiedCenteredSAE:
    """Tied SAE with a learnable center translation."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             center: Optional[torch.Tensor] = None, dtype=torch.float32,
             device="cpu"):
        params = {
            "encoder": _glorot(generator,
                               (n_dict_components, activation_size), dtype),
            "encoder_bias": torch.zeros((n_dict_components,), dtype=dtype),
            "center": (center if center is not None
                       else torch.zeros((activation_size,), dtype=dtype)),
        }
        buffers = {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype)}
        return _to(params, buffers, device)

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = _normalize(params["encoder"])
        batch_centered = batch - params["center"]
        c = torch.relu(batch_centered @ dictionary.T + params["encoder_bias"])
        x_hat_centered = c @ dictionary
        l_reconstruction = _mse(x_hat_centered, batch_centered)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        total = l_reconstruction + l_l1
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.TiedCenteredSAE:
        return ld.TiedCenteredSAE(dictionary=params["encoder"],
                                  encoder_bias=params["encoder_bias"],
                                  centering_trans=params["center"])


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``'s form, max then min: at x == lo or x == hi the
    gradient splits in half between the two arguments, as JAX's does
    (``torch.clamp`` passes it whole)."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _threshold_gate(c: torch.Tensor, scale: torch.Tensor,
                    gain: torch.Tensor) -> torch.Tensor:
    """Soft-threshold surrogate gate: relu6(60·(u − 0.9))/6 + relu(u − 1)
    on u = (c + gain)/scale², rescaled back by scale²."""
    a_sq = clip(torch.square(scale), _EPS)
    u = (c + gain) / a_sq
    gated = clip(60.0 * (u - 0.9), 0.0, 6.0) / 6.0 + torch.relu(u - 1.0)
    return gated * a_sq


@register("thresholding_sae")
class FunctionalThresholdingSAE:
    """Soft-threshold gated tied SAE with a learnable per-feature scale and
    gain."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float, dtype=torch.float32,
             device="cpu"):
        params = {
            "encoder": _glorot(generator,
                               (n_dict_components, activation_size), dtype),
            "activation_scale": torch.ones((n_dict_components,), dtype=dtype),
            "activation_gain": torch.zeros((n_dict_components,), dtype=dtype),
        }
        buffers = {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype)}
        return _to(params, buffers, device)

    @staticmethod
    def encode(params, buffers, batch):
        scores = batch @ _normalize(params["encoder"]).T
        return _threshold_gate(scores, params["activation_scale"],
                               params["activation_gain"])

    @staticmethod
    def loss(params, buffers, batch):
        c = FunctionalThresholdingSAE.encode(params, buffers, batch)
        x_hat = c @ _normalize(params["encoder"])
        l_reconstruction = _mse(x_hat, batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        total = l_reconstruction + l_l1
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> "ThresholdingSAE":
        return ThresholdingSAE(dictionary=params["encoder"],
                               activation_scale=params["activation_scale"],
                               activation_gain=params["activation_gain"])


@dataclasses.dataclass
class ThresholdingSAE(ld.LearnedDict):
    """Inference side of the thresholding SAE."""

    dictionary: torch.Tensor
    activation_scale: torch.Tensor
    activation_gain: torch.Tensor

    def get_learned_dict(self) -> torch.Tensor:
        return ld.normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        scores = x @ self.get_learned_dict().T
        return _threshold_gate(scores, self.activation_scale,
                               self.activation_gain)


@register("masked_sae")
class FunctionalMaskedSAE:
    """Untied SAE padded to ``n_components_stack`` rows with a coefficient
    mask (True for the active coefficients). No kernel path: it trains on
    autodiff, as in the JAX package."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, n_components_stack: int,
             l1_alpha: float, bias_decay: float = 0.0, dtype=torch.float32,
             device="cpu"):
        shape = (n_components_stack, activation_size)
        params = {
            "encoder": _glorot(generator, shape, dtype),
            "encoder_bias": torch.zeros((n_components_stack,), dtype=dtype),
            "decoder": _glorot(generator, shape, dtype),
        }
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype),
            "dict_size": torch.tensor(n_dict_components, dtype=torch.int32),
            "coef_mask": torch.arange(n_components_stack) < n_dict_components,
        }
        return _to(params, buffers, device)

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = _normalize(params["decoder"])
        c = torch.relu(batch @ params["encoder"].T + params["encoder_bias"])
        c = torch.where(buffers["coef_mask"], c, 0.0)
        x_hat = c @ dictionary
        l_reconstruction = _mse(x_hat, batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        total = l_reconstruction + l_l1
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.UntiedSAE:
        n = int(buffers["dict_size"])
        return ld.UntiedSAE(encoder=params["encoder"][:n],
                            encoder_bias=params["encoder_bias"][:n],
                            dictionary=params["decoder"][:n])


@register("reverse_sae")
class FunctionalReverseSAE:
    """Tied SAE subtracting the bias from the active coefficients before
    the decode."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             bias_decay: float = 0.0, dtype=torch.float32, device="cpu"):
        params = {
            "encoder": _glorot(generator,
                               (n_dict_components, activation_size), dtype),
            "encoder_bias": torch.zeros((n_dict_components,), dtype=dtype),
        }
        buffers = {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype),
                   "bias_decay": torch.tensor(bias_decay, dtype=dtype)}
        return _to(params, buffers, device)

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = _normalize(params["encoder"])
        c = torch.relu(batch @ dictionary.T + params["encoder_bias"])
        c = torch.where(c > 0.0, c - params["encoder_bias"], c)
        x_hat = c @ dictionary
        l_reconstruction = _mse(x_hat, batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        l_bias_decay = buffers["bias_decay"] * _safe_norm(
            params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_l1, "l_bias_decay": l_bias_decay}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.ReverseSAE:
        return ld.ReverseSAE(dictionary=params["encoder"],
                             encoder_bias=params["encoder_bias"])
