"""Unrolled iterative-shrinkage (LISTA) and residual-denoising encoders
(the JAX package's ``models/lista.py``).

The unrolled layers are stacked ``[L, ...]`` tensors in one dict
(``params["encoder_layers"]``), the JAX package's layout; a Python loop
over ``L`` takes the place of its ``lax.scan``. Inits draw from a
``torch.Generator`` (orthogonal matrices through ``torch.nn.init``), so
their numbers differ from ``jax.random``'s; a caller that needs the JAX
init carries its members across (``utils/carry.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_coding_tpu_torch.models import learned_dict as ld
from sparse_coding_tpu_torch.models.sae import clip
from sparse_coding_tpu_torch.models.signatures import make_aux, register


def _orthogonal(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.nn.init.orthogonal_(torch.empty(shape, dtype=dtype),
                                     generator=generator)


def _normal(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype)


def shrinkage(r: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Soft threshold: sign(r)·relu(|r| − θ)."""
    return torch.sign(r) * torch.relu(torch.abs(r) - theta)


def _layers(stacked: dict) -> list[dict]:
    """The stacked ``[L, ...]`` layer dict as a list of per-layer dicts."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _stack(layers: list[dict]) -> dict:
    return {k: torch.stack([layer[k] for layer in layers])
            for k in layers[0]}


def _init_out(params: dict, l1_alpha: float, n_hidden_layers: int, dtype,
              device):
    """(params, buffers) on ``device``; the layer count is a static
    buffer, as in the JAX package."""
    return ld._tree_to(params, device), {
        "l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device),
        "n_hidden_layers": int(n_hidden_layers)}


def _lista_step(layer: dict, y, b, x, A):
    """One LISTA iteration solving Ay = b."""
    m = clip(layer["rho"], 0.0, 1.0)
    r = y + (b - y @ A) @ layer["W"].T
    x_new = shrinkage(r, layer["theta"])
    return x_new + m * (x_new - x), x_new


def _l1_mean(c: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(torch.abs(c), dim=-1))


@register("lista_denoising_sae")
class FunctionalLISTADenoisingSAE:
    """Unrolled LISTA encoder over a normalized dictionary."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             n_hidden_layers: int = 2, dtype=torch.float32, device="cpu"):
        n, d = n_dict_components, activation_size
        decoder = _orthogonal(generator, (n, d), dtype)
        layers = []
        for _ in range(n_hidden_layers):
            w = _orthogonal(generator, (n, d), dtype)
            layers.append({"W": w,
                           "theta": 0.02 * _normal(generator, (n,), dtype),
                           "rho": torch.tensor(0.1, dtype=dtype)})
        params = {"decoder": decoder, "encoder_layers": _stack(layers)}
        return _init_out(params, l1_alpha, n_hidden_layers, dtype, device)

    @staticmethod
    def encode(params, batch, dictionary):
        y = x = batch @ dictionary.T
        for layer in _layers(params["encoder_layers"]):
            y, x = _lista_step(layer, y, batch, x, dictionary)
        return y

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = ld.normalize_rows(params["decoder"])
        c = FunctionalLISTADenoisingSAE.encode(params, batch, dictionary)
        x_hat = c @ dictionary
        l_reconstruction = torch.mean(torch.square(x_hat - batch))
        l_sparsity = buffers["l1_alpha"] * _l1_mean(c)
        total = l_reconstruction + l_sparsity
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_sparsity}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> "LISTADenoisingSAE":
        return LISTADenoisingSAE(decoder=params["decoder"],
                                 encoder_layers=dict(params["encoder_layers"]))


@dataclasses.dataclass
class LISTADenoisingSAE(ld.LearnedDict):
    """Inference side of the LISTA encoder."""

    decoder: torch.Tensor
    encoder_layers: dict  # stacked [L, ...]

    def get_learned_dict(self) -> torch.Tensor:
        return ld.normalize_rows(self.decoder)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return FunctionalLISTADenoisingSAE.encode(
            {"encoder_layers": self.encoder_layers}, x,
            self.get_learned_dict())


@register("residual_denoising_sae")
class FunctionalResidualDenoisingSAE:
    """Residual stack of relu-shift → orthogonal-mix layers over the
    projection codes."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, l1_alpha: float,
             n_hidden_layers: int = 2, dtype=torch.float32, device="cpu"):
        n, d = n_dict_components, activation_size
        decoder = _orthogonal(generator, (n, d), dtype)
        bias = 0.02 * _normal(generator, (n,), dtype)
        layers = []
        for _ in range(n_hidden_layers):
            w = _orthogonal(generator, (n, n), dtype)
            layers.append({"W": w,
                           "theta": 0.02 * _normal(generator, (n,), dtype)})
        params = {"decoder": decoder, "encoder_layers": _stack(layers),
                  "encoder_bias": bias}
        return _init_out(params, l1_alpha, n_hidden_layers, dtype, device)

    @staticmethod
    def encode(params, batch, dictionary):
        x = batch @ dictionary.T
        for layer in _layers(params["encoder_layers"]):
            x = torch.relu(x + layer["theta"]) @ layer["W"].T + x
        return torch.relu(x + params["encoder_bias"])

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = ld.normalize_rows(params["decoder"])
        c = FunctionalResidualDenoisingSAE.encode(params, batch, dictionary)
        x_hat = c @ dictionary
        l_reconstruction = torch.mean(torch.square(x_hat - batch))
        l_sparsity = buffers["l1_alpha"] * _l1_mean(c)
        total = l_reconstruction + l_sparsity
        return total, make_aux(
            {"loss": total, "l_reconstruction": l_reconstruction,
             "l_l1": l_sparsity}, c)

    @staticmethod
    def to_learned_dict(params, buffers) -> "ResidualDenoisingSAE":
        return ResidualDenoisingSAE(
            decoder=params["decoder"],
            encoder_layers=dict(params["encoder_layers"]),
            encoder_bias=params["encoder_bias"])


@dataclasses.dataclass
class ResidualDenoisingSAE(ld.LearnedDict):
    """Inference side of the residual-denoising encoder."""

    decoder: torch.Tensor
    encoder_layers: dict
    encoder_bias: torch.Tensor

    def get_learned_dict(self) -> torch.Tensor:
        return ld.normalize_rows(self.decoder)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return FunctionalResidualDenoisingSAE.encode(
            {"encoder_layers": self.encoder_layers,
             "encoder_bias": self.encoder_bias}, x, self.get_learned_dict())
