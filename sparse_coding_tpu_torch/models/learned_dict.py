"""Inference-side dictionary interface (the JAX package's
``models/learned_dict.py`` counterpart for the tied and untied SAEs).

Conventions, as in the JAX package: activations x [batch, d], codes
c [batch, n_feats], dictionary D [n_feats, d], ``decode(c) = c @
normalize(D)``, ``predict = uncenter ∘ decode ∘ encode ∘ center``. Every
subclass is a dataclass whose field names equal the JAX class's, so the
pickled artifact records (utils/artifacts.py) load on either side.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_NORM_EPS = 1e-8


def normalize_rows(d: torch.Tensor, eps: float = _NORM_EPS) -> torch.Tensor:
    """Row-normalize to unit L2 norm; clip (not +eps), as the JAX package
    and the training-side normalization do."""
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=eps)


# Every LearnedDict subclass registers here by class name (artifacts).
LEARNED_DICT_REGISTRY: dict[str, type] = {}


class LearnedDict:
    """Base class: subclasses provide ``encode`` and ``get_learned_dict``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        LEARNED_DICT_REGISTRY[cls.__name__] = cls

    @property
    def n_feats(self) -> int:
        return self.get_learned_dict().shape[0]

    @property
    def activation_size(self) -> int:
        return self.get_learned_dict().shape[-1]

    def get_learned_dict(self) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, c: torch.Tensor) -> torch.Tensor:
        return c @ self.get_learned_dict()

    def center(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def uncenter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.uncenter(self.decode(self.encode(self.center(x))))

    def to(self, device) -> "LearnedDict":
        """A copy with every tensor field on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclasses.dataclass
class UntiedSAE(LearnedDict):
    """Separately-learned encoder and decoder."""

    encoder: torch.Tensor  # [n, d]
    encoder_bias: torch.Tensor  # [n]
    dictionary: torch.Tensor  # [n, d]

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.encoder.T + self.encoder_bias)


@dataclasses.dataclass
class TiedSAE(LearnedDict):
    """Tied encoder = normalized dictionary, with an optional affine
    centering transform: center(x) = ((x − t) @ Rᵀ) · s."""

    dictionary: torch.Tensor  # [n, d]
    encoder_bias: torch.Tensor  # [n]
    centering_rot: Optional[torch.Tensor] = None  # [d, d]
    centering_trans: Optional[torch.Tensor] = None  # [d]
    centering_scale: Optional[torch.Tensor] = None  # [d]

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.get_learned_dict().T + self.encoder_bias)

    def center(self, x: torch.Tensor) -> torch.Tensor:
        if self.centering_trans is not None:
            x = x - self.centering_trans
        if self.centering_rot is not None:
            x = x @ self.centering_rot.T
        if self.centering_scale is not None:
            x = x * self.centering_scale
        return x

    def uncenter(self, x: torch.Tensor) -> torch.Tensor:
        if self.centering_scale is not None:
            x = x / self.centering_scale
        if self.centering_rot is not None:
            x = x @ self.centering_rot
        if self.centering_trans is not None:
            x = x + self.centering_trans
        return x
