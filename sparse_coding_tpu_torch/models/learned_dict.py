"""Inference-side dictionary interface (the JAX package's
``models/learned_dict.py``): the SAE dictionaries and the baselines.

Conventions, as in the JAX package: activations x [batch, d], codes
c [batch, n_feats], dictionary D [n_feats, d], ``decode(c) = c @
normalize(D)``, ``predict = uncenter ∘ decode ∘ encode ∘ center``. Every
subclass is a dataclass whose field names equal the JAX class's, so the
pickled artifact records (utils/artifacts.py) load on either side.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from sparse_coding_tpu_torch.utils.tree import map_tree

_NORM_EPS = 1e-8


def normalize_rows(d: torch.Tensor, eps: float = _NORM_EPS) -> torch.Tensor:
    """Row-normalize to unit L2 norm; clip (not +eps), as the JAX package
    and the training-side normalization do."""
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=eps)


# Every LearnedDict subclass registers here by class name (artifacts).
LEARNED_DICT_REGISTRY: dict[str, type] = {}


def _tree_to(v, device):
    """A field moved to ``device``: its tensors, nested or not (LISTA's
    stacked layers); anything else as it is."""
    return map_tree(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, v)


class LearnedDict:
    """Base class: subclasses provide ``encode`` and ``get_learned_dict``.
    ``batch_coupled`` marks a dict whose encode depends on the whole batch,
    not row by row (``AddedNoise``)."""

    batch_coupled: ClassVar[bool] = False

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
            f.name: _tree_to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Identity(LearnedDict):
    """The neuron basis: codes are the activations themselves."""

    eye: torch.Tensor  # [d, d]

    @classmethod
    def create(cls, activation_size: int, dtype=torch.float32,
               device="cpu") -> "Identity":
        return cls(eye=torch.eye(activation_size, dtype=dtype, device=device))

    def get_learned_dict(self) -> torch.Tensor:
        return self.eye

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x


@dataclasses.dataclass
class IdentityReLU(Identity):
    """Identity with ReLU codes."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)


@dataclasses.dataclass
class IdentityPositive(LearnedDict):
    """+I stacked over −I, so both signs get nonnegative codes."""

    pm_eye: torch.Tensor  # [2d, d]

    @classmethod
    def create(cls, activation_size: int, dtype=torch.float32,
               device="cpu") -> "IdentityPositive":
        eye = torch.eye(activation_size, dtype=dtype, device=device)
        return cls(pm_eye=torch.cat([eye, -eye], dim=0))

    def get_learned_dict(self) -> torch.Tensor:
        return self.pm_eye

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.pm_eye.T)


@dataclasses.dataclass
class RandomDict(LearnedDict):
    """Random unit-norm dictionary with ReLU projection codes. ``create``
    draws from a ``torch.Generator`` (other numbers than ``jax.random``'s
    for the same seed)."""

    dictionary: torch.Tensor  # [n, d]

    @classmethod
    def create(cls, generator: torch.Generator, activation_size: int,
               n_feats: Optional[int] = None,
               dtype=torch.float32) -> "RandomDict":
        n = n_feats or activation_size
        d = torch.randn((n, activation_size), generator=generator,
                        dtype=dtype, device=generator.device)
        return cls(dictionary=normalize_rows(d))

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.get_learned_dict().T)


@dataclasses.dataclass
class Rotation(LearnedDict):
    """Orthonormal rotation dictionary: linear codes x @ Rᵀ."""

    rotation: torch.Tensor  # [n, d], orthonormal rows

    @classmethod
    def create(cls, generator: torch.Generator, activation_size: int,
               dtype=torch.float32) -> "Rotation":
        g = torch.randn((activation_size, activation_size),
                        generator=generator, dtype=dtype,
                        device=generator.device)
        q, _ = torch.linalg.qr(g)
        return cls(rotation=q.T)

    def get_learned_dict(self) -> torch.Tensor:
        return self.rotation

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.rotation.T


_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class AddedNoise(LearnedDict):
    """Identity encode with additive Gaussian noise, a null-model baseline.

    ``key`` is two uint32 words, the layout of a ``jax.random`` key, so the
    artifact record loads on either side. The noise is drawn from a
    ``torch.Generator`` seeded with the key and a salt, the bit pattern of
    the batch's float32 sum: different batches get independent noise, and
    repeated calls on one batch give the same noise. The draws differ from
    the JAX package's ``jax.random.fold_in`` stream for the same key, as
    every init of the port does; the distribution is the same."""

    noise_mag: torch.Tensor  # 0-d
    eye: torch.Tensor  # [d, d]
    key: torch.Tensor  # [2] uint32

    batch_coupled: ClassVar[bool] = True  # the salt is a function of the batch

    @classmethod
    def create(cls, generator: torch.Generator, activation_size: int,
               noise_mag: float, dtype=torch.float32) -> "AddedNoise":
        words = torch.randint(0, _U32 + 1, (2,), generator=generator,
                              dtype=torch.int64, device=generator.device)
        return cls(noise_mag=torch.tensor(noise_mag, dtype=dtype),
                   eye=torch.eye(activation_size, dtype=dtype),
                   key=words.cpu().to(torch.uint32))

    def get_learned_dict(self) -> torch.Tensor:
        return self.eye

    def _seed(self, x: torch.Tensor) -> int:
        total = x.sum(dtype=torch.float32).reshape(1)
        salt = int(total.view(torch.int32).item()) & _U32
        k0, k1 = (int(w) & _U32 for w in self.key.cpu().to(torch.int64))
        return ((k0 << 32) | k1) ^ (salt * 0x9E3779B97F4A7C15 & (2**64 - 1))

    def _noised(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.Generator(device=x.device).manual_seed(
            self._seed(x) & (2**63 - 1))
        noise = torch.randn(x.shape, generator=g, dtype=x.dtype,
                            device=x.device)
        return x + self.noise_mag.to(x.device) * noise

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._noised(x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self._noised(x)


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


@dataclasses.dataclass
class TiedCenteredSAE(TiedSAE):
    """Tied SAE whose center translation was learned."""


@dataclasses.dataclass
class ReverseSAE(LearnedDict):
    """Tied SAE whose decode subtracts the bias from the active codes
    before projecting (a pure function: the input is not written)."""

    dictionary: torch.Tensor  # [n, d]
    encoder_bias: torch.Tensor  # [n]

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.get_learned_dict().T + self.encoder_bias)

    def decode(self, c: torch.Tensor) -> torch.Tensor:
        adjusted = torch.where(c > 0, c - self.encoder_bias, c)
        return adjusted @ self.get_learned_dict()


def topk_sparsify(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest entries of each row, ReLU'd; zero the rest. The
    scatter writes relu(values), so when ties among non-positive scores
    pick other indices than ``jax.lax.top_k`` does, the result is the
    same."""
    vals, idx = torch.topk(scores, int(k), dim=-1)
    return torch.zeros_like(scores).scatter(-1, idx, torch.relu(vals))


@dataclasses.dataclass
class TopKLearnedDict(LearnedDict):
    """k-sparse inference dict: the top-k scores, ReLU'd."""

    dictionary: torch.Tensor  # [n, d]
    k: int = 8

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(self.dictionary)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return topk_sparsify(x @ self.get_learned_dict().T, self.k)
