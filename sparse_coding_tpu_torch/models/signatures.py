"""The trainable-dictionary protocol.

A signature is a namespace of plain functions over explicit params/buffers
dicts of tensors — the same contract as the JAX package's
``models/signatures.py``:

- ``init(generator, ...) -> (params, buffers)``: params are trained,
  buffers are per-member constants (``l1_alpha`` as a 0-d tensor);
- ``loss(params, buffers, batch) -> (loss, aux)`` with ``aux`` an
  :class:`AuxData` of reduced statistics;
- ``to_learned_dict(params, buffers) -> LearnedDict``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class AuxData:
    """Reduced per-step statistics. ``finite``, ``grad_norm`` and
    ``inputs_finite`` are the sentinel fields the ensemble step fills in;
    they stay ``None`` when a bare ``loss`` builds the aux."""

    losses: dict[str, torch.Tensor]  # scalar loss components, incl. "loss"
    l0: torch.Tensor  # mean number of nonzero coefficients per sample
    feat_activity: torch.Tensor  # [n_feats] int32 samples activating each
    finite: Optional[torch.Tensor] = None  # [N] bool step-finite flag
    grad_norm: Optional[torch.Tensor] = None  # [N] grad (or update) norm
    inputs_finite: Optional[torch.Tensor] = None  # scalar bool

    def replace(self, **kwargs) -> "AuxData":
        return dataclasses.replace(self, **kwargs)


def make_aux(losses: dict[str, torch.Tensor], c: torch.Tensor) -> AuxData:
    active = c > 0.0
    return AuxData(
        losses=losses,
        l0=active.sum(dim=-1).to(torch.float32).mean(),
        feat_activity=active.sum(dim=0).to(torch.int32))


# Registry so configs can name signatures by string.
_REGISTRY: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.signature_name = name
        return cls
    return deco


def get_signature(name: str) -> type:
    return _REGISTRY[name]


def signature_names() -> list[str]:
    return sorted(_REGISTRY)
