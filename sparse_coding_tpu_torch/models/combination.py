"""Ensemble-combination inference dictionary (the JAX package's
``models/combination.py``).

``ConcatEnsembleDict`` stacks its members' normalized atoms and scales
each member's codes by 1/n_members, so the sum reconstruction of the
combined codes is the mean of the members' reconstructions and
``decode(c) == c @ get_learned_dict()`` holds. Members must center with
the identity (checked at ``create``): with per-member affine centering no
single combined dictionary could satisfy that contract."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.models.learned_dict import LearnedDict


@dataclasses.dataclass
class ConcatEnsembleDict(LearnedDict):
    """Union of the members' features: n_feats = Σ member n_feats."""

    members: tuple  # of LearnedDicts

    @classmethod
    def create(cls, members: Sequence[LearnedDict]) -> "ConcatEnsembleDict":
        if not members:
            raise ValueError("need at least one member dict")
        widths = {m.activation_size for m in members}
        if len(widths) != 1:
            raise ValueError(f"members disagree on activation size: {widths}")
        d = widths.pop()
        probe = np.random.default_rng(0).normal(size=(4, d))
        for i, m in enumerate(members):
            x = torch.as_tensor(probe, dtype=torch.float32,
                                device=m.get_learned_dict().device)
            if not torch.allclose(m.center(x), x, atol=1e-6):
                raise ValueError(
                    f"member {i} has non-identity centering; the combined "
                    "dictionary contract requires all members in raw space")
        return cls(members=tuple(members))

    def get_learned_dict(self) -> torch.Tensor:
        return torch.cat([m.get_learned_dict() for m in self.members], dim=0)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        scale = 1.0 / len(self.members)
        return torch.cat([m.encode(x) * scale for m in self.members], dim=-1)

    def to(self, device) -> "ConcatEnsembleDict":
        return ConcatEnsembleDict(members=tuple(m.to(device)
                                                for m in self.members))
