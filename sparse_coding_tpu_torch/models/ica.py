"""FastICA dictionary (the JAX package's ``models/ica.py``).

The fit runs sklearn's ``StandardScaler`` and ``FastICA`` on float64
host arrays, as the JAX package does; the fitted whitening and unmixing
arrays become float32 tensors, so encode and decode run on the device.
``NNegICAEncoder`` gives rectified ± codes."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.models.learned_dict import (
    LearnedDict,
    TopKLearnedDict,
    normalize_rows,
)


def host_float64(x) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def fit_device(dataset, device) -> torch.device:
    """Where a host-fitted dict's tensors go: ``device`` if given, else
    the dataset's device when it is a tensor, else the card."""
    if device is None and isinstance(dataset, torch.Tensor):
        return dataset.device
    return resolve_device(device)


@dataclasses.dataclass
class ICAEncoder(LearnedDict):
    """Linear ICA codes: c = ((x − mean)/scale − ica_mean) @ componentsᵀ."""

    components: torch.Tensor  # [n, d] unmixing rows (standardized space)
    scaler_mean: torch.Tensor  # [d]
    scaler_scale: torch.Tensor  # [d]
    ica_mean: torch.Tensor  # [d] FastICA's internal mean

    @classmethod
    def train(cls, dataset, n_components: Optional[int] = None,
              max_iter: int = 500, random_state: Optional[int] = None,
              device=None) -> "ICAEncoder":
        from sklearn.decomposition import FastICA
        from sklearn.preprocessing import StandardScaler

        dev = fit_device(dataset, device)
        scaler = StandardScaler()
        x_std = scaler.fit_transform(host_float64(dataset))
        ica = FastICA(n_components=n_components, max_iter=max_iter,
                      random_state=random_state)
        ica.fit(x_std)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
        return cls(components=f32(ica.components_),
                   scaler_mean=f32(scaler.mean_),
                   scaler_scale=f32(scaler.scale_), ica_mean=f32(ica.mean_))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        x_std = (x - self.scaler_mean) / self.scaler_scale
        return (x_std - self.ica_mean) @ self.components.T

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(self.components)

    def to_topk_dict(self, sparsity: int) -> TopKLearnedDict:
        """± components TopK export."""
        comps = torch.cat([self.components, -self.components], dim=0)
        return TopKLearnedDict(dictionary=comps, k=sparsity)

    def to_nneg_dict(self) -> "NNegICAEncoder":
        return NNegICAEncoder(components=self.components,
                              scaler_mean=self.scaler_mean,
                              scaler_scale=self.scaler_scale,
                              ica_mean=self.ica_mean)


@dataclasses.dataclass
class NNegICAEncoder(ICAEncoder):
    """Rectified ± ICA codes: [relu(c), relu(−c)] over ± components."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        c = super().encode(x)
        return torch.cat([torch.relu(c), torch.relu(-c)], dim=-1)

    def get_learned_dict(self) -> torch.Tensor:
        return normalize_rows(torch.cat([self.components, -self.components],
                                        dim=0))
