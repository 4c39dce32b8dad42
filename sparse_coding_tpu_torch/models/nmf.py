"""NMF dictionary (the JAX package's ``models/nmf.py``).

sklearn's ``NMF`` fits on float64 host arrays shifted to nonnegative
values; encode solves the NMF transform on the host through the fitted
model, as the JAX package does, and returns the codes on the input's
device. The components are a tensor, for decode and the geometry
metrics."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.models.ica import fit_device, host_float64
from sparse_coding_tpu_torch.models.learned_dict import (
    LearnedDict,
    TopKLearnedDict,
)


@dataclasses.dataclass
class NMFEncoder(LearnedDict):
    components: torch.Tensor  # [n, d]
    shift: torch.Tensor  # 0-d
    _nmf: Any = None  # the fitted sklearn model

    @classmethod
    def train(cls, dataset, n_components: Optional[int] = None,
              max_iter: int = 400, device=None) -> "NMFEncoder":
        from sklearn.decomposition import NMF

        dev = fit_device(dataset, device)
        x = host_float64(dataset)
        shift = min(float(x.min()), 0.0)  # shift the data to nonnegative
        nmf = NMF(n_components=n_components, max_iter=max_iter,
                  init="nndsvda")
        nmf.fit(x - shift)
        return cls(components=torch.as_tensor(
                       np.asarray(nmf.components_, np.float32), device=dev),
                   shift=torch.tensor(shift, dtype=torch.float32, device=dev),
                   _nmf=nmf)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self._nmf is None:
            raise RuntimeError("NMFEncoder needs its fitted sklearn model "
                               "to encode")
        x_np = np.clip(host_float64(x) - float(self.shift), 0.0, None)
        c = self._nmf.transform(x_np)
        return torch.as_tensor(np.asarray(c, np.float32), device=x.device)

    def get_learned_dict(self) -> torch.Tensor:
        # the codes are not recovered by a product with this dictionary;
        # it serves the geometry metrics
        return self.components

    def to_topk_dict(self, sparsity: int) -> TopKLearnedDict:
        return TopKLearnedDict(dictionary=self.components, k=sparsity)
