"""k-sparse (TopK) encoder (the JAX package's ``models/topk.py``): a tied
dictionary whose codes are the ReLU'd top-k projection scores, trained on
the reconstruction error alone. ``k`` is a static buffer (a Python int):
members with different k split into buckets by k
(``ensemble.EnsembleGroup``)."""

from __future__ import annotations

import torch

from sparse_coding_tpu_torch.models import learned_dict as ld
from sparse_coding_tpu_torch.models.learned_dict import topk_sparsify
from sparse_coding_tpu_torch.models.sae import _glorot, _normalize, _to
from sparse_coding_tpu_torch.models.signatures import make_aux, register

__all__ = ["TopKEncoder", "topk_sparsify"]


@register("topk")
class TopKEncoder:
    """Trainable top-k tied SAE."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int,
             n_dict_components: int, k: int, dtype=torch.float32,
             device="cpu"):
        params = {"encoder": _glorot(generator,
                                     (n_dict_components, activation_size),
                                     dtype)}
        params, _ = _to(params, {}, device)
        return params, {"k": int(k)}

    @staticmethod
    def loss(params, buffers, batch):
        dictionary = _normalize(params["encoder"])
        c = topk_sparsify(batch @ dictionary.T, buffers["k"])
        x_hat = c @ dictionary
        l_reconstruction = torch.mean(torch.square(x_hat - batch))
        return l_reconstruction, make_aux(
            {"loss": l_reconstruction, "l_reconstruction": l_reconstruction},
            c)

    @staticmethod
    def to_learned_dict(params, buffers) -> ld.TopKLearnedDict:
        return ld.TopKLearnedDict(dictionary=params["encoder"],
                                  k=int(buffers["k"]))
