"""Concept-erasure evaluation (the JAX package's ``metrics/erasure.py``).

- ``feature_erasure_curve``: progressively ablate the dictionary features
  most predictive of a binary concept (by point-biserial correlation),
  measuring probe AUROC on the erased activations, mean edit magnitude,
  and the KL divergence of the LM's next-token distribution under the
  edit.
- ``LeaceEraser``: the closed-form least-squares concept-erasure
  projection (Belrose et al. 2023), the linear baseline.

``LeaceEraser.fit`` takes the moments in float32, as the JAX package
does, and solves (eigh, the whitening, QR, the projection) in float64,
as the port's PCA does: the card's float32 ``eigh`` lands 1.6e-4 of the
largest eigenvalue off a float64 solve. The projection is float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from sparse_coding_tpu_torch.models.learned_dict import LearnedDict

Tensor = torch.Tensor


@dataclasses.dataclass
class LeaceEraser:
    """x ↦ x − (x − μ) Pᵀ, P the LEACE oblique projection that wipes the
    class-mean direction in whitened space."""

    proj: Tensor  # [d, d]
    mean: Tensor  # [d]

    @classmethod
    def fit(cls, x, labels, eps: float = 1e-4) -> "LeaceEraser":
        x = torch.as_tensor(x, dtype=torch.float32)
        z = torch.as_tensor(labels, dtype=torch.float32, device=x.device)
        z = z[:, None] if z.dim() == 1 else z
        mu = x.mean(dim=0)
        xc = x - mu
        zc = z - z.mean(dim=0)
        n = x.shape[0]
        sigma = xc.T @ xc / n + eps * torch.eye(x.shape[1], device=x.device)
        sigma_xz = (xc.T @ zc / n).double()  # [d, k]
        evals, evecs = torch.linalg.eigh(sigma.double())
        w = evecs @ torch.diag(evals ** -0.5) @ evecs.T  # Σ^{-1/2}
        w_inv = evecs @ torch.diag(evals ** 0.5) @ evecs.T
        q, _ = torch.linalg.qr(w @ sigma_xz)
        proj = w_inv @ (q @ q.T) @ w
        return cls(proj=proj.to(torch.float32), mean=mu)

    def __call__(self, x: Tensor) -> Tensor:
        return x - (x - self.mean) @ self.proj.T


def concept_feature_scores(model: LearnedDict, acts: Tensor,
                           labels) -> Tensor:
    """|point-biserial correlation| of each feature with the binary
    concept, from population (not unbiased) standard deviations."""
    c = model.encode(model.center(acts))
    z = torch.as_tensor(labels, dtype=torch.float32, device=c.device)
    zc = (z - z.mean()) / (torch.std(z, correction=0) + 1e-8)
    cc = (c - c.mean(dim=0)) / (torch.std(c, dim=0, correction=0) + 1e-8)
    return torch.abs(cc.T @ zc) / c.shape[0]


def erase_features(model: LearnedDict, acts: Tensor, feature_idx) -> Tensor:
    """Subtract the selected features' contributions from the activations
    in the dict's centered space, mapped back through uncenter."""
    xc = model.center(acts)
    c = model.encode(xc)
    idx = torch.as_tensor(feature_idx, device=acts.device).reshape(-1)
    mask = torch.zeros((model.n_feats,), dtype=acts.dtype,
                       device=acts.device).index_fill(0, idx, 1.0)
    removal = (c * mask) @ model.get_learned_dict()
    return model.uncenter(xc - removal)


def _kl_div(p_logits: Tensor, q_logits: Tensor) -> Tensor:
    p = torch.log_softmax(p_logits.to(torch.float32), dim=-1)
    q = torch.log_softmax(q_logits.to(torch.float32), dim=-1)
    return torch.mean(torch.sum(torch.exp(p) * (p - q), dim=-1))


def _edit_magnitude(erased: Tensor, acts: Tensor) -> float:
    return float(torch.linalg.vector_norm(erased - acts, dim=-1).mean())


@torch.no_grad()
def feature_erasure_curve(
    model: LearnedDict,
    acts: Tensor,
    labels,
    n_features_grid: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
    lm_eval: Optional[dict] = None,
    probe_fn=None,
) -> list[dict]:
    """For each m in the grid: erase the top-m concept features and
    record the probe's AUROC, the mean edit magnitude and, when
    ``lm_eval`` gives {params, lm_cfg, tokens, location, forward}, the
    LM's KL under the edit in flight. The dict is moved to the
    activations' device."""
    if probe_fn is None:
        from sparse_coding_tpu_torch.metrics.core import (
            logistic_regression_auroc as probe_fn,
        )

    model = model.to(acts.device)
    scores = concept_feature_scores(model, acts, labels)
    order = torch.argsort(-scores, stable=True)
    base_row = {"n_erased": 0, "auroc": probe_fn(acts, labels, max_iter=200),
                "edit_magnitude": 0.0}
    if lm_eval is not None:  # the same record keys on every row
        base_row["kl"] = 0.0
    results = [base_row]
    for m in n_features_grid:
        m = min(m, int(model.n_feats))
        idx = order[:m]
        erased = erase_features(model, acts, idx)
        rec = {"n_erased": m,
               "auroc": probe_fn(erased, labels, max_iter=200),
               "edit_magnitude": _edit_magnitude(erased, acts)}
        if lm_eval is not None:
            rec["kl"] = _lm_kl_under_erasure(model, idx, **lm_eval)
        results.append(rec)
    return results


@torch.no_grad()
def leace_baseline(acts: Tensor, labels, probe_fn=None) -> dict:
    """AUROC and edit magnitude after LEACE."""
    if probe_fn is None:
        from sparse_coding_tpu_torch.metrics.core import (
            logistic_regression_auroc as probe_fn,
        )
    eraser = LeaceEraser.fit(acts, labels)
    erased = eraser(acts)
    return {"auroc": probe_fn(erased, labels, max_iter=200),
            "edit_magnitude": _edit_magnitude(erased, acts)}


def _lm_kl_under_erasure(model: LearnedDict, feature_idx, params=None,
                         lm_cfg=None, tokens=None, location=None,
                         forward=None) -> float:
    """KL(base ‖ erased) of next-token distributions, the erasure applied
    to the tapped activation in flight, on the params' device."""
    from sparse_coding_tpu_torch.metrics.intervention import (
        _forward,
        _loc_tap,
        _tokens,
        params_device,
    )

    forward = _forward(lm_cfg, forward)
    dev = params_device(params)
    model = model.to(dev)
    idx = torch.as_tensor(feature_idx).to(dev)
    toks = _tokens(tokens, dev)

    def edit(tensor: Tensor) -> Tensor:
        b, s, d = tensor.shape
        flat = tensor.reshape(b * s, d)
        return erase_features(model, flat, idx).reshape(b, s, d)

    base_logits, _ = forward(params, toks, lm_cfg)
    erased_logits, _ = forward(params, toks, lm_cfg,
                               edit=(_loc_tap(location), edit))
    return float(_kl_div(base_logits, erased_logits))
