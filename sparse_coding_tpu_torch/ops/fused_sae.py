"""Tied-SAE step kernels: the counterpart of the JAX package's
``ops/fused_sae.py`` for the tied family.

The JAX package keeps a member's whole [n, d] matrix in TPU VMEM for its
untiled kernels. An H100 block has 227 KB of shared memory, so on Hopper
every contract rides the feature-tiled kernels of ``fused_sae_tiled`` plus
one hand-written epilogue kernel, ``sae_tied_adam_vjp``:

- K1 ``fused_tied_sae_grads`` = sae_tied_fwd + sae_tied_bwd (the
  normalization VJP stays in the producer, as in the JAX package);
- K2 ``fused_tied_sae_train_step`` = sae_tied_fwd + sae_tied_bwd +
  sae_tied_adam_vjp with the bias rows, behind K2's signature and outputs;
- K4 ``fused_tied_adam_vjp_update`` = sae_tied_adam_vjp.

Every kernel and contract has a plain PyTorch version beside it; a wrapper
takes the plain version only for CPU tensors. Adam is optax's
``scale_by_adam`` with eps_root=0 exactly as the kernels write it (never
torch.optim.Adam's rearranged form).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
    _check_unported,
    _on_cpu,
    _tied_shapes,
    prepare_tiled_batch,
    sae_tied_bwd,
    sae_tied_bwd_plain,
    sae_tied_fwd,
    sae_tied_fwd_plain,
)

_EPS = 1e-8


def normalize_with_vjp(e: torch.Tensor, dw: torch.Tensor,
                       eps: float = _EPS) -> torch.Tensor:
    """Chain dL/dW (W = row-normalized E) back to dL/dE:
    dE = (dW − Ŵ·⟨dW, Ŵ⟩_row) / ‖E‖ (norms clipped, not +eps)."""
    norms = torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                        min=eps)
    w_hat = e / norms
    radial = torch.sum(dw * w_hat, dim=-1, keepdim=True)
    return (dw - w_hat * radial) / norms


# --- sae_tied_adam_vjp (K4, and K2's update epilogue) -------------------------

def sae_tied_adam_vjp_plain(encoder, dw, mu, nu, lrs, bc1, bc2,
                            b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8, bias=None, db=None,
                            mu_b=None, nu_b=None):
    """Normalization VJP + exact optax Adam on E; with the bias group also
    Adam on the bias. Returns (E', μ', ν', un_sq [N], bias_out) where
    bias_out is None or (b', μ_b', ν_b')."""
    de = normalize_with_vjp(encoder, dw)
    col = lambda v: v[:, None, None]
    mu2 = b1 * mu + (1.0 - b1) * de
    nu2 = b2 * nu + (1.0 - b2) * de * de
    u = -col(lrs) * (mu2 / col(bc1)) / (torch.sqrt(nu2 / col(bc2)) + eps)
    bias_out = None
    if bias is not None:
        mub2 = b1 * mu_b + (1.0 - b1) * db
        nub2 = b2 * nu_b + (1.0 - b2) * db * db
        bias2 = bias - lrs[:, None] * (mub2 / bc1[:, None]) / (
            torch.sqrt(nub2 / bc2[:, None]) + eps)
        bias_out = (bias2, mub2, nub2)
    return encoder + u, mu2, nu2, (u * u).sum(dim=(1, 2)), bias_out


def sae_tied_adam_vjp(encoder, dw, mu, nu, lrs, bc1, bc2,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      bias=None, db=None, mu_b=None, nu_b=None):
    """See :func:`sae_tied_adam_vjp_plain`. CUDA: launches
    ``sae_tied_adam_vjp``; the per-block update partials are summed here
    in a fixed order."""
    n_members, n_feats, d = encoder.shape
    group = (bias, db, mu_b, nu_b)
    if any(t is None for t in group) and not all(t is None for t in group):
        raise ValueError("bias, db, mu_b and nu_b go together")
    for name, t in (("dw", dw), ("mu", mu), ("nu", nu)):
        if t.shape != encoder.shape:
            raise ValueError(f"{name} must be {tuple(encoder.shape)}")
    for name, t in (("lrs", lrs), ("bc1", bc1), ("bc2", bc2)):
        if tuple(t.shape) != (n_members,):
            raise ValueError(f"{name} must be [{n_members}]")
    vecs = [t for t in group if t is not None]
    if any(tuple(t.shape) != (n_members, n_feats) for t in vecs):
        raise ValueError(f"the bias group must be [{n_members}, {n_feats}]")
    tensors = dict(encoder=encoder, dw=dw, mu=mu, nu=nu, lrs=lrs, bc1=bc1,
                   bc2=bc2)
    if bias is not None:
        tensors.update(bias=bias, db=db, mu_b=mu_b, nu_b=nu_b)
    if _on_cpu("sae_tied_adam_vjp", *tensors.values()):
        return sae_tied_adam_vjp_plain(encoder, dw, mu, nu, lrs, bc1, bc2,
                                       b1, b2, eps, bias, db, mu_b, nu_b)
    _build.check_cuda_tensors("sae_tied_adam_vjp", **tensors)
    if n_feats % _build.ADAM_ROWS:
        raise ValueError(f"sae_tied_adam_vjp: n_feats % {_build.ADAM_ROWS} "
                         "must be 0")
    e2, mu2, nu2 = (torch.empty_like(encoder) for _ in range(3))
    part = torch.empty((n_members, n_feats // _build.ADAM_ROWS),
                       dtype=torch.float32, device=encoder.device)
    bias_out = None
    ptrs = [0] * 7
    if bias is not None:
        bias_out = tuple(torch.empty_like(bias) for _ in range(3))
        ptrs = [t.data_ptr() for t in (bias, db, mu_b, nu_b, *bias_out)]
    f32 = lambda v: float(np.float32(v))
    _build.launch("sae_tied_adam_vjp", *(t.data_ptr() for t in (
        encoder, dw, mu, nu, lrs, bc1, bc2, e2, mu2, nu2, part)), *ptrs,
        n_members, n_feats, d, f32(b1), f32(1.0 - b1), f32(b2),
        f32(1.0 - b2), f32(eps), _build.stream_ptr(encoder))
    return e2, mu2, nu2, part.sum(dim=1), bias_out


# --- K4 contract: fused_tied_adam_vjp_update ---------------------------------

def _adam_update(adam, encoder, dw, mu_e, nu_e, lrs, bc1, bc2, ftile, b1,
                 b2, eps):
    if encoder.shape[1] % ftile:
        raise ValueError(f"n_feats {encoder.shape[1]} % ftile {ftile} "
                         "must be 0")
    e2, mu2, nu2, un_sq, _ = adam(encoder, dw, mu_e, nu_e, lrs, bc1, bc2,
                                  b1, b2, eps)
    return e2, mu2, nu2, un_sq


def fused_tied_adam_vjp_update(encoder, dw, mu_e, nu_e, lrs, bc1, bc2,
                               ftile: int, b1: float = 0.9,
                               b2: float = 0.999, eps: float = 1e-8):
    """Normalization VJP + exact optax Adam on the raw tied dictionary:
    (E', μ', ν', update_sq_norm [N]). Bias updates stay outside."""
    return _adam_update(sae_tied_adam_vjp, encoder, dw, mu_e, nu_e, lrs,
                        bc1, bc2, ftile, b1, b2, eps)


def fused_tied_adam_vjp_update_plain(encoder, dw, mu_e, nu_e, lrs, bc1, bc2,
                                     ftile: int, b1: float = 0.9,
                                     b2: float = 0.999, eps: float = 1e-8):
    return _adam_update(sae_tied_adam_vjp_plain, encoder, dw, mu_e, nu_e,
                        lrs, bc1, bc2, ftile, b1, b2, eps)


# --- K1 contract: fused_tied_sae_grads ----------------------------------------

def _grads(fwd, bwd, encoder, bias, alphas, batch, batch_tile, total_batch,
           compute_dtype, coef_mask):
    _, _, _, b = _tied_shapes(encoder, bias, batch)
    _check_unported(total_batch, b, compute_dtype, coef_mask)
    batch_tile = batch_tile or _build.BATCH_TILE
    if b % batch_tile:
        raise ValueError(f"batch {b} % batch_tile {batch_tile} must be 0")
    dw, db, act, loss4 = bwd(encoder, bias, alphas, batch,
                             fwd(encoder, bias, batch))
    losses = {"mse": loss4[:, 0], "l1": loss4[:, 1], "l0": loss4[:, 2]}
    return losses, dw, db, act


def fused_tied_sae_grads(encoder: torch.Tensor, bias: torch.Tensor,
                         alphas: torch.Tensor, batch: torch.Tensor,
                         batch_tile: Optional[int] = None,
                         total_batch: Optional[int] = None,
                         compute_dtype: str = "float32",
                         coef_mask: Optional[torch.Tensor] = None):
    """All-member losses and gradients wrt (normalized W, bias): (losses
    {mse, l1, l0} [N], dW [N, n, d], db [N, n], activity [N, n])."""
    return _grads(sae_tied_fwd, sae_tied_bwd, encoder, bias, alphas, batch,
                  batch_tile, total_batch, compute_dtype, coef_mask)


def fused_tied_sae_grads_plain(encoder, bias, alphas, batch, batch_tile=None,
                               total_batch=None, compute_dtype="float32",
                               coef_mask=None):
    return _grads(sae_tied_fwd_plain, sae_tied_bwd_plain, encoder, bias,
                  alphas, batch, batch_tile, total_batch, compute_dtype,
                  coef_mask)


def fused_tied_sae_loss_and_grads(params_stacked: dict, alphas, batch,
                                  batch_tile: Optional[int] = None,
                                  total_batch: Optional[int] = None,
                                  compute_dtype: str = "float32"):
    """Two-stage producer: (losses, grads wrt the raw params {encoder,
    encoder_bias}, activity)."""
    e = params_stacked["encoder"]
    batch, bt, _ = prepare_tiled_batch(batch, e.shape[1], batch_tile, None)
    losses, dw, db, activity = fused_tied_sae_grads(
        e, params_stacked["encoder_bias"], alphas, batch, batch_tile=bt,
        total_batch=total_batch, compute_dtype=compute_dtype)
    return losses, {"encoder": normalize_with_vjp(e, dw),
                    "encoder_bias": db}, activity


# --- K2 contract: fused_tied_sae_train_step -----------------------------------

def _train_step(fwd, bwd, adam, encoder, bias, mu_e, nu_e, mu_b, nu_b,
                alphas, lrs, bc1, bc2, batch, batch_tile, compute_dtype, b1,
                b2, eps):
    losses, dw, db, act = _grads(fwd, bwd, encoder, bias, alphas, batch,
                                 batch_tile, None, compute_dtype, None)
    e2, mu2, nu2, _, (bias2, mub2, nub2) = adam(
        encoder, dw, mu_e, nu_e, lrs, bc1, bc2, b1, b2, eps,
        bias=bias, db=db, mu_b=mu_b, nu_b=nu_b)
    return losses, e2, bias2, mu2, nu2, mub2, nub2, act


def fused_tied_sae_train_step(encoder, bias, mu_e, nu_e, mu_b, nu_b, alphas,
                              lrs, bc1, bc2, batch,
                              batch_tile: Optional[int] = None,
                              compute_dtype: str = "float32",
                              b1: float = 0.9, b2: float = 0.999,
                              eps: float = 1e-8):
    """One complete tied-SAE ensemble step: losses + exact grads +
    normalization VJP + per-member Adam on E and b. bc1/bc2 [N] are the
    bias corrections 1 − β^count_inc. Returns (losses {mse, l1, l0},
    E', b', μ_E', ν_E', μ_b', ν_b', activity [N, n])."""
    return _train_step(sae_tied_fwd, sae_tied_bwd, sae_tied_adam_vjp,
                       encoder, bias, mu_e, nu_e, mu_b, nu_b, alphas, lrs,
                       bc1, bc2, batch, batch_tile, compute_dtype, b1, b2,
                       eps)


def fused_tied_sae_train_step_plain(encoder, bias, mu_e, nu_e, mu_b, nu_b,
                                    alphas, lrs, bc1, bc2, batch,
                                    batch_tile=None, compute_dtype="float32",
                                    b1=0.9, b2=0.999, eps=1e-8):
    return _train_step(sae_tied_fwd_plain, sae_tied_bwd_plain,
                       sae_tied_adam_vjp_plain, encoder, bias, mu_e, nu_e,
                       mu_b, nu_b, alphas, lrs, bc1, bc2, batch, batch_tile,
                       compute_dtype, b1, b2, eps)
