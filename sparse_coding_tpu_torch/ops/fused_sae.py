"""SAE step kernels: the counterpart of the JAX package's
``ops/fused_sae.py`` for the tied, masked-tied and untied families.

The JAX package keeps a member's whole [n, d] matrix in TPU VMEM for its
untiled kernels. An H100 block has 227 KB of shared memory, so on Hopper
every contract rides the feature-tiled kernels of ``fused_sae_tiled`` plus
two hand-written epilogue kernels, ``sae_tied_adam_vjp`` and
``sae_untied_adam_vjp``:

- K1 ``fused_tied_sae_grads`` = sae_tied_fwd + sae_tied_bwd, with the
  masked family's ``coef_mask`` (the normalization VJP stays in the
  producer, as in the JAX package);
- K2 ``fused_tied_sae_train_step`` = sae_tied_fwd + sae_tied_bwd +
  sae_tied_adam_vjp with the bias rows, behind K2's signature and outputs;
- K4 ``fused_tied_adam_vjp_update`` = sae_tied_adam_vjp;
- K5 ``fused_untied_sae_grads`` = sae_untied_fwd + sae_untied_bwd (the
  bias decay and the decoder's normalization VJP stay in the producer);
- K6 ``fused_adam_vjp_update`` = sae_untied_adam_vjp.

Every kernel and contract has a plain PyTorch version beside it; a wrapper
takes the plain version only for CPU tensors. Adam is optax's
``scale_by_adam`` with eps_root=0 exactly as the kernels write it (never
torch.optim.Adam's rearranged form).

``compute_dtype="bfloat16"`` reaches the bf16 forms of the forward and
backward kernels (``fused_sae_tiled``). Moments stored bf16 (the engine's
``fused_moments_dtype="bfloat16"``, encoder and decoder leaves) take the
epilogues' bf16 forms, ``sae_tied_adam_vjp_bf16`` and
``sae_untied_adam_vjp_bf16``: read widened, updated in fp32, stored
rounded, and the update uses this step's fp32 moments, as the JAX kernels
do (``fused_sae.py`` ``_tied_train_kernel``, ``_adam_vjp_kernel``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
    _BF16,
    _check_unported,
    _float_mask,
    _losses,
    _on_cpu,
    _tied_shapes,
    _untied_shapes,
    prepare_tiled_batch,
    sae_tied_bwd,
    sae_tied_bwd_plain,
    sae_tied_fwd,
    sae_tied_fwd_plain,
    sae_untied_bwd,
    sae_untied_bwd_plain,
    sae_untied_fwd,
    sae_untied_fwd_plain,
    sum_partials,
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

def _moments(name: str, mu: torch.Tensor, nu: torch.Tensor) -> bool:
    """True for bf16-stored moments (the epilogue's bf16 form), False for
    fp32 ones; raises on a mix or any other dtype."""
    if mu.dtype != nu.dtype or mu.dtype not in (torch.float32, _BF16):
        raise ValueError(f"{name}: moments must both be float32 or both "
                         f"bfloat16, got {mu.dtype} and {nu.dtype}")
    return mu.dtype == _BF16


def sae_tied_adam_vjp_plain(encoder, dw, mu, nu, lrs, bc1, bc2,
                            b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8, bias=None, db=None,
                            mu_b=None, nu_b=None):
    """Normalization VJP + exact optax Adam on E; with the bias group also
    Adam on the bias. Returns (E', μ', ν', un_sq [N], bias_out) where
    bias_out is None or (b', μ_b', ν_b'). Moments stored bf16 are widened,
    updated in fp32 and returned rounded; the update takes the fp32
    ones."""
    de = normalize_with_vjp(encoder, dw)
    col = lambda v: v[:, None, None]
    mu2 = b1 * mu.to(torch.float32) + (1.0 - b1) * de
    nu2 = b2 * nu.to(torch.float32) + (1.0 - b2) * de * de
    u = -col(lrs) * (mu2 / col(bc1)) / (torch.sqrt(nu2 / col(bc2)) + eps)
    bias_out = None
    if bias is not None:
        mub2 = b1 * mu_b + (1.0 - b1) * db
        nub2 = b2 * nu_b + (1.0 - b2) * db * db
        bias2 = bias - lrs[:, None] * (mub2 / bc1[:, None]) / (
            torch.sqrt(nub2 / bc2[:, None]) + eps)
        bias_out = (bias2, mub2, nub2)
    return (encoder + u, mu2.to(mu.dtype), nu2.to(nu.dtype),
            (u * u).sum(dim=(1, 2)), bias_out)


def sae_tied_adam_vjp(encoder, dw, mu, nu, lrs, bc1, bc2,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      bias=None, db=None, mu_b=None, nu_b=None):
    """See :func:`sae_tied_adam_vjp_plain`. CUDA: launches
    ``sae_tied_adam_vjp`` (bf16 moments: ``sae_tied_adam_vjp_bf16``); the
    per-row update partials are summed here in a fixed order."""
    n_members, n_feats, d = encoder.shape
    bf16_moments = _moments("sae_tied_adam_vjp", mu, nu)
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
    _build.check_cuda_tensors("sae_tied_adam_vjp",
                              bf16_ok=("mu", "nu") if bf16_moments else (),
                              **tensors)
    if n_feats % _build.ADAM_ROWS:
        raise ValueError(f"sae_tied_adam_vjp: n_feats % {_build.ADAM_ROWS} "
                         "must be 0")
    e2, mu2, nu2 = (torch.empty_like(encoder), torch.empty_like(mu),
                    torch.empty_like(nu))
    part = torch.empty((n_members, n_feats), dtype=torch.float32,
                       device=encoder.device)
    bias_out = None
    ptrs = [0] * 7
    if bias is not None:
        bias_out = tuple(torch.empty_like(bias) for _ in range(3))
        ptrs = [t.data_ptr() for t in (bias, db, mu_b, nu_b, *bias_out)]
    f32 = lambda v: float(np.float32(v))
    _build.launch(
        "sae_tied_adam_vjp_bf16" if bf16_moments else "sae_tied_adam_vjp",
        *(t.data_ptr() for t in (
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

def _check_batch_tile(b, batch_tile, total_batch, compute_dtype):
    _check_unported(total_batch, b, compute_dtype)
    batch_tile = batch_tile or _build.BATCH_TILE
    if b % batch_tile:
        raise ValueError(f"batch {b} % batch_tile {batch_tile} must be 0")


def _grads(fwd, bwd, encoder, bias, alphas, batch, batch_tile, total_batch,
           compute_dtype, coef_mask):
    _, _, _, b = _tied_shapes(encoder, bias, batch)
    _check_batch_tile(b, batch_tile, total_batch, compute_dtype)
    cm = _float_mask(coef_mask)
    dw, db, act, loss4 = bwd(encoder, bias, alphas, batch,
                             fwd(encoder, bias, batch, cm, compute_dtype), cm,
                             compute_dtype, total_batch)
    return _losses(loss4), dw, db, act


def fused_tied_sae_grads(encoder: torch.Tensor, bias: torch.Tensor,
                         alphas: torch.Tensor, batch: torch.Tensor,
                         batch_tile: Optional[int] = None,
                         total_batch: Optional[int] = None,
                         compute_dtype: str = "float32",
                         coef_mask: Optional[torch.Tensor] = None):
    """All-member losses and gradients wrt (normalized W, bias): (losses
    {mse, l1, l0} [N], dW [N, n, d], db [N, n], activity [N, n]).
    ``coef_mask`` [N, n] (the masked family) zeroes the inactive
    coefficients. ``total_batch``: the global batch of a data-sharded
    call, whose outputs are partial sums to all-reduce over the data axis
    (``fused_sae_tiled._global_batch``)."""
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
                                  compute_dtype: str = "float32",
                                  coef_mask: Optional[torch.Tensor] = None,
                                  psum=None):
    """Two-stage producer for tied (and masked-tied) buckets: (losses,
    grads wrt the raw params {encoder, encoder_bias}, activity).
    ``psum`` sums a data-sharded call's partial losses and grads over the
    data axis before the normalization VJP (``sum_partials``)."""
    e = params_stacked["encoder"]
    batch, bt, _ = prepare_tiled_batch(batch, e.shape[1], batch_tile, None,
                                       compute_dtype)
    losses, dw, db, activity = fused_tied_sae_grads(
        e, params_stacked["encoder_bias"], alphas, batch, batch_tile=bt,
        total_batch=total_batch, compute_dtype=compute_dtype,
        coef_mask=coef_mask)
    losses, dw, db, activity = sum_partials(psum, losses, dw, db, activity)
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


# --- K5 contract: fused_untied_sae_grads --------------------------------------

def _untied_grads(fwd, bwd, encoder, decoder, bias, alphas, batch,
                  batch_tile, total_batch, compute_dtype):
    _, _, _, b = _untied_shapes(encoder, decoder, bias, batch)
    _check_batch_tile(b, batch_tile, total_batch, compute_dtype)
    de, dwn, db, act, loss4 = bwd(
        encoder, decoder, bias, alphas, batch,
        fwd(encoder, decoder, bias, batch, compute_dtype), compute_dtype,
        total_batch)
    return _losses(loss4), de, dwn, db, act


def fused_untied_sae_grads(encoder: torch.Tensor, decoder: torch.Tensor,
                           bias: torch.Tensor, alphas: torch.Tensor,
                           batch: torch.Tensor,
                           batch_tile: Optional[int] = None,
                           total_batch: Optional[int] = None,
                           compute_dtype: str = "float32"):
    """All-member untied-SAE losses and gradients wrt (raw encoder E,
    normalized decoder Wn, bias): (losses {mse, l1, l0} [N], dE, dWn
    [N, n, d], db [N, n], activity [N, n]). The decoder arrives raw; chain
    dWn through ``normalize_with_vjp`` for the raw-decoder grad."""
    return _untied_grads(sae_untied_fwd, sae_untied_bwd, encoder, decoder,
                         bias, alphas, batch, batch_tile, total_batch,
                         compute_dtype)


def fused_untied_sae_grads_plain(encoder, decoder, bias, alphas, batch,
                                 batch_tile=None, total_batch=None,
                                 compute_dtype="float32"):
    return _untied_grads(sae_untied_fwd_plain, sae_untied_bwd_plain, encoder,
                         decoder, bias, alphas, batch, batch_tile,
                         total_batch, compute_dtype)


def untied_bias_decay_terms(bias: torch.Tensor, bias_decays: torch.Tensor,
                            db: torch.Tensor):
    """The untied family's bias-decay loss [N] and its gradient folded
    into db, with the safe norm √(Σb² + 1e-16) (finite gradient at b = 0,
    as the JAX package's ``_safe_norm``)."""
    safe = torch.sqrt(torch.sum(bias * bias, dim=-1) + 1e-8 ** 2)
    return bias_decays * safe, db + (bias_decays / safe)[:, None] * bias


def fused_untied_sae_loss_and_grads(params_stacked: dict, alphas,
                                    bias_decays, batch,
                                    batch_tile: Optional[int] = None,
                                    total_batch: Optional[int] = None,
                                    compute_dtype: str = "float32",
                                    psum=None):
    """Two-stage producer for untied buckets: (losses incl. "bias_decay",
    grads wrt the raw params {encoder, encoder_bias, decoder}, activity).
    The bias-decay terms are added after the kernels — and after ``psum``
    sums a data-sharded call's partials —, so any bias_decay is exact and
    counts once a member."""
    e, dec = params_stacked["encoder"], params_stacked["decoder"]
    bias = params_stacked["encoder_bias"]
    batch, bt, _ = prepare_tiled_batch(batch, e.shape[1], batch_tile, None,
                                       compute_dtype)
    losses, de, dwn, db, activity = fused_untied_sae_grads(
        e, dec, bias, alphas, batch, batch_tile=bt, total_batch=total_batch,
        compute_dtype=compute_dtype)
    losses, de, dwn, db, activity = sum_partials(psum, losses, de, dwn, db,
                                                 activity)
    losses["bias_decay"], db = untied_bias_decay_terms(bias, bias_decays, db)
    return losses, {"encoder": de, "encoder_bias": db,
                    "decoder": normalize_with_vjp(dec, dwn)}, activity


# --- sae_untied_adam_vjp (K6) -------------------------------------------------

def sae_untied_adam_vjp_plain(encoder, de, mu_e, nu_e, decoder, dwn, mu_d,
                              nu_d, lrs, bc1, bc2, b1: float = 0.9,
                              b2: float = 0.999, eps: float = 1e-8):
    """Exact optax Adam on the raw encoder; the normalization VJP, then
    Adam, on the raw decoder. Returns (E', μ_E', ν_E', D', μ_D', ν_D',
    un_sq [N] = Σu_E² + Σu_D²). Moments stored bf16 are widened, updated
    in fp32 and returned rounded; each update takes the fp32 ones."""
    col = lambda v: v[:, None, None]

    def adam(p, g, mu, nu):
        mu2 = b1 * mu.to(torch.float32) + (1.0 - b1) * g
        nu2 = b2 * nu.to(torch.float32) + (1.0 - b2) * g * g
        u = -col(lrs) * (mu2 / col(bc1)) / (torch.sqrt(nu2 / col(bc2)) + eps)
        return (p + u, mu2.to(mu.dtype), nu2.to(nu.dtype),
                (u * u).sum(dim=(1, 2)))

    e2, mu_e2, nu_e2, ue = adam(encoder, de, mu_e, nu_e)
    d2, mu_d2, nu_d2, ud = adam(decoder, normalize_with_vjp(decoder, dwn),
                                mu_d, nu_d)
    return e2, mu_e2, nu_e2, d2, mu_d2, nu_d2, ue + ud


def sae_untied_adam_vjp(encoder, de, mu_e, nu_e, decoder, dwn, mu_d, nu_d,
                        lrs, bc1, bc2, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8):
    """See :func:`sae_untied_adam_vjp_plain`. CUDA: launches
    ``sae_untied_adam_vjp`` (bf16 moments: ``sae_untied_adam_vjp_bf16``);
    the per-block update partials are summed here in a fixed order."""
    n_members, n_feats, d = encoder.shape
    bf16_moments = _moments("sae_untied_adam_vjp", mu_e, nu_e)
    if _moments("sae_untied_adam_vjp", mu_d, nu_d) != bf16_moments:
        raise ValueError("sae_untied_adam_vjp: the encoder's and decoder's "
                         "moments must share one dtype")
    mats = dict(encoder=encoder, de=de, mu_e=mu_e, nu_e=nu_e,
                decoder=decoder, dwn=dwn, mu_d=mu_d, nu_d=nu_d)
    for name, t in mats.items():
        if t.shape != encoder.shape:
            raise ValueError(f"{name} must be {tuple(encoder.shape)}")
    vecs = dict(lrs=lrs, bc1=bc1, bc2=bc2)
    for name, t in vecs.items():
        if tuple(t.shape) != (n_members,):
            raise ValueError(f"{name} must be [{n_members}]")
    if _on_cpu("sae_untied_adam_vjp", *mats.values(), *vecs.values()):
        return sae_untied_adam_vjp_plain(encoder, de, mu_e, nu_e, decoder,
                                         dwn, mu_d, nu_d, lrs, bc1, bc2, b1,
                                         b2, eps)
    _build.check_cuda_tensors(
        "sae_untied_adam_vjp",
        bf16_ok=("mu_e", "nu_e", "mu_d", "nu_d") if bf16_moments else (),
        **mats, **vecs)
    if n_feats % _build.ADAM_ROWS:
        raise ValueError(f"sae_untied_adam_vjp: n_feats % "
                         f"{_build.ADAM_ROWS} must be 0")
    outs = tuple(torch.empty_like(t) for t in (encoder, mu_e, nu_e, decoder,
                                               mu_d, nu_d))
    part = torch.empty((n_members, n_feats // _build.ADAM_ROWS),
                       dtype=torch.float32, device=encoder.device)
    f32 = lambda v: float(np.float32(v))
    _build.launch(
        "sae_untied_adam_vjp_bf16" if bf16_moments else "sae_untied_adam_vjp",
        *(t.data_ptr() for t in (*mats.values(), lrs, bc1, bc2, *outs,
                                 part)), n_members, n_feats, d,
        f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(eps),
        _build.stream_ptr(encoder))
    return (*outs, part.sum(dim=1))


# --- K6 contract: fused_adam_vjp_update ---------------------------------------

def _untied_adam_update(adam, encoder, de, mu_e, nu_e, decoder, dwn, mu_d,
                        nu_d, lrs, bc1, bc2, ftile, b1, b2, eps):
    if encoder.shape[1] % ftile:
        raise ValueError(f"n_feats {encoder.shape[1]} % ftile {ftile} "
                         "must be 0")
    return adam(encoder, de, mu_e, nu_e, decoder, dwn, mu_d, nu_d, lrs, bc1,
                bc2, b1, b2, eps)


def fused_adam_vjp_update(encoder, de, mu_e, nu_e, decoder, dwn, mu_d, nu_d,
                          lrs, bc1, bc2, ftile: int, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8):
    """The untied whole-step epilogue: plain Adam on the encoder,
    normalization VJP + Adam on the raw decoder. bc1/bc2 [N] are the bias
    corrections 1 − β^count_inc. Returns (E', μ_E', ν_E', D', μ_D', ν_D',
    update_sq_norm [N]). Bias updates stay outside. ``ftile`` keeps the JAX
    divisibility contract (ValueError); the kernel blocks at its own fixed
    row tile."""
    return _untied_adam_update(sae_untied_adam_vjp, encoder, de, mu_e, nu_e,
                               decoder, dwn, mu_d, nu_d, lrs, bc1, bc2,
                               ftile, b1, b2, eps)


def fused_adam_vjp_update_plain(encoder, de, mu_e, nu_e, decoder, dwn, mu_d,
                                nu_d, lrs, bc1, bc2, ftile: int,
                                b1: float = 0.9, b2: float = 0.999,
                                eps: float = 1e-8):
    return _untied_adam_update(sae_untied_adam_vjp_plain, encoder, de, mu_e,
                               nu_e, decoder, dwn, mu_d, nu_d, lrs, bc1, bc2,
                               ftile, b1, b2, eps)
