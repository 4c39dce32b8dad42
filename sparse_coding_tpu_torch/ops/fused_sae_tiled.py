"""Feature-tiled SAE grads: the counterpart of the JAX package's
``ops/fused_sae_tiled.py`` (K3 ``tiled_tied_sae_grads``, with the masked
family's ``coef_mask``, and K7 ``tiled_untied_sae_grads``).

Four hand-written Hopper kernels (``ops/csrc``) carry it:

- ``sae_tied_fwd`` / ``sae_untied_fwd`` — x-hat summed over feature tiles
  inside one block per (member, batch tile), with the residual
  r = x-hat − x as its epilogue, so the codes never reach device memory
  and no separate residual pass runs;
- ``sae_tied_bwd`` / ``sae_untied_bwd`` — one block per (member, feature
  tile) loops over the batch in a fixed order, recomputing the code tiles
  and accumulating the weight grads, db, activity, the loss partials and
  the sentinel's grad sum of squares.

The tied pair takes an optional ``coef_mask`` [N, n] (0/1, float32): the
masked family's coefficient mask, multiplied into the codes and the ReLU
mask. The untied pair encodes with the RAW encoder and decodes with the
row-normalized decoder.

Each kernel has a plain PyTorch version beside it (``*_plain``). A wrapper
takes the plain version only for CPU tensors; on CUDA tensors it launches
its kernel or raises. The tiled paths' reported grad norm is the
KERNEL-grad norm, taken before the normalization VJP and, untied, before
the bias decay — the same quantity the JAX package reports.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ops import _build

_EPS = 1e-8


def _normalize_rows(e: torch.Tensor) -> torch.Tensor:
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                           min=_EPS)


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when none does (the kernel must launch). Mixed is an error."""
    cpu = [t.device.type == "cpu" for t in tensors]
    if all(cpu):
        return True
    if any(cpu):
        raise ValueError(f"{name}: tensors split between the CPU and "
                         f"{[t.device for t in tensors]}")
    return False


def _tied_shapes(encoder, bias, batch) -> tuple[int, int, int, int]:
    if encoder.dim() != 3:
        raise ValueError(f"encoder must be [N, n, d], got {tuple(encoder.shape)}")
    n_members, n_feats, d = encoder.shape
    if tuple(bias.shape) != (n_members, n_feats):
        raise ValueError(f"bias must be {(n_members, n_feats)}, got "
                         f"{tuple(bias.shape)}")
    if batch.dim() != 2 or batch.shape[1] != d:
        raise ValueError(f"batch must be [B, {d}], got {tuple(batch.shape)}")
    return n_members, n_feats, d, batch.shape[0]


def _untied_shapes(encoder, decoder, bias, batch):
    if decoder.shape != encoder.shape:
        raise ValueError(f"decoder must be {tuple(encoder.shape)}, got "
                         f"{tuple(decoder.shape)}")
    return _tied_shapes(encoder, bias, batch)


def _check_vec(name: str, t: Optional[torch.Tensor], shape: tuple) -> None:
    if t is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _bwd_checks(n_members, b, d, alphas, resid) -> None:
    _check_vec("alphas", alphas, (n_members,))
    _check_vec("resid", resid, (n_members, b, d))


def _mask_arg(coef_mask: Optional[torch.Tensor]):
    """The mask operand of a tied kernel: its pointer, or null."""
    return None if coef_mask is None else coef_mask.data_ptr()


def _kernel_tensors(name, b, n_feats, d, **tensors) -> None:
    _build.check_cuda_tensors(
        name, **{k: v for k, v in tensors.items() if v is not None})
    _build.check_kernel_shape(name, b, n_feats, d)


# --- sae_tied_fwd (K3a + the residual pass; masked too) -----------------------

def sae_tied_fwd_plain(encoder: torch.Tensor, bias: torch.Tensor,
                       batch: torch.Tensor,
                       coef_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """r [N, B, d] = (cm ⊙ relu(x Ŵᵀ + b)) Ŵ − x per member,
    Ŵ = E / ‖E‖_row; cm = 1 without a coef_mask."""
    w = _normalize_rows(encoder)
    c = torch.relu(torch.matmul(batch, w.transpose(1, 2)) + bias[:, None, :])
    if coef_mask is not None:
        c = c * coef_mask[:, None, :]
    return torch.matmul(c, w) - batch


def sae_tied_fwd(encoder: torch.Tensor, bias: torch.Tensor,
                 batch: torch.Tensor,
                 coef_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The residual r = x̂ − x [N, B, d] of every member; see
    :func:`sae_tied_fwd_plain`. CUDA: launches ``sae_tied_fwd``."""
    n_members, n_feats, d, b = _tied_shapes(encoder, bias, batch)
    _check_vec("coef_mask", coef_mask, (n_members, n_feats))
    extra = () if coef_mask is None else (coef_mask,)
    if _on_cpu("sae_tied_fwd", encoder, bias, batch, *extra):
        return sae_tied_fwd_plain(encoder, bias, batch, coef_mask)
    _kernel_tensors("sae_tied_fwd", b, n_feats, d, encoder=encoder,
                    bias=bias, batch=batch, coef_mask=coef_mask)
    r = torch.empty((n_members, b, d), dtype=torch.float32,
                    device=batch.device)
    _build.launch("sae_tied_fwd", batch.data_ptr(), encoder.data_ptr(),
                  bias.data_ptr(), _mask_arg(coef_mask), r.data_ptr(),
                  n_members, b, n_feats, d, _build.stream_ptr(batch))
    return r


# --- sae_tied_bwd (K3b; masked too) -------------------------------------------

def sae_tied_bwd_plain(encoder: torch.Tensor, bias: torch.Tensor,
                       alphas: torch.Tensor, batch: torch.Tensor,
                       resid: torch.Tensor,
                       coef_mask: Optional[torch.Tensor] = None):
    """Exact tied-SAE grads from the residual: (dW [N, n, d] wrt the
    normalized W, db [N, n], activity [N, n] float, loss4 [N, 4] =
    [mse, l1, l0, ΣdW² + Σdb²]). A coef_mask multiplies the codes and the
    ReLU mask, so only active coefficients count."""
    b, d = batch.shape
    w = _normalize_rows(encoder)
    pre = torch.matmul(batch, w.transpose(1, 2)) + bias[:, None, :]
    c = torch.relu(pre)
    mask = (pre > 0.0).to(torch.float32)
    if coef_mask is not None:
        c = c * coef_mask[:, None, :]
        mask = mask * coef_mask[:, None, :]
    coef = 2.0 / (b * d)
    dpre = (coef * torch.matmul(resid, w.transpose(1, 2))
            + (alphas / b)[:, None, None]) * mask
    dw = (torch.matmul(dpre.transpose(1, 2), batch)
          + coef * torch.matmul(c.transpose(1, 2), resid))
    db = dpre.sum(dim=1)
    loss4 = torch.stack([
        (resid * resid).sum(dim=(1, 2)) / (b * d),
        alphas * c.sum(dim=(1, 2)) / b,
        mask.sum(dim=(1, 2)) / b,
        (dw * dw).sum(dim=(1, 2)) + (db * db).sum(dim=1)], dim=1)
    return dw, db, mask.sum(dim=1), loss4


def sae_tied_bwd(encoder: torch.Tensor, bias: torch.Tensor,
                 alphas: torch.Tensor, batch: torch.Tensor,
                 resid: torch.Tensor,
                 coef_mask: Optional[torch.Tensor] = None):
    """See :func:`sae_tied_bwd_plain`. CUDA: launches ``sae_tied_bwd``;
    its per-(member, feature tile) loss partials are summed here in a
    fixed order."""
    n_members, n_feats, d, b = _tied_shapes(encoder, bias, batch)
    _bwd_checks(n_members, b, d, alphas, resid)
    _check_vec("coef_mask", coef_mask, (n_members, n_feats))
    extra = () if coef_mask is None else (coef_mask,)
    if _on_cpu("sae_tied_bwd", encoder, bias, alphas, batch, resid, *extra):
        return sae_tied_bwd_plain(encoder, bias, alphas, batch, resid,
                                  coef_mask)
    _kernel_tensors("sae_tied_bwd", b, n_feats, d, encoder=encoder,
                    bias=bias, alphas=alphas, batch=batch, resid=resid,
                    coef_mask=coef_mask)
    kw = {"dtype": torch.float32, "device": batch.device}
    dw = torch.empty((n_members, n_feats, d), **kw)
    db = torch.empty((n_members, n_feats), **kw)
    act = torch.empty((n_members, n_feats), **kw)
    part = torch.empty((n_members, n_feats // _build.FEAT_TILE, 4), **kw)
    coef = float(np.float32(2.0 / (b * d)))
    _build.launch("sae_tied_bwd", batch.data_ptr(), resid.data_ptr(),
                  encoder.data_ptr(), bias.data_ptr(), _mask_arg(coef_mask),
                  alphas.data_ptr(), dw.data_ptr(), db.data_ptr(),
                  act.data_ptr(), part.data_ptr(), n_members, b, n_feats, d,
                  coef, _build.stream_ptr(batch))
    return dw, db, act, part.sum(dim=1)


# --- sae_untied_fwd (K5/K7 forward + the residual pass) -----------------------

def sae_untied_fwd_plain(encoder: torch.Tensor, decoder: torch.Tensor,
                         bias: torch.Tensor,
                         batch: torch.Tensor) -> torch.Tensor:
    """r [N, B, d] = relu(x Eᵀ + b) Wn − x per member: E the RAW encoder,
    Wn = D / ‖D‖_row."""
    c = torch.relu(torch.matmul(batch, encoder.transpose(1, 2))
                   + bias[:, None, :])
    return torch.matmul(c, _normalize_rows(decoder)) - batch


def sae_untied_fwd(encoder: torch.Tensor, decoder: torch.Tensor,
                   bias: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """See :func:`sae_untied_fwd_plain`. CUDA: launches
    ``sae_untied_fwd``."""
    n_members, n_feats, d, b = _untied_shapes(encoder, decoder, bias, batch)
    if _on_cpu("sae_untied_fwd", encoder, decoder, bias, batch):
        return sae_untied_fwd_plain(encoder, decoder, bias, batch)
    _kernel_tensors("sae_untied_fwd", b, n_feats, d, encoder=encoder,
                    decoder=decoder, bias=bias, batch=batch)
    r = torch.empty((n_members, b, d), dtype=torch.float32,
                    device=batch.device)
    _build.launch("sae_untied_fwd", batch.data_ptr(), encoder.data_ptr(),
                  decoder.data_ptr(), bias.data_ptr(), r.data_ptr(),
                  n_members, b, n_feats, d, _build.stream_ptr(batch))
    return r


# --- sae_untied_bwd (K5/K7 backward) ------------------------------------------

def sae_untied_bwd_plain(encoder: torch.Tensor, decoder: torch.Tensor,
                         bias: torch.Tensor, alphas: torch.Tensor,
                         batch: torch.Tensor, resid: torch.Tensor):
    """Exact untied-SAE grads from the residual: (dE [N, n, d] wrt the raw
    encoder, dWn [N, n, d] wrt the normalized decoder, db [N, n], activity
    [N, n] float, loss4 [N, 4] = [mse, l1, l0, ΣdE² + ΣdWn² + Σdb²])."""
    b, d = batch.shape
    wn = _normalize_rows(decoder)
    pre = torch.matmul(batch, encoder.transpose(1, 2)) + bias[:, None, :]
    c = torch.relu(pre)
    mask = (pre > 0.0).to(torch.float32)
    coef = 2.0 / (b * d)
    dpre = (coef * torch.matmul(resid, wn.transpose(1, 2))
            + (alphas / b)[:, None, None]) * mask
    de = torch.matmul(dpre.transpose(1, 2), batch)
    dwn = coef * torch.matmul(c.transpose(1, 2), resid)
    db = dpre.sum(dim=1)
    loss4 = torch.stack([
        (resid * resid).sum(dim=(1, 2)) / (b * d),
        alphas * c.sum(dim=(1, 2)) / b,
        mask.sum(dim=(1, 2)) / b,
        (de * de).sum(dim=(1, 2)) + (dwn * dwn).sum(dim=(1, 2))
        + (db * db).sum(dim=1)], dim=1)
    return de, dwn, db, mask.sum(dim=1), loss4


def sae_untied_bwd(encoder: torch.Tensor, decoder: torch.Tensor,
                   bias: torch.Tensor, alphas: torch.Tensor,
                   batch: torch.Tensor, resid: torch.Tensor):
    """See :func:`sae_untied_bwd_plain`. CUDA: launches
    ``sae_untied_bwd``; its per-(member, 16-row feature tile) loss partials
    are summed here in a fixed order."""
    n_members, n_feats, d, b = _untied_shapes(encoder, decoder, bias, batch)
    _bwd_checks(n_members, b, d, alphas, resid)
    if _on_cpu("sae_untied_bwd", encoder, decoder, bias, alphas, batch,
               resid):
        return sae_untied_bwd_plain(encoder, decoder, bias, alphas, batch,
                                    resid)
    _kernel_tensors("sae_untied_bwd", b, n_feats, d, encoder=encoder,
                    decoder=decoder, bias=bias, alphas=alphas, batch=batch,
                    resid=resid)
    kw = {"dtype": torch.float32, "device": batch.device}
    de = torch.empty((n_members, n_feats, d), **kw)
    dwn = torch.empty((n_members, n_feats, d), **kw)
    db = torch.empty((n_members, n_feats), **kw)
    act = torch.empty((n_members, n_feats), **kw)
    part = torch.empty((n_members, n_feats // _build.UNTIED_FEAT_TILE, 4),
                       **kw)
    coef = float(np.float32(2.0 / (b * d)))
    _build.launch("sae_untied_bwd", batch.data_ptr(), resid.data_ptr(),
                  encoder.data_ptr(), decoder.data_ptr(), bias.data_ptr(),
                  alphas.data_ptr(), de.data_ptr(), dwn.data_ptr(),
                  db.data_ptr(), act.data_ptr(), part.data_ptr(), n_members,
                  b, n_feats, d, coef, _build.stream_ptr(batch))
    return de, dwn, db, act, part.sum(dim=1)


# --- K3 and K7 contracts ------------------------------------------------------

def _check_unported(total_batch, batch_rows, compute_dtype):
    if compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: only float32 is ported")
    if total_batch is not None and total_batch != batch_rows:
        raise NotImplementedError("total_batch != batch (data-sharded "
                                  "calls) waits for the multi-GPU slice")


def _check_tiles(b, n_feats, batch_tile, feat_tile):
    if b % batch_tile or n_feats % feat_tile:
        raise ValueError(f"batch {b} % batch_tile {batch_tile} and n_feats "
                         f"{n_feats} % feat_tile {feat_tile} must be 0")


def _float_mask(coef_mask: Optional[torch.Tensor]):
    """A contract's coef_mask (bool or 0/1) as the kernels take it."""
    return (None if coef_mask is None
            else coef_mask.to(torch.float32).contiguous())


def _losses(loss4: torch.Tensor) -> dict:
    return {"mse": loss4[:, 0], "l1": loss4[:, 1], "l0": loss4[:, 2]}


def _tiled_grads(fwd, bwd, encoder, bias, alphas, batch, batch_tile,
                 feat_tile, total_batch, compute_dtype, coef_mask):
    _, n_feats, _, b = _tied_shapes(encoder, bias, batch)
    _check_unported(total_batch, b, compute_dtype)
    _check_tiles(b, n_feats, batch_tile, feat_tile)
    cm = _float_mask(coef_mask)
    resid = fwd(encoder, bias, batch, cm)
    dw, db, act, loss4 = bwd(encoder, bias, alphas, batch, resid, cm)
    return _losses(loss4), dw, db, act, loss4[:, 3]


def tiled_tied_sae_grads(encoder: torch.Tensor, bias: torch.Tensor,
                         alphas: torch.Tensor, batch: torch.Tensor,
                         batch_tile: int, feat_tile: int,
                         total_batch: Optional[int] = None,
                         compute_dtype: str = "float32",
                         coef_mask: Optional[torch.Tensor] = None):
    """All-member tied-SAE losses and kernel gradients: (losses {mse, l1,
    l0} [N], dW [N, n, d] wrt the row-normalized W — chain through
    ``normalize_with_vjp`` for dE —, db [N, n], activity [N, n], grad_sq
    [N]). ``coef_mask`` [N, n] (the masked family) zeroes the inactive
    coefficients. ``batch_tile``/``feat_tile`` keep the JAX divisibility
    contract (ValueError); the CUDA kernels block at their own fixed
    tiles."""
    return _tiled_grads(sae_tied_fwd, sae_tied_bwd, encoder, bias, alphas,
                        batch, batch_tile, feat_tile, total_batch,
                        compute_dtype, coef_mask)


def tiled_tied_sae_grads_plain(encoder, bias, alphas, batch, batch_tile,
                               feat_tile, total_batch=None,
                               compute_dtype="float32", coef_mask=None):
    """:func:`tiled_tied_sae_grads` through the plain versions only."""
    return _tiled_grads(sae_tied_fwd_plain, sae_tied_bwd_plain, encoder,
                        bias, alphas, batch, batch_tile, feat_tile,
                        total_batch, compute_dtype, coef_mask)


def _tiled_untied_grads(fwd, bwd, encoder, decoder, bias, alphas, batch,
                        batch_tile, feat_tile, total_batch, compute_dtype):
    _, n_feats, _, b = _untied_shapes(encoder, decoder, bias, batch)
    _check_unported(total_batch, b, compute_dtype)
    _check_tiles(b, n_feats, batch_tile, feat_tile)
    resid = fwd(encoder, decoder, bias, batch)
    de, dwn, db, act, loss4 = bwd(encoder, decoder, bias, alphas, batch,
                                  resid)
    return _losses(loss4), de, dwn, db, act, loss4[:, 3]


def tiled_untied_sae_grads(encoder: torch.Tensor, decoder: torch.Tensor,
                           bias: torch.Tensor, alphas: torch.Tensor,
                           batch: torch.Tensor, batch_tile: int,
                           feat_tile: int, total_batch: Optional[int] = None,
                           compute_dtype: str = "float32"):
    """Untied tiled grads (K7): (losses, dE wrt the raw encoder, dWn wrt
    the normalized decoder, db, activity, grad_sq [N] = ΣdE² + ΣdWn² +
    Σdb²). Bias-decay terms are the caller's
    (``fused_sae.untied_bias_decay_terms``), as in the JAX package."""
    return _tiled_untied_grads(sae_untied_fwd, sae_untied_bwd, encoder,
                               decoder, bias, alphas, batch, batch_tile,
                               feat_tile, total_batch, compute_dtype)


def tiled_untied_sae_grads_plain(encoder, decoder, bias, alphas, batch,
                                 batch_tile, feat_tile, total_batch=None,
                                 compute_dtype="float32"):
    """:func:`tiled_untied_sae_grads` through the plain versions only."""
    return _tiled_untied_grads(sae_untied_fwd_plain, sae_untied_bwd_plain,
                               encoder, decoder, bias, alphas, batch,
                               batch_tile, feat_tile, total_batch,
                               compute_dtype)


# --- producer-level wrappers (ensemble entry points) -------------------------

def prepare_tiled_batch(batch: torch.Tensor, n_feats: int,
                        batch_tile: Optional[int], feat_tile: Optional[int]
                        ) -> tuple[torch.Tensor, int, int]:
    """The kernels' input contract: a contiguous float32 batch (every
    other dtype is cast; half-width streams are later work) and a (batch,
    feature) tile pair — the kernels' own tiles unless the caller pins
    one — that divides both axes."""
    batch = batch.to(torch.float32).contiguous()
    bt = batch_tile or _build.BATCH_TILE
    ft = feat_tile or _build.FEAT_TILE
    if batch.shape[0] % bt or n_feats % ft:
        raise ValueError(
            f"no (batch, feature) tile pair for batch={batch.shape[0]} "
            f"n_feats={n_feats} (batch_tile={bt}, feat_tile={ft}); use the "
            "autodiff path")
    return batch, bt, ft


def fused_tied_sae_tiled_loss_and_grads(
        params_stacked: dict, alphas: torch.Tensor, batch: torch.Tensor,
        batch_tile: Optional[int] = None, feat_tile: Optional[int] = None,
        total_batch: Optional[int] = None, compute_dtype: str = "float32",
        coef_mask: Optional[torch.Tensor] = None):
    """Tiled-path producer for tied (and masked-tied) buckets: (losses,
    grads wrt the raw params {encoder, encoder_bias}, activity,
    kernel-grad norm [N])."""
    from sparse_coding_tpu_torch.ops.fused_sae import normalize_with_vjp

    e = params_stacked["encoder"]
    batch, bt, ft = prepare_tiled_batch(batch, e.shape[1], batch_tile,
                                        feat_tile)
    losses, dw, db, activity, grad_sq = tiled_tied_sae_grads(
        e, params_stacked["encoder_bias"], alphas, batch, batch_tile=bt,
        feat_tile=ft, total_batch=total_batch, compute_dtype=compute_dtype,
        coef_mask=coef_mask)
    grads = {"encoder": normalize_with_vjp(e, dw), "encoder_bias": db}
    return losses, grads, activity, torch.sqrt(grad_sq)


def fused_untied_sae_tiled_loss_and_grads(
        params_stacked: dict, alphas: torch.Tensor,
        bias_decays: torch.Tensor, batch: torch.Tensor,
        batch_tile: Optional[int] = None, feat_tile: Optional[int] = None,
        total_batch: Optional[int] = None, compute_dtype: str = "float32"):
    """Tiled-path producer for untied buckets: (losses incl. "bias_decay",
    grads wrt the raw params {encoder, encoder_bias, decoder}, activity,
    kernel-grad norm [N] — taken before the bias decay and the decoder's
    normalization VJP). The batch-independent bias-decay terms are added
    after the kernels, once per member."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        normalize_with_vjp,
        untied_bias_decay_terms,
    )

    e, dec = params_stacked["encoder"], params_stacked["decoder"]
    bias = params_stacked["encoder_bias"]
    batch, bt, ft = prepare_tiled_batch(batch, e.shape[1], batch_tile,
                                        feat_tile)
    losses, de, dwn, db, activity, grad_sq = tiled_untied_sae_grads(
        e, dec, bias, alphas, batch, batch_tile=bt, feat_tile=ft,
        total_batch=total_batch, compute_dtype=compute_dtype)
    losses["bias_decay"], db = untied_bias_decay_terms(bias, bias_decays, db)
    grads = {"encoder": de, "encoder_bias": db,
             "decoder": normalize_with_vjp(dec, dwn)}
    return losses, grads, activity, torch.sqrt(grad_sq)
