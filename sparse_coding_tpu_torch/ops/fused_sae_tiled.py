"""Feature-tiled SAE grads: the counterpart of the JAX package's
``ops/fused_sae_tiled.py`` (K3 ``tiled_tied_sae_grads``, with the masked
family's ``coef_mask``, and K7 ``tiled_untied_sae_grads``).

Four hand-written Hopper kernels (``ops/csrc``) carry it:

- ``sae_tied_fwd`` — the normalized dictionary written once, then the
  members in chunks whose codes (stored feature-major, times the
  coefficient mask) fit a workspace capped at ``WORKSPACE_BYTES`` (1 GiB;
  a member too large for it alone runs in row chunks): per chunk two
  member-batched fp32 products, the codes and the decode with the
  residual r = x-hat − x as its epilogue, so no separate residual pass
  runs;
- ``sae_tied_bwd`` — the normalized dictionary written once, then the
  members in chunks whose codes C and dpre G fit a workspace under the
  same cap (a member too large for it alone runs in batch chunks, added
  in order): per chunk four member-batched fp32 products with fused
  epilogues (C, G, then dW = Gᵀx + coef·Cᵀr) and the per-feature sums;
  then the loss terms and the sentinel's grad sum of squares;
- ``sae_untied_fwd`` — ``sae_tied_fwd``'s schedule with the codes from the
  raw encoder and the decode through the normalized decoder;
- ``sae_untied_bwd`` — ``sae_tied_bwd``'s schedule with two weights: the
  codes from the raw encoder, dpre through the normalized decoder, and
  two weight-grad products (dE, dWn).

The tied pair takes an optional ``coef_mask`` [N, n] (0/1, float32): the
masked family's coefficient mask, multiplied into the codes and the ReLU
mask. The untied pair encodes with the RAW encoder and decodes with the
row-normalized decoder.

Each kernel has a plain PyTorch version beside it (``*_plain``). A wrapper
takes the plain version (the untied backward: its chunk schedule in plain
torch) only for CPU tensors; on CUDA tensors it launches its kernel or
raises. The tiled paths' reported grad norm is the KERNEL-grad norm, taken
before the normalization VJP and, untied, before the bias decay — the
same quantity the JAX package reports.
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


# --- the chunked kernels' workspace ------------------------------------------

# The chunked kernels keep the codes of one chunk — Z members x rows batch
# rows: the forwards' Cᵀ [Z, n, rows] fp32, the backwards' C and dpre G
# [Z, rows, n] fp32 each — in a device workspace of at most this many
# bytes; the whole [N, B, n] codes are never formed.
WORKSPACE_BYTES = 2**30
# Slices a member's loss reductions are split into in the backwards (a
# fixed number, so the order of every sum depends on the shape alone).
LOSS_SLICES = 16


def _member_chunks(n_members: int, batch: int, n_feats: int,
                   code_bytes: int, cap: int
                   ) -> list[tuple[int, int, int, int]]:
    """Chunks (m_lo, m_hi, b_lo, b_hi) of a workspace of ``code_bytes`` a
    (member, row, feature) capped at ``cap``: whole members, as many a
    chunk as fit (the last chunk may hold fewer); a member too large alone
    in row chunks of the largest multiple of 32 rows that fits (at least
    32; the last may be shorter)."""
    member_bytes = code_bytes * batch * n_feats
    if member_bytes <= cap:
        z = min(n_members, cap // member_bytes)
        return [(m, min(m + z, n_members), 0, batch)
                for m in range(0, n_members, z)]
    rows = max(32, cap // (code_bytes * n_feats) // 32 * 32)
    return [(m, m + 1, lo, min(lo + rows, batch)) for m in range(n_members)
            for lo in range(0, batch, rows)]


def bwd_chunks(n_members: int, batch: int,
               n_feats: int) -> list[tuple[int, int, int, int]]:
    """The chunks (m_lo, m_hi, b_lo, b_hi) of both backwards
    (sae_tied_bwd, sae_untied_bwd), in the order they run: whole members,
    as many a chunk as WORKSPACE_BYTES holds of their C and G (the last
    chunk may hold fewer); a member whose C and G alone exceed it runs in
    batch chunks of the largest multiple of 32 rows that fits (the last
    may be shorter), added in order. All 32 members in one chunk at the
    canonical shape (B = n = 2048), 8 a chunk at n = 8192, 4 a chunk at
    the masked family's n = 16,384."""
    return _member_chunks(n_members, batch, n_feats, 2 * 4, WORKSPACE_BYTES)


def fwd_chunks(n_members: int, batch: int,
               n_feats: int) -> list[tuple[int, int, int, int]]:
    """The chunks (m_lo, m_hi, b_lo, b_hi) of both forwards (sae_tied_fwd,
    sae_untied_fwd), in the order they run: whole members, as many a chunk
    as WORKSPACE_BYTES holds of their codes (the last chunk may hold
    fewer); a member whose codes alone exceed it runs in row chunks of the
    largest multiple of 32 rows that fits (the last may be shorter), each
    writing its own rows of r. All 32 members in one chunk at the canonical
    shape (B = n = 2048), 16 a chunk at n = 8192, and the masked family's 7
    members of n = 16,384 in one."""
    return _member_chunks(n_members, batch, n_feats, 4, WORKSPACE_BYTES)


def _chunked_fwd(kernel: str, n_members: int, n_feats: int,
                 batch: torch.Tensor, codes, decode) -> torch.Tensor:
    """A forward's chunk loop on the card: per chunk of :func:`fwd_chunks`,
    ``codes(ms, xk, ct)`` then ``decode(ms, xk, ct, rk)`` for the member
    slice ``ms``, the chunk's rows ``xk`` of the batch, the workspace
    ``ct`` and the chunk's [Z, rows, d] slice ``rk`` of the residual; then
    one call of ``kernel`` counted. Returns r [N, B, d]."""
    b, d = batch.shape
    kw = {"dtype": torch.float32, "device": batch.device}
    r = torch.empty((n_members, b, d), **kw)
    chunks = fwd_chunks(n_members, b, n_feats)
    ct = torch.empty((max((mh - ml) * (bh - bl) for ml, mh, bl, bh
                          in chunks) * n_feats,), **kw)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms = slice(m_lo, m_hi)
        xk = batch[b_lo:b_hi]
        codes(ms, xk, ct)
        decode(ms, xk, ct, r[ms, b_lo:b_hi])
    _build.LAUNCHES[kernel] += 1
    return r


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


# The launches of the tied forward (csrc/sae_tied_fwd.cu), one helper
# each. A chunk's operands are slices at its first member (and row): the
# residual slice keeps the whole batch's member stride.

def tied_fwd_norms(encoder, w) -> None:
    """w [N, n, d] = E / max(‖E_f‖, 1e-8) for every dictionary row."""
    _build.launch("sae_tied_fwd_norms", encoder.data_ptr(), w.data_ptr(),
                  encoder.numel() // encoder.shape[-1], encoder.shape[-1],
                  _build.stream_ptr(w))


def tied_fwd_codes(xk, w, bias, coef_mask, ct) -> None:
    """Cᵀ [Z, n, rows] = cm·relu(Ŵ·xkᵀ + b) into the workspace ``ct``, for
    the Z members of ``w`` [Z, n, d]; ``coef_mask`` [Z, n] or None."""
    z, n, d = w.shape
    _build.launch("sae_tied_fwd_codes", xk.data_ptr(), w.data_ptr(),
                  bias.data_ptr(), _mask_arg(coef_mask), ct.data_ptr(), z,
                  xk.shape[0], n, d, _build.stream_ptr(xk))


def tied_fwd_decode(ct, w, xk, rk, batch: int) -> None:
    """rk = Cᵀᵀ·Ŵ − xk into ``rk``, the [Z, rows, d] slice of the
    [N, B, d] residual, for the Z members of ``w`` [Z, n, d]."""
    z, n, d = w.shape
    _build.launch("sae_tied_fwd_decode", ct.data_ptr(), w.data_ptr(),
                  xk.data_ptr(), rk.data_ptr(), z, xk.shape[0], n, d, batch,
                  _build.stream_ptr(xk))


def sae_tied_fwd(encoder: torch.Tensor, bias: torch.Tensor,
                 batch: torch.Tensor,
                 coef_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The residual r = x̂ − x [N, B, d] of every member; see
    :func:`sae_tied_fwd_plain`. CUDA: the normalized dictionary, then per
    chunk of :func:`fwd_chunks` the launches ``tied_fwd_codes`` and
    ``tied_fwd_decode``; counts one ``sae_tied_fwd`` call. CPU: the plain
    version (the chunks write disjoint rows of r and sum nothing across one
    another)."""
    n_members, n_feats, d, b = _tied_shapes(encoder, bias, batch)
    _check_vec("coef_mask", coef_mask, (n_members, n_feats))
    extra = () if coef_mask is None else (coef_mask,)
    if _on_cpu("sae_tied_fwd", encoder, bias, batch, *extra):
        return sae_tied_fwd_plain(encoder, bias, batch, coef_mask)
    _kernel_tensors("sae_tied_fwd", b, n_feats, d, encoder=encoder,
                    bias=bias, batch=batch, coef_mask=coef_mask)
    w = torch.empty_like(encoder)
    tied_fwd_norms(encoder, w)
    return _chunked_fwd(
        "sae_tied_fwd", n_members, n_feats, batch,
        lambda ms, xk, ct: tied_fwd_codes(
            xk, w[ms], bias[ms],
            None if coef_mask is None else coef_mask[ms], ct),
        lambda ms, xk, ct, rk: tied_fwd_decode(ct, w[ms], xk, rk, b))


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


# The launches of the tied backward (csrc/sae_tied_bwd.cu), one helper
# each. A chunk's operands are slices at its first member (and row): the
# residual slice keeps the whole batch's member stride.

def tied_bwd_norms(encoder, w) -> None:
    """w [N, n, d] = E / max(‖E_f‖, 1e-8) for every dictionary row."""
    _build.launch("sae_tied_bwd_norms", encoder.data_ptr(), w.data_ptr(),
                  encoder.numel() // encoder.shape[-1], encoder.shape[-1],
                  _build.stream_ptr(w))


def tied_bwd_codes(xk, w, bias, coef_mask, c) -> None:
    """C [Z, rows, n] = cm·relu(xk·Ŵᵀ + b) into the workspace ``c``, for
    the Z members of ``w`` [Z, n, d]; ``coef_mask`` [Z, n] or None."""
    z, n, d = w.shape
    _build.launch("sae_tied_bwd_codes", xk.data_ptr(), w.data_ptr(),
                  bias.data_ptr(), _mask_arg(coef_mask), c.data_ptr(), z,
                  xk.shape[0], n, d, _build.stream_ptr(xk))


def tied_bwd_dpre(rk, w, c, alphas, g, batch: int, coef: float) -> None:
    """G [Z, rows, n] = (coef·(rk·Ŵᵀ) + α/B)·[C > 0] into ``g``; rk is the
    [Z, rows, d] slice of the [N, B, d] residual."""
    z, rows, d = rk.shape
    _build.launch("sae_tied_bwd_dpre", rk.data_ptr(), w.data_ptr(),
                  c.data_ptr(), alphas.data_ptr(), g.data_ptr(), z, rows,
                  w.shape[1], d, batch, coef, _build.stream_ptr(rk))


def tied_bwd_dwx(xk, g, dw, first: bool) -> None:
    """dW [Z, n, d] = (0 if first else dW) + Gᵀ·xk."""
    z, n, d = dw.shape
    _build.launch("sae_tied_bwd_dwx", xk.data_ptr(), g.data_ptr(),
                  dw.data_ptr(), z, xk.shape[0], n, d, int(first),
                  _build.stream_ptr(xk))


def tied_bwd_dwr(c, rk, dw, batch: int, coef: float) -> None:
    """dW [Z, n, d] = dW + coef·(Cᵀ·rk)."""
    z, rows, d = rk.shape
    _build.launch("sae_tied_bwd_dwr", c.data_ptr(), rk.data_ptr(),
                  dw.data_ptr(), z, rows, dw.shape[1], d, batch, coef,
                  _build.stream_ptr(rk))


def tied_bwd_sums(c, g, rows: int, db, act, csum, first: bool) -> None:
    """db, act, csum [Z, n] (+)= the column sums of G, [C > 0] and C over
    the chunk's ``rows`` rows."""
    z, n = db.shape
    _build.launch("sae_tied_bwd_sums", c.data_ptr(), g.data_ptr(),
                  db.data_ptr(), act.data_ptr(), csum.data_ptr(), z, rows, n,
                  int(first), _build.stream_ptr(db))


def tied_bwd_loss(resid, dw, db, act, csum, alphas, part, loss4) -> None:
    """loss4 [N, 4] from the residual and the finished grads and sums;
    ``part`` is an [N, slices, 2] scratch."""
    n_members, b, d = resid.shape
    _build.launch("sae_tied_bwd_loss", resid.data_ptr(), dw.data_ptr(),
                  db.data_ptr(), act.data_ptr(), csum.data_ptr(),
                  alphas.data_ptr(), part.data_ptr(), loss4.data_ptr(),
                  n_members, b, dw.shape[1], d, part.shape[1],
                  _build.stream_ptr(resid))


def sae_tied_bwd(encoder: torch.Tensor, bias: torch.Tensor,
                 alphas: torch.Tensor, batch: torch.Tensor,
                 resid: torch.Tensor,
                 coef_mask: Optional[torch.Tensor] = None):
    """See :func:`sae_tied_bwd_plain` for the outputs. CUDA: the normalized
    dictionary, then per chunk of :func:`bwd_chunks` the launches
    ``tied_bwd_codes``, ``_dpre``, ``_dwx``, ``_dwr``, ``_sums`` in order,
    then ``tied_bwd_loss``; counts one ``sae_tied_bwd`` call. CPU: the
    plain version."""
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
    w = torch.empty((n_members, n_feats, d), **kw)
    db, act, csum = (torch.empty((n_members, n_feats), **kw)
                     for _ in range(3))
    loss4 = torch.empty((n_members, 4), **kw)
    part = torch.empty((n_members, LOSS_SLICES, 2), **kw)
    chunks = bwd_chunks(n_members, b, n_feats)
    ws = torch.empty((2, max((mh - ml) * (bh - bl) for ml, mh, bl, bh
                             in chunks) * n_feats), **kw)
    c, g = ws[0], ws[1]
    coef = float(np.float32(2.0 / (b * d)))
    tied_bwd_norms(encoder, w)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms = slice(m_lo, m_hi)
        xk, rk = batch[b_lo:b_hi], resid[ms, b_lo:b_hi]
        cm = None if coef_mask is None else coef_mask[ms]
        tied_bwd_codes(xk, w[ms], bias[ms], cm, c)
        tied_bwd_dpre(rk, w[ms], c, alphas[ms], g, b, coef)
        tied_bwd_dwx(xk, g, dw[ms], b_lo == 0)
        tied_bwd_dwr(c, rk, dw[ms], b, coef)
        tied_bwd_sums(c, g, b_hi - b_lo, db[ms], act[ms], csum[ms],
                      b_lo == 0)
    tied_bwd_loss(resid, dw, db, act, csum, alphas, part, loss4)
    _build.LAUNCHES["sae_tied_bwd"] += 1
    return dw, db, act, loss4


# --- sae_untied_fwd (K5/K7 forward + the residual pass) -----------------------

def sae_untied_fwd_plain(encoder: torch.Tensor, decoder: torch.Tensor,
                         bias: torch.Tensor,
                         batch: torch.Tensor) -> torch.Tensor:
    """r [N, B, d] = relu(x Eᵀ + b) Wn − x per member: E the RAW encoder,
    Wn = D / ‖D‖_row."""
    c = torch.relu(torch.matmul(batch, encoder.transpose(1, 2))
                   + bias[:, None, :])
    return torch.matmul(c, _normalize_rows(decoder)) - batch


# The launches of the untied forward (csrc/sae_untied_fwd.cu), one helper
# each. A chunk's operands are slices at its first member (and row): the
# residual slice keeps the whole batch's member stride.

def untied_fwd_norms(decoder, wn) -> None:
    """wn [N, n, d] = D / max(‖D_f‖, 1e-8) for every decoder row."""
    _build.launch("sae_untied_fwd_norms", decoder.data_ptr(), wn.data_ptr(),
                  decoder.numel() // decoder.shape[-1], decoder.shape[-1],
                  _build.stream_ptr(wn))


def untied_fwd_codes(xk, encoder, bias, ct) -> None:
    """Cᵀ [Z, n, rows] = relu(E·xkᵀ + b) into the workspace ``ct``, for the
    Z members of ``encoder`` [Z, n, d]."""
    z, n, d = encoder.shape
    _build.launch("sae_untied_fwd_codes", xk.data_ptr(), encoder.data_ptr(),
                  bias.data_ptr(), ct.data_ptr(), z, xk.shape[0], n, d,
                  _build.stream_ptr(xk))


def untied_fwd_decode(ct, wn, xk, rk, batch: int) -> None:
    """rk = Cᵀᵀ·Wn − xk into ``rk``, the [Z, rows, d] slice of the
    [N, B, d] residual, for the Z members of ``wn`` [Z, n, d]."""
    z, n, d = wn.shape
    _build.launch("sae_untied_fwd_decode", ct.data_ptr(), wn.data_ptr(),
                  xk.data_ptr(), rk.data_ptr(), z, xk.shape[0], n, d, batch,
                  _build.stream_ptr(xk))


def sae_untied_fwd(encoder: torch.Tensor, decoder: torch.Tensor,
                   bias: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """See :func:`sae_untied_fwd_plain`. CUDA: the normalized decoder, then
    per chunk of :func:`fwd_chunks` the launches ``untied_fwd_codes`` and
    ``untied_fwd_decode``; counts one ``sae_untied_fwd`` call. CPU: the
    plain version (the chunks write disjoint rows of r and sum nothing
    across one another, so their schedule leaves nothing for a plain twin
    to mirror)."""
    n_members, n_feats, d, b = _untied_shapes(encoder, decoder, bias, batch)
    if _on_cpu("sae_untied_fwd", encoder, decoder, bias, batch):
        return sae_untied_fwd_plain(encoder, decoder, bias, batch)
    _kernel_tensors("sae_untied_fwd", b, n_feats, d, encoder=encoder,
                    decoder=decoder, bias=bias, batch=batch)
    wn = torch.empty_like(decoder)
    untied_fwd_norms(decoder, wn)
    return _chunked_fwd(
        "sae_untied_fwd", n_members, n_feats, batch,
        lambda ms, xk, ct: untied_fwd_codes(xk, encoder[ms], bias[ms], ct),
        lambda ms, xk, ct, rk: untied_fwd_decode(ct, wn[ms], xk, rk, b))


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


def _untied_bwd_chunked_plain(encoder, decoder, bias, alphas, batch, resid):
    """The kernels' chunk schedule in plain torch (the CPU twin of
    :func:`sae_untied_bwd`): per chunk the codes, dpre — the decoder's
    clipped row norms divided out of the finished dot products, as the
    kernel does —, the two weight-grad products and the per-feature sums,
    the batch chunks of a member added in order; then the loss terms, with
    l1 and l0 as double sums of the per-feature sums."""
    n_members, n_feats, d = encoder.shape
    b = batch.shape[0]
    coef = 2.0 / (b * d)
    nrm = torch.clamp(torch.linalg.vector_norm(decoder, dim=-1), min=_EPS)
    de, dwn = torch.empty_like(encoder), torch.empty_like(encoder)
    sums = encoder.new_empty((3, n_members, n_feats))  # db, act, Σ_b c
    for m_lo, m_hi, b_lo, b_hi in bwd_chunks(n_members, b, n_feats):
        ms = slice(m_lo, m_hi)
        xk, rk = batch[b_lo:b_hi], resid[ms, b_lo:b_hi]
        c = torch.relu(torch.matmul(xk, encoder[ms].transpose(1, 2))
                       + bias[ms, None, :])
        mask = (c > 0.0).to(torch.float32)  # = [pre > 0], NaN included
        q = torch.matmul(rk, decoder[ms].transpose(1, 2)) / nrm[ms, None, :]
        g = (coef * q + (alphas[ms] / b)[:, None, None]) * mask
        part = (torch.matmul(g.transpose(1, 2), xk),
                torch.matmul(c.transpose(1, 2), rk),
                torch.stack([g.sum(dim=1), mask.sum(dim=1), c.sum(dim=1)]))
        if b_lo == 0:
            de[ms], dwn[ms], sums[:, ms] = part
        else:
            de[ms] += part[0]
            dwn[ms] += part[1]
            sums[:, ms] += part[2]
    dwn = coef * dwn
    db, act, csum = sums
    loss4 = torch.stack([
        (resid * resid).sum(dim=(1, 2)) / (b * d),
        alphas * csum.double().sum(dim=1).float() / b,
        act.double().sum(dim=1).float() / b,
        (de * de).sum(dim=(1, 2)) + (dwn * dwn).sum(dim=(1, 2))
        + (db * db).sum(dim=1)], dim=1)
    return de, dwn, db, act, loss4


# The launches of the untied backward (csrc/sae_untied_bwd.cu), one helper
# each. A chunk's operands are slices at its first member (and row): the
# residual slice keeps the whole batch's member stride.

def untied_bwd_norms(decoder, nrm) -> None:
    """nrm [N, n] = max(‖D_f‖, 1e-8) for every decoder row."""
    _build.launch("sae_untied_bwd_norms", decoder.data_ptr(), nrm.data_ptr(),
                  nrm.numel(), decoder.shape[-1], _build.stream_ptr(nrm))


def untied_bwd_codes(xk, encoder, bias, c) -> None:
    """C [Z, rows, n] = relu(xk·Eᵀ + b) into the workspace ``c``, for the
    Z members of ``encoder`` [Z, n, d]."""
    z, n, d = encoder.shape
    _build.launch("sae_untied_bwd_codes", xk.data_ptr(), encoder.data_ptr(),
                  bias.data_ptr(), c.data_ptr(), z, xk.shape[0], n, d,
                  _build.stream_ptr(xk))


def untied_bwd_dpre(rk, decoder, nrm, c, alphas, g, batch: int,
                    coef: float) -> None:
    """G [Z, rows, n] = (coef·(rk·Dᵀ)/nrm + α/B)·[C > 0] into ``g``; rk is
    the [Z, rows, d] slice of the [N, B, d] residual."""
    z, rows, d = rk.shape
    _build.launch("sae_untied_bwd_dpre", rk.data_ptr(), decoder.data_ptr(),
                  nrm.data_ptr(), c.data_ptr(), alphas.data_ptr(),
                  g.data_ptr(), z, rows, decoder.shape[1], d, batch, coef,
                  _build.stream_ptr(rk))


def untied_bwd_de(xk, g, de, first: bool) -> None:
    """dE [Z, n, d] = (0 if first else dE) + Gᵀ·xk."""
    z, n, d = de.shape
    _build.launch("sae_untied_bwd_de", xk.data_ptr(), g.data_ptr(),
                  de.data_ptr(), z, xk.shape[0], n, d, int(first),
                  _build.stream_ptr(xk))


def untied_bwd_dwn(c, rk, dwn, batch: int, first: bool, last: bool,
                   coef: float) -> None:
    """dWn [Z, n, d] = (0 if first else dWn) + Cᵀ·rk, times coef when
    last."""
    z, rows, d = rk.shape
    _build.launch("sae_untied_bwd_dwn", c.data_ptr(), rk.data_ptr(),
                  dwn.data_ptr(), z, rows, dwn.shape[1], d, batch,
                  int(first), int(last), coef, _build.stream_ptr(rk))


def untied_bwd_sums(c, g, rows: int, db, act, csum, first: bool) -> None:
    """db, act, csum [Z, n] (+)= the column sums of G, [C > 0] and C over
    the chunk's ``rows`` rows."""
    z, n = db.shape
    _build.launch("sae_untied_bwd_sums", c.data_ptr(), g.data_ptr(),
                  db.data_ptr(), act.data_ptr(), csum.data_ptr(), z, rows, n,
                  int(first), _build.stream_ptr(db))


def untied_bwd_loss(resid, de, dwn, db, act, csum, alphas, part,
                    loss4) -> None:
    """loss4 [N, 4] from the residual and the finished grads and sums;
    ``part`` is an [N, slices, 2] scratch."""
    n_members, b, d = resid.shape
    _build.launch("sae_untied_bwd_loss", resid.data_ptr(), de.data_ptr(),
                  dwn.data_ptr(), db.data_ptr(), act.data_ptr(),
                  csum.data_ptr(), alphas.data_ptr(), part.data_ptr(),
                  loss4.data_ptr(), n_members, b, de.shape[1], d,
                  part.shape[1], _build.stream_ptr(resid))


def sae_untied_bwd(encoder: torch.Tensor, decoder: torch.Tensor,
                   bias: torch.Tensor, alphas: torch.Tensor,
                   batch: torch.Tensor, resid: torch.Tensor):
    """See :func:`sae_untied_bwd_plain` for the outputs. CUDA: the decoder's
    row norms, then per chunk of :func:`bwd_chunks` the launches
    ``untied_bwd_codes``, ``_dpre``, ``_de``, ``_dwn``, ``_sums`` in order,
    then ``untied_bwd_loss``; counts one ``sae_untied_bwd`` call. CPU: the
    same chunk schedule in plain torch."""
    n_members, n_feats, d, b = _untied_shapes(encoder, decoder, bias, batch)
    _bwd_checks(n_members, b, d, alphas, resid)
    if _on_cpu("sae_untied_bwd", encoder, decoder, bias, alphas, batch,
               resid):
        return _untied_bwd_chunked_plain(encoder, decoder, bias, alphas,
                                         batch, resid)
    _kernel_tensors("sae_untied_bwd", b, n_feats, d, encoder=encoder,
                    decoder=decoder, bias=bias, alphas=alphas, batch=batch,
                    resid=resid)
    kw = {"dtype": torch.float32, "device": batch.device}
    de = torch.empty((n_members, n_feats, d), **kw)
    dwn = torch.empty((n_members, n_feats, d), **kw)
    db, act, csum, nrm = (torch.empty((n_members, n_feats), **kw)
                          for _ in range(4))
    loss4 = torch.empty((n_members, 4), **kw)
    part = torch.empty((n_members, LOSS_SLICES, 2), **kw)
    chunks = bwd_chunks(n_members, b, n_feats)
    ws = torch.empty((2, max((mh - ml) * (bh - bl) for ml, mh, bl, bh
                             in chunks) * n_feats), **kw)
    c, g = ws[0], ws[1]
    coef = float(np.float32(2.0 / (b * d)))
    untied_bwd_norms(decoder, nrm)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms = slice(m_lo, m_hi)
        first, last = b_lo == 0, b_hi == b
        xk, rk = batch[b_lo:b_hi], resid[ms, b_lo:b_hi]
        untied_bwd_codes(xk, encoder[ms], bias[ms], c)
        untied_bwd_dpre(rk, decoder[ms], nrm[ms], c, alphas[ms], g, b, coef)
        untied_bwd_de(xk, g, de[ms], first)
        untied_bwd_dwn(c, rk, dwn[ms], b, first, last, coef)
        untied_bwd_sums(c, g, b_hi - b_lo, db[ms], act[ms], csum[ms], first)
    untied_bwd_loss(resid, de, dwn, db, act, csum, alphas, part, loss4)
    _build.LAUNCHES["sae_untied_bwd"] += 1
    return de, dwn, db, act, loss4


# --- the chunked kernels' launches, one by one -------------------------------

def one_chunk_launches(kernel: str, encoder: torch.Tensor, bias: torch.Tensor,
                       batch: torch.Tensor, *,
                       decoder: Optional[torch.Tensor] = None,
                       alphas: Optional[torch.Tensor] = None,
                       resid: Optional[torch.Tensor] = None) -> dict:
    """{part: (launch, FLOPs)} for every launch of the chunked kernel
    ``kernel`` (``sae_tied_fwd``, ``sae_tied_bwd``, ``sae_untied_fwd`` or
    ``sae_untied_bwd``),
    in the order a call runs them, on one chunk holding every member and
    batch row of these CUDA inputs; the outputs and the workspace are
    allocated here (a chunk's worth: 2·N·B·n floats for a backward). Each
    launch writes only its own buffers, so any one of them can be timed
    alone once the earlier ones have run. FLOPs counts the products'
    multiply-adds twice, 0 for the norm, sums and loss passes. The
    untied forward takes ``decoder``; the backwards ``alphas`` and
    ``resid``, the untied one ``decoder`` too. The tied kernels run
    without a coef_mask here."""
    n_m, n, d = encoder.shape
    b = batch.shape[0]
    kw = {"dtype": torch.float32, "device": batch.device}
    full = lambda: torch.empty((n_m, n, d), **kw)
    gemm = 2.0 * n_m * b * n * d
    if kernel in ("sae_tied_fwd", "sae_untied_fwd"):
        wn, ct = full(), torch.empty((n_m * n * b,), **kw)
        r = torch.empty((n_m, b, d), **kw)
        if kernel == "sae_tied_fwd":
            return {
                "sae_tied_fwd_norms": (lambda: tied_fwd_norms(encoder, wn),
                                       0.0),
                "sae_tied_fwd_codes": (
                    lambda: tied_fwd_codes(batch, wn, bias, None, ct), gemm),
                "sae_tied_fwd_decode": (
                    lambda: tied_fwd_decode(ct, wn, batch, r, b), gemm)}
        return {
            "sae_untied_fwd_norms": (lambda: untied_fwd_norms(decoder, wn),
                                     0.0),
            "sae_untied_fwd_codes": (
                lambda: untied_fwd_codes(batch, encoder, bias, ct), gemm),
            "sae_untied_fwd_decode": (
                lambda: untied_fwd_decode(ct, wn, batch, r, b), gemm)}
    c, g = (torch.empty((n_m, b, n), **kw) for _ in range(2))
    db, act, csum = (torch.empty((n_m, n), **kw) for _ in range(3))
    part = torch.empty((n_m, LOSS_SLICES, 2), **kw)
    loss4 = torch.empty((n_m, 4), **kw)
    coef = float(np.float32(2.0 / (b * d)))
    if kernel == "sae_tied_bwd":
        w, dw = full(), full()
        return {
            "sae_tied_bwd_norms": (lambda: tied_bwd_norms(encoder, w), 0.0),
            "sae_tied_bwd_codes": (
                lambda: tied_bwd_codes(batch, w, bias, None, c), gemm),
            "sae_tied_bwd_dpre": (
                lambda: tied_bwd_dpre(resid, w, c, alphas, g, b, coef), gemm),
            "sae_tied_bwd_dwx": (lambda: tied_bwd_dwx(batch, g, dw, True),
                                 gemm),
            "sae_tied_bwd_dwr": (
                lambda: tied_bwd_dwr(c, resid, dw, b, coef), gemm),
            "sae_tied_bwd_sums": (
                lambda: tied_bwd_sums(c, g, b, db, act, csum, True), 0.0),
            "sae_tied_bwd_loss": (
                lambda: tied_bwd_loss(resid, dw, db, act, csum, alphas, part,
                                      loss4), 0.0)}
    if kernel != "sae_untied_bwd":
        raise ValueError(f"{kernel} is not a chunked ensemble kernel")
    de, dwn = full(), full()
    nrm = torch.empty((n_m, n), **kw)
    return {
        "sae_untied_bwd_norms": (lambda: untied_bwd_norms(decoder, nrm), 0.0),
        "sae_untied_bwd_codes": (
            lambda: untied_bwd_codes(batch, encoder, bias, c), gemm),
        "sae_untied_bwd_dpre": (
            lambda: untied_bwd_dpre(resid, decoder, nrm, c, alphas, g, b,
                                    coef), gemm),
        "sae_untied_bwd_de": (lambda: untied_bwd_de(batch, g, de, True),
                              gemm),
        "sae_untied_bwd_dwn": (
            lambda: untied_bwd_dwn(c, resid, dwn, b, True, True, coef), gemm),
        "sae_untied_bwd_sums": (
            lambda: untied_bwd_sums(c, g, b, db, act, csum, True), 0.0),
        "sae_untied_bwd_loss": (
            lambda: untied_bwd_loss(resid, de, dwn, db, act, csum, alphas,
                                    part, loss4), 0.0)}


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
