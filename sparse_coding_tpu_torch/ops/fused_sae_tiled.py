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

``compute_dtype="bfloat16"`` (the JAX package's bf16 compute) takes each
kernel's bf16 form (``<kernel>_bf16``): the same schedule with its products
on bf16 tensor cores with fp32 accumulation (all four on
``csrc/bgemm_wgmma.cuh``, TMA loads and ``wgmma``) and the JAX package's
casts — x (a bf16 batch as it comes), the normalized
dictionary or decoder (normalized in fp32 first), the raw untied encoder,
the codes, r and dpre rounded to bf16 where they enter a product; ReLU,
masks, the residual, the sums, db and the loss stay fp32. On the card it
runs those kernels or raises, never the fp32 ones.

Each kernel has a plain PyTorch version beside it (``*_plain``). A wrapper
takes the plain version (the untied backward: its chunk schedule in plain
torch) only for CPU tensors; on CUDA tensors it launches its kernel or
raises. A plain version's bf16 compute rounds each operand to bf16 and back
(``_rounding``) and multiplies in fp32: the products of two bf16 values are
exact in fp32, so it sums what a bf16 dot with fp32 accumulation sums, on
the CPU and on the card alike (a bf16 ``torch.matmul`` would not: cuBLAS
may reduce in reduced precision, and the CPU's bf16 matmul is another
algorithm). The tiled paths' reported grad norm is the KERNEL-grad norm, taken
before the normalization VJP and, untied, before the bias decay — the
same quantity the JAX package reports.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ops import _build

_EPS = 1e-8
# the compute dtypes the ensemble kernels take: fp32, or bf16 dot operands
# with fp32 accumulation
COMPUTE_DTYPES = ("float32", "bfloat16")
_BF16 = torch.bfloat16


def _rounding(compute_dtype: str):
    """The JAX package's ``.astype(compute_dtype)`` of a dot operand, kept
    in fp32: a round to bf16 (nearest even) and back, or nothing."""
    if compute_dtype == "bfloat16":
        return lambda t: t.to(_BF16).to(torch.float32)
    return lambda t: t


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


def _global_batch(total_batch: Optional[int], rows: int) -> int:
    """The grads' and loss terms' normalizer: ``total_batch``, the rows of
    every data shard together on a data-sharded call (its outputs are then
    partial sums that an all-reduce over the data axis completes, as the
    JAX kernels' under ``shard_map``), or the call's own ``rows``."""
    if total_batch is None:
        return rows
    if int(total_batch) < rows:
        raise ValueError(f"total_batch {total_batch} is below the call's "
                         f"{rows} rows")
    return int(total_batch)


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


def _kernel_tensors(name, b, n_feats, d, compute_dtype="float32",
                    **tensors) -> None:
    """The kernels' checks: every tensor fp32 on one card (the batch may be
    bf16 under bf16 compute) and a shape the kernel takes."""
    _build.check_cuda_tensors(
        name, bf16_ok=("batch",) if compute_dtype == "bfloat16" else (),
        **{k: v for k, v in tensors.items() if v is not None})
    _build.check_kernel_shape(name, b, n_feats, d, compute_dtype)


def _check_compute_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the ensemble kernels take "
            f"{' or '.join(COMPUTE_DTYPES)}")


def bf16_operand(t: torch.Tensor, round_entry: str) -> torch.Tensor:
    """``t`` as a bf16 dot operand on the card: a bf16 tensor as it is, an
    fp32 one rounded to nearest even by the kernel library's rounding pass
    ``round_entry`` (one launch)."""
    if t.dtype == _BF16:
        return t
    out = torch.empty(t.shape, dtype=_BF16, device=t.device)
    _build.launch(round_entry, t.data_ptr(), out.data_ptr(), t.numel(),
                  _build.stream_ptr(t))
    return out


# --- the chunked kernels' workspace ------------------------------------------

# The chunked kernels keep the codes of one chunk — Z members x rows batch
# rows: the forwards' Cᵀ [Z, n, rows] fp32 (bf16 forms: bf16), the
# backwards' C and dpre G [Z, rows, n] fp32 each (bf16 forms: and their
# bf16 roundings) — in a device workspace of at most this many bytes; the
# whole [N, B, n] codes are never formed.
WORKSPACE_BYTES = 2**30
# bytes a (member, row, feature) code takes in each workspace, by compute
# dtype: the bf16 forward stores only the bf16 codes, the bf16 backward
# the fp32 C and G (the sums and masks) beside their bf16 roundings
FWD_CODE_BYTES = {"float32": 4, "bfloat16": 2}
BWD_CODE_BYTES = {"float32": 8, "bfloat16": 12}
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


def bwd_chunks(n_members: int, batch: int, n_feats: int,
               compute_dtype: str = "float32"
               ) -> list[tuple[int, int, int, int]]:
    """The chunks (m_lo, m_hi, b_lo, b_hi) of both backwards
    (sae_tied_bwd, sae_untied_bwd, and their bf16 forms), in the order they
    run: whole members, as many a chunk as WORKSPACE_BYTES holds of their C
    and G (BWD_CODE_BYTES a code; the last chunk may hold fewer); a member
    whose C and G alone exceed it runs in batch chunks of the largest
    multiple of 32 rows that fits (the last may be shorter), added in
    order. fp32: all 32 members in one chunk at the canonical shape (B = n
    = 2048), 8 a chunk at n = 8192, 4 a chunk at the masked family's n =
    16,384. bf16: 21 + 11 members at the canonical shape, 5 a chunk at n =
    8192."""
    return _member_chunks(n_members, batch, n_feats,
                          BWD_CODE_BYTES[compute_dtype], WORKSPACE_BYTES)


def fwd_chunks(n_members: int, batch: int, n_feats: int,
               compute_dtype: str = "float32"
               ) -> list[tuple[int, int, int, int]]:
    """The chunks (m_lo, m_hi, b_lo, b_hi) of both forwards (sae_tied_fwd,
    sae_untied_fwd, and their bf16 forms), in the order they run: whole
    members, as many a chunk as WORKSPACE_BYTES holds of their codes
    (FWD_CODE_BYTES a code; the last chunk may hold fewer); a member whose
    codes alone exceed it runs in row chunks of the largest multiple of 32
    rows that fits (the last may be shorter), each writing its own rows of
    r. fp32: all 32 members in one chunk at the canonical shape (B = n =
    2048), 16 a chunk at n = 8192, and the masked family's 7 members of n =
    16,384 in one. bf16: all 32 in one chunk at n = 8192 too."""
    return _member_chunks(n_members, batch, n_feats,
                          FWD_CODE_BYTES[compute_dtype], WORKSPACE_BYTES)


def _chunked_fwd(kernel: str, n_members: int, n_feats: int,
                 batch: torch.Tensor, codes, decode,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """A forward's chunk loop on the card: per chunk of :func:`fwd_chunks`,
    ``codes(ms, rs, ct)`` then ``decode(ms, rs, ct, rk)`` for the member
    slice ``ms``, the chunk's row slice ``rs`` of the batch, the workspace
    ``ct`` (fp32, or bf16 for a bf16 form) and the chunk's [Z, rows, d]
    slice ``rk`` of the residual; then one call of ``kernel`` counted.
    Returns r [N, B, d] (fp32)."""
    b, d = batch.shape
    r = torch.empty((n_members, b, d), dtype=torch.float32,
                    device=batch.device)
    chunks = fwd_chunks(n_members, b, n_feats, compute_dtype)
    ct = torch.empty((max((mh - ml) * (bh - bl) for ml, mh, bl, bh
                          in chunks) * n_feats,),
                     dtype=_BF16 if compute_dtype == "bfloat16"
                     else torch.float32, device=batch.device)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms, rs = slice(m_lo, m_hi), slice(b_lo, b_hi)
        codes(ms, rs, ct)
        decode(ms, rs, ct, r[ms, rs])
    _build.LAUNCHES[kernel] += 1
    return r


# --- sae_tied_fwd (K3a + the residual pass; masked too) -----------------------

def sae_tied_fwd_plain(encoder: torch.Tensor, bias: torch.Tensor,
                       batch: torch.Tensor,
                       coef_mask: Optional[torch.Tensor] = None,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """r [N, B, d] = (cm ⊙ relu(x Ŵᵀ + b)) Ŵ − x per member,
    Ŵ = E / ‖E‖_row; cm = 1 without a coef_mask. bf16 compute rounds x, Ŵ
    and the codes where they enter a product; x − in r is the fp32 batch
    (a bf16 batch widened, exact)."""
    rnd = _rounding(compute_dtype)
    xb = batch.to(torch.float32)
    w = rnd(_normalize_rows(encoder))
    c = torch.relu(torch.matmul(rnd(xb), w.transpose(1, 2))
                   + bias[:, None, :])
    if coef_mask is not None:
        c = c * coef_mask[:, None, :]
    return torch.matmul(rnd(c), w) - xb


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


def tied_fwd_bf16_norms(encoder, wb) -> None:
    """wb [N, n, d] = bf16(E / max(‖E_f‖, 1e-8)) for every dictionary row
    (the bf16 form's)."""
    _build.launch("sae_tied_fwd_bf16_norms", encoder.data_ptr(),
                  wb.data_ptr(), encoder.numel() // encoder.shape[-1],
                  encoder.shape[-1], _build.stream_ptr(wb))


def tied_fwd_bf16_codes(xbk, wb, bias, coef_mask, ctb) -> None:
    """Cᵀ [Z, n, rows] = bf16(cm·relu(Ŵb·xbkᵀ + b)) into the bf16
    workspace ``ctb``, for the Z members of ``wb`` [Z, n, d] (bf16)."""
    z, n, d = wb.shape
    _build.launch("sae_tied_fwd_bf16_codes", xbk.data_ptr(), wb.data_ptr(),
                  bias.data_ptr(), _mask_arg(coef_mask), ctb.data_ptr(), z,
                  xbk.shape[0], n, d, _build.stream_ptr(xbk))


def tied_fwd_bf16_decode(ctb, wb, xk, rk, batch: int) -> None:
    """rk = Cᵀᵀ·Ŵb − xk into ``rk`` (fp32), the [Z, rows, d] slice of the
    [N, B, d] residual; ``xk`` the batch's rows, fp32 or bf16."""
    z, n, d = wb.shape
    _build.launch("sae_tied_fwd_bf16_decode", ctb.data_ptr(), wb.data_ptr(),
                  xk.data_ptr(), int(xk.dtype == _BF16), rk.data_ptr(), z,
                  xk.shape[0], n, d, batch, _build.stream_ptr(xk))


def sae_tied_fwd(encoder: torch.Tensor, bias: torch.Tensor,
                 batch: torch.Tensor,
                 coef_mask: Optional[torch.Tensor] = None,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """The residual r = x̂ − x [N, B, d] of every member; see
    :func:`sae_tied_fwd_plain`. CUDA: the normalized dictionary, then per
    chunk of :func:`fwd_chunks` the launches ``tied_fwd_codes`` and
    ``tied_fwd_decode``; counts one ``sae_tied_fwd`` call. bf16 compute:
    the bf16 form, ``sae_tied_fwd_bf16`` (the fp32 batch rounded once,
    ``tied_fwd_bf16_norms``, then ``_codes`` and ``_decode`` per chunk).
    CPU: the plain version (the chunks write disjoint rows of r and sum
    nothing across one another)."""
    n_members, n_feats, d, b = _tied_shapes(encoder, bias, batch)
    _check_compute_dtype(compute_dtype)
    _check_vec("coef_mask", coef_mask, (n_members, n_feats))
    extra = () if coef_mask is None else (coef_mask,)
    if _on_cpu("sae_tied_fwd", encoder, bias, batch, *extra):
        return sae_tied_fwd_plain(encoder, bias, batch, coef_mask,
                                  compute_dtype)
    _kernel_tensors("sae_tied_fwd", b, n_feats, d, compute_dtype,
                    encoder=encoder, bias=bias, batch=batch,
                    coef_mask=coef_mask)
    cm = (lambda ms: None) if coef_mask is None else (
        lambda ms: coef_mask[ms])
    if compute_dtype == "bfloat16":
        xb = bf16_operand(batch, "sae_tied_fwd_bf16_round")
        wb = torch.empty(encoder.shape, dtype=_BF16, device=encoder.device)
        tied_fwd_bf16_norms(encoder, wb)
        return _chunked_fwd(
            "sae_tied_fwd_bf16", n_members, n_feats, batch,
            lambda ms, rs, ct: tied_fwd_bf16_codes(xb[rs], wb[ms], bias[ms],
                                                   cm(ms), ct),
            lambda ms, rs, ct, rk: tied_fwd_bf16_decode(ct, wb[ms],
                                                        batch[rs], rk, b),
            compute_dtype)
    w = torch.empty_like(encoder)
    tied_fwd_norms(encoder, w)
    return _chunked_fwd(
        "sae_tied_fwd", n_members, n_feats, batch,
        lambda ms, rs, ct: tied_fwd_codes(batch[rs], w[ms], bias[ms], cm(ms),
                                          ct),
        lambda ms, rs, ct, rk: tied_fwd_decode(ct, w[ms], batch[rs], rk, b))


# --- sae_tied_bwd (K3b; masked too) -------------------------------------------

def sae_tied_bwd_plain(encoder: torch.Tensor, bias: torch.Tensor,
                       alphas: torch.Tensor, batch: torch.Tensor,
                       resid: torch.Tensor,
                       coef_mask: Optional[torch.Tensor] = None,
                       compute_dtype: str = "float32",
                       total_batch: Optional[int] = None):
    """Exact tied-SAE grads from the residual: (dW [N, n, d] wrt the
    normalized W, db [N, n], activity [N, n] float, loss4 [N, 4] =
    [mse, l1, l0, ΣdW² + Σdb²]). A coef_mask multiplies the codes and the
    ReLU mask, so only active coefficients count. bf16 compute rounds x, Ŵ,
    r, the codes and dpre where they enter a product; the masks, sums and
    loss take the fp32 values. ``total_batch`` (default: the batch's rows)
    normalizes the grads and the loss terms: on a data-sharded call, the
    rows of every shard together, so the outputs are partial sums that an
    all-reduce over the data axis completes (ΣdW² + Σdb² then stays this
    shard's)."""
    rnd = _rounding(compute_dtype)
    b, d = batch.shape
    tb = _global_batch(total_batch, b)
    xb = batch.to(torch.float32)
    xc = rnd(xb)
    w = rnd(_normalize_rows(encoder))
    pre = torch.matmul(xc, w.transpose(1, 2)) + bias[:, None, :]
    c = torch.relu(pre)
    mask = (pre > 0.0).to(torch.float32)
    if coef_mask is not None:
        c = c * coef_mask[:, None, :]
        mask = mask * coef_mask[:, None, :]
    coef = 2.0 / (tb * d)
    rc = rnd(resid)
    dpre = (coef * torch.matmul(rc, w.transpose(1, 2))
            + (alphas / tb)[:, None, None]) * mask
    dw = (torch.matmul(rnd(dpre).transpose(1, 2), xc)
          + coef * torch.matmul(rnd(c).transpose(1, 2), rc))
    db = dpre.sum(dim=1)
    loss4 = torch.stack([
        (resid * resid).sum(dim=(1, 2)) / (tb * d),
        alphas * c.sum(dim=(1, 2)) / tb,
        mask.sum(dim=(1, 2)) / tb,
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


def tied_bwd_dpre(rk, w, c, alphas, g, batch: int, coef: float,
                  total_b: Optional[int] = None) -> None:
    """G [Z, rows, n] = (coef·(rk·Ŵᵀ) + α/TB)·[C > 0] into ``g``; rk is the
    [Z, rows, d] slice of the [N, B, d] residual, TB the global batch
    (``total_b``, default B)."""
    z, rows, d = rk.shape
    _build.launch("sae_tied_bwd_dpre", rk.data_ptr(), w.data_ptr(),
                  c.data_ptr(), alphas.data_ptr(), g.data_ptr(), z, rows,
                  w.shape[1], d, batch, total_b or batch, coef,
                  _build.stream_ptr(rk))


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


def tied_bwd_loss(resid, dw, db, act, csum, alphas, part, loss4,
                  total_b: Optional[int] = None) -> None:
    """loss4 [N, 4] from the residual and the finished grads and sums,
    normalized by ``total_b`` (default the residual's rows); ``part`` is an
    [N, slices, 2] scratch."""
    n_members, b, d = resid.shape
    _build.launch("sae_tied_bwd_loss", resid.data_ptr(), dw.data_ptr(),
                  db.data_ptr(), act.data_ptr(), csum.data_ptr(),
                  alphas.data_ptr(), part.data_ptr(), loss4.data_ptr(),
                  n_members, b, total_b or b, dw.shape[1], d, part.shape[1],
                  _build.stream_ptr(resid))


# The bf16 form's launches (the same library): C and G fp32 beside their
# bf16 roundings Cb and Gb in the workspace; xb, rb and Ŵb bf16.

def tied_bwd_bf16_norms(encoder, wb) -> None:
    """wb [N, n, d] = bf16(E / max(‖E_f‖, 1e-8)) for every dictionary
    row."""
    _build.launch("sae_tied_bwd_bf16_norms", encoder.data_ptr(),
                  wb.data_ptr(), encoder.numel() // encoder.shape[-1],
                  encoder.shape[-1], _build.stream_ptr(wb))


def tied_bwd_bf16_codes(xbk, wb, bias, coef_mask, c, cb) -> None:
    """C [Z, rows, n] = cm·relu(xbk·Ŵbᵀ + b) into ``c`` and bf16(C) into
    ``cb``, for the Z members of ``wb`` [Z, n, d]."""
    z, n, d = wb.shape
    _build.launch("sae_tied_bwd_bf16_codes", xbk.data_ptr(), wb.data_ptr(),
                  bias.data_ptr(), _mask_arg(coef_mask), c.data_ptr(),
                  cb.data_ptr(), z, xbk.shape[0], n, d,
                  _build.stream_ptr(xbk))


def tied_bwd_bf16_dpre(rbk, wb, c, alphas, g, gb, batch: int,
                       coef: float, total_b: Optional[int] = None) -> None:
    """G [Z, rows, n] = (coef·(rbk·Ŵbᵀ) + α/B)·[C > 0] into ``g`` and
    bf16(G) into ``gb``; rbk is the [Z, rows, d] slice of the bf16
    residual."""
    z, rows, d = rbk.shape
    _build.launch("sae_tied_bwd_bf16_dpre", rbk.data_ptr(), wb.data_ptr(),
                  c.data_ptr(), alphas.data_ptr(), g.data_ptr(),
                  gb.data_ptr(), z, rows, wb.shape[1], d, batch,
                  total_b or batch, coef, _build.stream_ptr(rbk))


def tied_bwd_bf16_dwx(xbk, gb, dw, first: bool) -> None:
    """dW [Z, n, d] = (0 if first else dW) + Gbᵀ·xbk."""
    z, n, d = dw.shape
    _build.launch("sae_tied_bwd_bf16_dwx", xbk.data_ptr(), gb.data_ptr(),
                  dw.data_ptr(), z, xbk.shape[0], n, d, int(first),
                  _build.stream_ptr(xbk))


def tied_bwd_bf16_dwr(cb, rbk, dw, batch: int, coef: float) -> None:
    """dW [Z, n, d] = dW + coef·(Cbᵀ·rbk)."""
    z, rows, d = rbk.shape
    _build.launch("sae_tied_bwd_bf16_dwr", cb.data_ptr(), rbk.data_ptr(),
                  dw.data_ptr(), z, rows, dw.shape[1], d, batch, coef,
                  _build.stream_ptr(rbk))


def _bwd_outputs(n_members, n_feats, d, n_weight_grads, device):
    """A backward's fp32 outputs and scratch: ``n_weight_grads`` [N, n, d]
    buffers (its weight grads, and the tied fp32 form's normalized
    dictionary), db, act, csum [N, n], loss4 [N, 4] and the loss slices
    [N, P, 2]."""
    kw = {"dtype": torch.float32, "device": device}
    grads = [torch.empty((n_members, n_feats, d), **kw)
             for _ in range(n_weight_grads)]
    db, act, csum = (torch.empty((n_members, n_feats), **kw)
                     for _ in range(3))
    return (grads, db, act, csum, torch.empty((n_members, 4), **kw),
            torch.empty((n_members, LOSS_SLICES, 2), **kw))


def _bf16_workspace(chunks, n_feats: int, device):
    """The bf16 backwards' workspace: (C, G) fp32 and (Cb, Gb) bf16, each
    a chunk's [Z, rows, n] (BWD_CODE_BYTES["bfloat16"] a code)."""
    size = max((mh - ml) * (bh - bl) for ml, mh, bl, bh in chunks) * n_feats
    return (torch.empty((2, size), dtype=torch.float32, device=device),
            torch.empty((2, size), dtype=_BF16, device=device))


def sae_tied_bwd(encoder: torch.Tensor, bias: torch.Tensor,
                 alphas: torch.Tensor, batch: torch.Tensor,
                 resid: torch.Tensor,
                 coef_mask: Optional[torch.Tensor] = None,
                 compute_dtype: str = "float32",
                 total_batch: Optional[int] = None):
    """See :func:`sae_tied_bwd_plain` for the outputs and ``total_batch``.
    CUDA: the normalized
    dictionary, then per chunk of :func:`bwd_chunks` the launches
    ``tied_bwd_codes``, ``_dpre``, ``_dwx``, ``_dwr``, ``_sums`` in order,
    then ``tied_bwd_loss``; counts one ``sae_tied_bwd`` call. bf16 compute:
    the bf16 form, ``sae_tied_bwd_bf16`` (the fp32 batch and the residual
    rounded once, then its norms, the five chunk launches and the loss).
    CPU: the plain version."""
    n_members, n_feats, d, b = _tied_shapes(encoder, bias, batch)
    _check_compute_dtype(compute_dtype)
    _bwd_checks(n_members, b, d, alphas, resid)
    _check_vec("coef_mask", coef_mask, (n_members, n_feats))
    extra = () if coef_mask is None else (coef_mask,)
    if _on_cpu("sae_tied_bwd", encoder, bias, alphas, batch, resid, *extra):
        return sae_tied_bwd_plain(encoder, bias, alphas, batch, resid,
                                  coef_mask, compute_dtype, total_batch)
    _kernel_tensors("sae_tied_bwd", b, n_feats, d, compute_dtype,
                    encoder=encoder, bias=bias, alphas=alphas, batch=batch,
                    resid=resid, coef_mask=coef_mask)
    tb = _global_batch(total_batch, b)
    if compute_dtype == "bfloat16":
        return _tied_bwd_bf16(encoder, bias, alphas, batch, resid, coef_mask,
                              tb)
    (dw, w), db, act, csum, loss4, part = _bwd_outputs(
        n_members, n_feats, d, 2, batch.device)
    chunks = bwd_chunks(n_members, b, n_feats)
    ws = torch.empty((2, max((mh - ml) * (bh - bl) for ml, mh, bl, bh
                             in chunks) * n_feats), dtype=torch.float32,
                     device=batch.device)
    c, g = ws[0], ws[1]
    coef = float(np.float32(2.0 / (tb * d)))
    tied_bwd_norms(encoder, w)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms = slice(m_lo, m_hi)
        xk, rk = batch[b_lo:b_hi], resid[ms, b_lo:b_hi]
        cm = None if coef_mask is None else coef_mask[ms]
        tied_bwd_codes(xk, w[ms], bias[ms], cm, c)
        tied_bwd_dpre(rk, w[ms], c, alphas[ms], g, b, coef, tb)
        tied_bwd_dwx(xk, g, dw[ms], b_lo == 0)
        tied_bwd_dwr(c, rk, dw[ms], b, coef)
        tied_bwd_sums(c, g, b_hi - b_lo, db[ms], act[ms], csum[ms],
                      b_lo == 0)
    tied_bwd_loss(resid, dw, db, act, csum, alphas, part, loss4, tb)
    _build.LAUNCHES["sae_tied_bwd"] += 1
    return dw, db, act, loss4


def _tied_bwd_bf16(encoder, bias, alphas, batch, resid, coef_mask, tb):
    """The bf16 form of :func:`sae_tied_bwd` on the card."""
    n_members, n_feats, d = encoder.shape
    b = batch.shape[0]
    (dw,), db, act, csum, loss4, part = _bwd_outputs(
        n_members, n_feats, d, 1, batch.device)
    xb = bf16_operand(batch, "sae_tied_bwd_bf16_round")
    rb = bf16_operand(resid, "sae_tied_bwd_bf16_round")
    wb = torch.empty(encoder.shape, dtype=_BF16, device=encoder.device)
    chunks = bwd_chunks(n_members, b, n_feats, "bfloat16")
    (c, g), (cb, gb) = _bf16_workspace(chunks, n_feats, batch.device)
    coef = float(np.float32(2.0 / (tb * d)))
    tied_bwd_bf16_norms(encoder, wb)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms, rs = slice(m_lo, m_hi), slice(b_lo, b_hi)
        cm = None if coef_mask is None else coef_mask[ms]
        tied_bwd_bf16_codes(xb[rs], wb[ms], bias[ms], cm, c, cb)
        tied_bwd_bf16_dpre(rb[ms, rs], wb[ms], c, alphas[ms], g, gb, b, coef,
                           tb)
        tied_bwd_bf16_dwx(xb[rs], gb, dw[ms], b_lo == 0)
        tied_bwd_bf16_dwr(cb, rb[ms, rs], dw[ms], b, coef)
        _build.launch("sae_tied_bwd_bf16_sums", c.data_ptr(), g.data_ptr(),
                      db[ms].data_ptr(), act[ms].data_ptr(),
                      csum[ms].data_ptr(), m_hi - m_lo, b_hi - b_lo,
                      n_feats, int(b_lo == 0), _build.stream_ptr(db))
    _build.launch("sae_tied_bwd_bf16_loss", resid.data_ptr(), dw.data_ptr(),
                  db.data_ptr(), act.data_ptr(), csum.data_ptr(),
                  alphas.data_ptr(), part.data_ptr(), loss4.data_ptr(),
                  n_members, b, tb, n_feats, d, LOSS_SLICES,
                  _build.stream_ptr(resid))
    _build.LAUNCHES["sae_tied_bwd_bf16"] += 1
    return dw, db, act, loss4


# --- sae_untied_fwd (K5/K7 forward + the residual pass) -----------------------

def sae_untied_fwd_plain(encoder: torch.Tensor, decoder: torch.Tensor,
                         bias: torch.Tensor, batch: torch.Tensor,
                         compute_dtype: str = "float32") -> torch.Tensor:
    """r [N, B, d] = relu(x Eᵀ + b) Wn − x per member: E the RAW encoder,
    Wn = D / ‖D‖_row. bf16 compute rounds x, E, Wn and the codes where they
    enter a product."""
    rnd = _rounding(compute_dtype)
    xb = batch.to(torch.float32)
    c = torch.relu(torch.matmul(rnd(xb), rnd(encoder).transpose(1, 2))
                   + bias[:, None, :])
    return torch.matmul(rnd(c), rnd(_normalize_rows(decoder))) - xb


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


def untied_fwd_bf16_norms(decoder, wnb) -> None:
    """wnb [N, n, d] = bf16(D / max(‖D_f‖, 1e-8)) for every decoder row
    (the bf16 form's)."""
    _build.launch("sae_untied_fwd_bf16_norms", decoder.data_ptr(),
                  wnb.data_ptr(), decoder.numel() // decoder.shape[-1],
                  decoder.shape[-1], _build.stream_ptr(wnb))


def untied_fwd_bf16_codes(xbk, eb, bias, ctb) -> None:
    """Cᵀ [Z, n, rows] = bf16(relu(Eb·xbkᵀ + b)) into the bf16 workspace
    ``ctb``, for the Z members of ``eb`` [Z, n, d] (the raw encoder,
    bf16)."""
    z, n, d = eb.shape
    _build.launch("sae_untied_fwd_bf16_codes", xbk.data_ptr(), eb.data_ptr(),
                  bias.data_ptr(), ctb.data_ptr(), z, xbk.shape[0], n, d,
                  _build.stream_ptr(xbk))


def untied_fwd_bf16_decode(ctb, wnb, xk, rk, batch: int) -> None:
    """rk = Cᵀᵀ·Wnb − xk into ``rk`` (fp32), the [Z, rows, d] slice of the
    [N, B, d] residual; ``xk`` the batch's rows, fp32 or bf16."""
    z, n, d = wnb.shape
    _build.launch("sae_untied_fwd_bf16_decode", ctb.data_ptr(),
                  wnb.data_ptr(), xk.data_ptr(), int(xk.dtype == _BF16),
                  rk.data_ptr(), z, xk.shape[0], n, d, batch,
                  _build.stream_ptr(xk))


def sae_untied_fwd(encoder: torch.Tensor, decoder: torch.Tensor,
                   bias: torch.Tensor, batch: torch.Tensor,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """See :func:`sae_untied_fwd_plain`. CUDA: the normalized decoder, then
    per chunk of :func:`fwd_chunks` the launches ``untied_fwd_codes`` and
    ``untied_fwd_decode``; counts one ``sae_untied_fwd`` call. bf16
    compute: the bf16 form, ``sae_untied_fwd_bf16`` (the fp32 batch and the
    raw encoder rounded once, ``untied_fwd_bf16_norms``, then ``_codes``
    and ``_decode`` per chunk). CPU: the plain version (the chunks write
    disjoint rows of r and sum nothing across one another, so their
    schedule leaves nothing for a plain twin to mirror)."""
    n_members, n_feats, d, b = _untied_shapes(encoder, decoder, bias, batch)
    _check_compute_dtype(compute_dtype)
    if _on_cpu("sae_untied_fwd", encoder, decoder, bias, batch):
        return sae_untied_fwd_plain(encoder, decoder, bias, batch,
                                    compute_dtype)
    _kernel_tensors("sae_untied_fwd", b, n_feats, d, compute_dtype,
                    encoder=encoder, decoder=decoder, bias=bias, batch=batch)
    if compute_dtype == "bfloat16":
        xb = bf16_operand(batch, "sae_untied_fwd_bf16_round")
        eb = bf16_operand(encoder, "sae_untied_fwd_bf16_round")
        wnb = torch.empty(decoder.shape, dtype=_BF16, device=decoder.device)
        untied_fwd_bf16_norms(decoder, wnb)
        return _chunked_fwd(
            "sae_untied_fwd_bf16", n_members, n_feats, batch,
            lambda ms, rs, ct: untied_fwd_bf16_codes(xb[rs], eb[ms],
                                                     bias[ms], ct),
            lambda ms, rs, ct, rk: untied_fwd_bf16_decode(
                ct, wnb[ms], batch[rs], rk, b),
            compute_dtype)
    wn = torch.empty_like(decoder)
    untied_fwd_norms(decoder, wn)
    return _chunked_fwd(
        "sae_untied_fwd", n_members, n_feats, batch,
        lambda ms, rs, ct: untied_fwd_codes(batch[rs], encoder[ms], bias[ms],
                                            ct),
        lambda ms, rs, ct, rk: untied_fwd_decode(ct, wn[ms], batch[rs], rk,
                                                 b))


# --- sae_untied_bwd (K5/K7 backward) ------------------------------------------

def sae_untied_bwd_plain(encoder: torch.Tensor, decoder: torch.Tensor,
                         bias: torch.Tensor, alphas: torch.Tensor,
                         batch: torch.Tensor, resid: torch.Tensor,
                         compute_dtype: str = "float32",
                         total_batch: Optional[int] = None):
    """Exact untied-SAE grads from the residual: (dE [N, n, d] wrt the raw
    encoder, dWn [N, n, d] wrt the normalized decoder, db [N, n], activity
    [N, n] float, loss4 [N, 4] = [mse, l1, l0, ΣdE² + ΣdWn² + Σdb²]). bf16
    compute rounds x, E, Wn, r, the codes and dpre where they enter a
    product. ``total_batch`` as :func:`sae_tied_bwd_plain`'s."""
    rnd = _rounding(compute_dtype)
    b, d = batch.shape
    tb = _global_batch(total_batch, b)
    xc = rnd(batch.to(torch.float32))
    wn = rnd(_normalize_rows(decoder))
    pre = torch.matmul(xc, rnd(encoder).transpose(1, 2)) + bias[:, None, :]
    c = torch.relu(pre)
    mask = (pre > 0.0).to(torch.float32)
    coef = 2.0 / (tb * d)
    rc = rnd(resid)
    dpre = (coef * torch.matmul(rc, wn.transpose(1, 2))
            + (alphas / tb)[:, None, None]) * mask
    de = torch.matmul(rnd(dpre).transpose(1, 2), xc)
    dwn = coef * torch.matmul(rnd(c).transpose(1, 2), rc)
    db = dpre.sum(dim=1)
    loss4 = torch.stack([
        (resid * resid).sum(dim=(1, 2)) / (tb * d),
        alphas * c.sum(dim=(1, 2)) / tb,
        mask.sum(dim=(1, 2)) / tb,
        (de * de).sum(dim=(1, 2)) + (dwn * dwn).sum(dim=(1, 2))
        + (db * db).sum(dim=1)], dim=1)
    return de, dwn, db, mask.sum(dim=1), loss4


def _untied_bwd_chunked_plain(encoder, decoder, bias, alphas, batch, resid,
                              compute_dtype="float32", total_batch=None):
    """The kernels' chunk schedule in plain torch (the CPU twin of
    :func:`sae_untied_bwd`): per chunk the codes, dpre — fp32: the
    decoder's clipped row norms divided out of the finished dot products,
    as the kernel does; bf16: against the rounded normalized decoder, as
    the bf16 form does —, the two weight-grad products and the per-feature
    sums, the batch chunks of a member added in order; then the loss terms,
    with l1 and l0 as double sums of the per-feature sums."""
    rnd = _rounding(compute_dtype)
    n_members, n_feats, d = encoder.shape
    b = batch.shape[0]
    tb = _global_batch(total_batch, b)
    coef = 2.0 / (tb * d)
    xc, rc, enc = rnd(batch.to(torch.float32)), rnd(resid), rnd(encoder)
    if compute_dtype == "bfloat16":
        wn = rnd(_normalize_rows(decoder))
        dots = lambda ms, rk: torch.matmul(rk, wn[ms].transpose(1, 2))
    else:
        nrm = torch.clamp(torch.linalg.vector_norm(decoder, dim=-1),
                          min=_EPS)
        dots = lambda ms, rk: (torch.matmul(rk, decoder[ms].transpose(1, 2))
                               / nrm[ms, None, :])
    de, dwn = torch.empty_like(encoder), torch.empty_like(encoder)
    sums = encoder.new_empty((3, n_members, n_feats))  # db, act, Σ_b c
    for m_lo, m_hi, b_lo, b_hi in bwd_chunks(n_members, b, n_feats,
                                             compute_dtype):
        ms = slice(m_lo, m_hi)
        xk, rk = xc[b_lo:b_hi], rc[ms, b_lo:b_hi]
        c = torch.relu(torch.matmul(xk, enc[ms].transpose(1, 2))
                       + bias[ms, None, :])
        mask = (c > 0.0).to(torch.float32)  # = [pre > 0], NaN included
        g = (coef * dots(ms, rk) + (alphas[ms] / tb)[:, None, None]) * mask
        part = (torch.matmul(rnd(g).transpose(1, 2), xk),
                torch.matmul(rnd(c).transpose(1, 2), rk),
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
        (resid * resid).sum(dim=(1, 2)) / (tb * d),
        alphas * csum.double().sum(dim=1).float() / tb,
        act.double().sum(dim=1).float() / tb,
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
                    coef: float, total_b: Optional[int] = None) -> None:
    """G [Z, rows, n] = (coef·(rk·Dᵀ)/nrm + α/TB)·[C > 0] into ``g``; rk
    is the [Z, rows, d] slice of the [N, B, d] residual, TB the global
    batch (``total_b``, default B)."""
    z, rows, d = rk.shape
    _build.launch("sae_untied_bwd_dpre", rk.data_ptr(), decoder.data_ptr(),
                  nrm.data_ptr(), c.data_ptr(), alphas.data_ptr(),
                  g.data_ptr(), z, rows, decoder.shape[1], d, batch,
                  total_b or batch, coef, _build.stream_ptr(rk))


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
                    loss4, total_b: Optional[int] = None) -> None:
    """loss4 [N, 4] from the residual and the finished grads and sums,
    normalized by ``total_b`` (default the residual's rows); ``part`` is an
    [N, slices, 2] scratch."""
    n_members, b, d = resid.shape
    _build.launch("sae_untied_bwd_loss", resid.data_ptr(), de.data_ptr(),
                  dwn.data_ptr(), db.data_ptr(), act.data_ptr(),
                  csum.data_ptr(), alphas.data_ptr(), part.data_ptr(),
                  loss4.data_ptr(), n_members, b, total_b or b, de.shape[1],
                  d, part.shape[1], _build.stream_ptr(resid))


def untied_bwd_bf16_norms(decoder, wnb) -> None:
    """wnb [N, n, d] = bf16(D / max(‖D_f‖, 1e-8)) for every decoder row
    (the bf16 form's: dpre's operand)."""
    _build.launch("sae_untied_bwd_bf16_norms", decoder.data_ptr(),
                  wnb.data_ptr(), decoder.numel() // decoder.shape[-1],
                  decoder.shape[-1], _build.stream_ptr(wnb))


def untied_bwd_bf16_codes(xbk, eb, bias, c, cb) -> None:
    """C [Z, rows, n] = relu(xbk·Ebᵀ + b) into ``c`` and bf16(C) into
    ``cb``, for the Z members of ``eb`` [Z, n, d] (the raw encoder,
    bf16)."""
    z, n, d = eb.shape
    _build.launch("sae_untied_bwd_bf16_codes", xbk.data_ptr(), eb.data_ptr(),
                  bias.data_ptr(), c.data_ptr(), cb.data_ptr(), z,
                  xbk.shape[0], n, d, _build.stream_ptr(xbk))


def untied_bwd_bf16_dpre(rbk, wnb, c, alphas, g, gb, batch: int,
                         coef: float, total_b: Optional[int] = None) -> None:
    """G [Z, rows, n] = (coef·(rbk·Wnbᵀ) + α/B)·[C > 0] into ``g`` and
    bf16(G) into ``gb``."""
    z, rows, d = rbk.shape
    _build.launch("sae_untied_bwd_bf16_dpre", rbk.data_ptr(),
                  wnb.data_ptr(), c.data_ptr(), alphas.data_ptr(),
                  g.data_ptr(), gb.data_ptr(), z, rows, wnb.shape[1], d,
                  batch, total_b or batch, coef, _build.stream_ptr(rbk))


def untied_bwd_bf16_de(xbk, gb, de, first: bool) -> None:
    """dE [Z, n, d] = (0 if first else dE) + Gbᵀ·xbk."""
    z, n, d = de.shape
    _build.launch("sae_untied_bwd_bf16_de", xbk.data_ptr(), gb.data_ptr(),
                  de.data_ptr(), z, xbk.shape[0], n, d, int(first),
                  _build.stream_ptr(xbk))


def untied_bwd_bf16_dwn(cb, rbk, dwn, batch: int, first: bool, last: bool,
                        coef: float) -> None:
    """dWn [Z, n, d] = (0 if first else dWn) + Cbᵀ·rbk, times coef when
    last."""
    z, rows, d = rbk.shape
    _build.launch("sae_untied_bwd_bf16_dwn", cb.data_ptr(), rbk.data_ptr(),
                  dwn.data_ptr(), z, rows, dwn.shape[1], d, batch,
                  int(first), int(last), coef, _build.stream_ptr(rbk))


def _untied_bwd_bf16(encoder, decoder, bias, alphas, batch, resid, tb):
    """The bf16 form of :func:`sae_untied_bwd` on the card."""
    n_members, n_feats, d = encoder.shape
    b = batch.shape[0]
    (de, dwn), db, act, csum, loss4, part = _bwd_outputs(
        n_members, n_feats, d, 2, batch.device)
    xb = bf16_operand(batch, "sae_untied_bwd_bf16_round")
    eb = bf16_operand(encoder, "sae_untied_bwd_bf16_round")
    rb = bf16_operand(resid, "sae_untied_bwd_bf16_round")
    wnb = torch.empty(decoder.shape, dtype=_BF16, device=decoder.device)
    chunks = bwd_chunks(n_members, b, n_feats, "bfloat16")
    (c, g), (cb, gb) = _bf16_workspace(chunks, n_feats, batch.device)
    coef = float(np.float32(2.0 / (tb * d)))
    untied_bwd_bf16_norms(decoder, wnb)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms, rs = slice(m_lo, m_hi), slice(b_lo, b_hi)
        first, last = b_lo == 0, b_hi == b
        untied_bwd_bf16_codes(xb[rs], eb[ms], bias[ms], c, cb)
        untied_bwd_bf16_dpre(rb[ms, rs], wnb[ms], c, alphas[ms], g, gb, b,
                             coef, tb)
        untied_bwd_bf16_de(xb[rs], gb, de[ms], first)
        untied_bwd_bf16_dwn(cb, rb[ms, rs], dwn[ms], b, first, last, coef)
        _build.launch("sae_untied_bwd_bf16_sums", c.data_ptr(), g.data_ptr(),
                      db[ms].data_ptr(), act[ms].data_ptr(),
                      csum[ms].data_ptr(), m_hi - m_lo, b_hi - b_lo,
                      n_feats, int(first), _build.stream_ptr(db))
    _build.launch("sae_untied_bwd_bf16_loss", resid.data_ptr(),
                  de.data_ptr(), dwn.data_ptr(), db.data_ptr(),
                  act.data_ptr(), csum.data_ptr(), alphas.data_ptr(),
                  part.data_ptr(), loss4.data_ptr(), n_members, b, tb,
                  n_feats, d, LOSS_SLICES, _build.stream_ptr(resid))
    _build.LAUNCHES["sae_untied_bwd_bf16"] += 1
    return de, dwn, db, act, loss4


def sae_untied_bwd(encoder: torch.Tensor, decoder: torch.Tensor,
                   bias: torch.Tensor, alphas: torch.Tensor,
                   batch: torch.Tensor, resid: torch.Tensor,
                   compute_dtype: str = "float32",
                   total_batch: Optional[int] = None):
    """See :func:`sae_untied_bwd_plain` for the outputs and
    ``total_batch``. CUDA: the decoder's
    row norms, then per chunk of :func:`bwd_chunks` the launches
    ``untied_bwd_codes``, ``_dpre``, ``_de``, ``_dwn``, ``_sums`` in order,
    then ``untied_bwd_loss``; counts one ``sae_untied_bwd`` call. bf16
    compute: the bf16 form, ``sae_untied_bwd_bf16`` (the fp32 batch, the
    raw encoder and the residual rounded once, the rounded normalized
    decoder, the five chunk launches and the loss). CPU: the same chunk
    schedule in plain torch."""
    n_members, n_feats, d, b = _untied_shapes(encoder, decoder, bias, batch)
    _check_compute_dtype(compute_dtype)
    _bwd_checks(n_members, b, d, alphas, resid)
    if _on_cpu("sae_untied_bwd", encoder, decoder, bias, alphas, batch,
               resid):
        return _untied_bwd_chunked_plain(encoder, decoder, bias, alphas,
                                         batch, resid, compute_dtype,
                                         total_batch)
    _kernel_tensors("sae_untied_bwd", b, n_feats, d, compute_dtype,
                    encoder=encoder, decoder=decoder, bias=bias,
                    alphas=alphas, batch=batch, resid=resid)
    tb = _global_batch(total_batch, b)
    if compute_dtype == "bfloat16":
        return _untied_bwd_bf16(encoder, decoder, bias, alphas, batch, resid,
                                tb)
    (de, dwn), db, act, csum, loss4, part = _bwd_outputs(
        n_members, n_feats, d, 2, batch.device)
    nrm = torch.empty((n_members, n_feats), dtype=torch.float32,
                      device=batch.device)
    chunks = bwd_chunks(n_members, b, n_feats)
    ws = torch.empty((2, max((mh - ml) * (bh - bl) for ml, mh, bl, bh
                             in chunks) * n_feats), dtype=torch.float32,
                     device=batch.device)
    c, g = ws[0], ws[1]
    coef = float(np.float32(2.0 / (tb * d)))
    untied_bwd_norms(decoder, nrm)
    for m_lo, m_hi, b_lo, b_hi in chunks:
        ms = slice(m_lo, m_hi)
        first, last = b_lo == 0, b_hi == b
        xk, rk = batch[b_lo:b_hi], resid[ms, b_lo:b_hi]
        untied_bwd_codes(xk, encoder[ms], bias[ms], c)
        untied_bwd_dpre(rk, decoder[ms], nrm[ms], c, alphas[ms], g, b, coef,
                        tb)
        untied_bwd_de(xk, g, de[ms], first)
        untied_bwd_dwn(c, rk, dwn[ms], b, first, last, coef)
        untied_bwd_sums(c, g, b_hi - b_lo, db[ms], act[ms], csum[ms], first)
    untied_bwd_loss(resid, de, dwn, db, act, csum, alphas, part, loss4, tb)
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


def one_chunk_launches_bf16(kernel: str, encoder: torch.Tensor,
                            bias: torch.Tensor, batch: torch.Tensor, *,
                            decoder: Optional[torch.Tensor] = None,
                            alphas: Optional[torch.Tensor] = None,
                            resid: Optional[torch.Tensor] = None,
                            buffers: Optional[dict] = None) -> dict:
    """:func:`one_chunk_launches` for the bf16 forms (``sae_tied_fwd_bf16``,
    ``sae_tied_bwd_bf16``, ``sae_untied_fwd_bf16``, ``sae_untied_bwd_bf16``):
    {part: (launch, FLOPs)} on one chunk of every member and row, in the
    order a call runs them. The first, ``<kernel>_round``, runs all of the
    call's roundings to bf16 (the fp32 batch; the raw untied encoder; a
    backward's residual); the products read what it wrote. ``buffers``, if
    given, receives the tensors the launches read and write, by name: the
    bf16 operands ``xb``, ``wb`` (Ŵ or Wn), ``eb`` (untied) and ``rb``
    (backwards); a forward's ``ct`` and ``r``; a backward's ``c``, ``g``,
    ``cb``, ``gb`` and its weight grads ``grads``."""
    n_m, n, d = encoder.shape
    b = batch.shape[0]
    dev = batch.device
    bf = lambda *shape: torch.empty(shape, dtype=_BF16, device=dev)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    gemm = 2.0 * n_m * b * n * d
    tied = kernel.startswith("sae_tied_")
    fwd = kernel in ("sae_tied_fwd_bf16", "sae_untied_fwd_bf16")
    if not fwd and kernel not in ("sae_tied_bwd_bf16", "sae_untied_bwd_bf16"):
        raise ValueError(f"{kernel} is not a chunked ensemble kernel's bf16 "
                         "form")
    rounded = []  # (fp32 source, bf16 copy) of each rounding of a call
    copy = lambda t: (t if t.dtype == _BF16 else
                      rounded.append((t, bf(*t.shape))) or rounded[-1][1])
    xb = copy(batch)
    eb = None if tied else copy(encoder)
    rb = None if fwd else copy(resid)

    def round_all():
        for src, dst in rounded:
            _build.launch(f"{kernel}_round", src.data_ptr(), dst.data_ptr(),
                          src.numel(), _build.stream_ptr(src))

    wb = bf(n_m, n, d)
    src = encoder if tied else decoder
    parts = {f"{kernel}_round": (round_all, 0.0), f"{kernel}_norms": (
        lambda: _build.launch(f"{kernel}_norms", src.data_ptr(),
                              wb.data_ptr(), n_m * n, d,
                              _build.stream_ptr(wb)), 0.0)}
    if fwd:
        ct, r = bf(n_m * n * b), f32(n_m, b, d)
        decode = tied_fwd_bf16_decode if tied else untied_fwd_bf16_decode
        parts[f"{kernel}_codes"] = (
            (lambda: tied_fwd_bf16_codes(xb, wb, bias, None, ct)) if tied
            else (lambda: untied_fwd_bf16_codes(xb, eb, bias, ct)), gemm)
        parts[f"{kernel}_decode"] = (lambda: decode(ct, wb, batch, r, b),
                                     gemm)
        if buffers is not None:
            buffers.update(xb=xb, wb=wb, eb=eb, ct=ct, r=r)
        return parts
    c, g, cb, gb = f32(n_m, b, n), f32(n_m, b, n), bf(n_m, b, n), bf(n_m, b, n)
    (w1, *w2), db, act, csum, loss4, part = _bwd_outputs(
        n_m, n, d, 1 if tied else 2, dev)
    coef = float(np.float32(2.0 / (b * d)))
    if tied:
        parts.update({
            f"{kernel}_codes": (
                lambda: tied_bwd_bf16_codes(xb, wb, bias, None, c, cb), gemm),
            f"{kernel}_dpre": (
                lambda: tied_bwd_bf16_dpre(rb, wb, c, alphas, g, gb, b, coef),
                gemm),
            f"{kernel}_dwx": (lambda: tied_bwd_bf16_dwx(xb, gb, w1, True),
                              gemm),
            f"{kernel}_dwr": (
                lambda: tied_bwd_bf16_dwr(cb, rb, w1, b, coef), gemm)})
    else:
        parts.update({
            f"{kernel}_codes": (
                lambda: untied_bwd_bf16_codes(xb, eb, bias, c, cb), gemm),
            f"{kernel}_dpre": (
                lambda: untied_bwd_bf16_dpre(rb, wb, c, alphas, g, gb, b,
                                             coef), gemm),
            f"{kernel}_de": (lambda: untied_bwd_bf16_de(xb, gb, w1, True),
                             gemm),
            f"{kernel}_dwn": (
                lambda: untied_bwd_bf16_dwn(cb, rb, w2[0], b, True, True,
                                            coef), gemm)})
    if buffers is not None:
        buffers.update(xb=xb, wb=wb, eb=eb, rb=rb, c=c, g=g, cb=cb, gb=gb,
                       grads=(w1, *w2))
    grads = (w1.data_ptr(), *(t.data_ptr() for t in w2))
    parts[f"{kernel}_sums"] = (lambda: _build.launch(
        f"{kernel}_sums", c.data_ptr(), g.data_ptr(), db.data_ptr(),
        act.data_ptr(), csum.data_ptr(), n_m, b, n, 1,
        _build.stream_ptr(db)), 0.0)
    parts[f"{kernel}_loss"] = (lambda: _build.launch(
        f"{kernel}_loss", resid.data_ptr(), *grads, db.data_ptr(),
        act.data_ptr(), csum.data_ptr(), alphas.data_ptr(), part.data_ptr(),
        loss4.data_ptr(), n_m, b, b, n, d, LOSS_SLICES,
        _build.stream_ptr(resid)), 0.0)
    return parts


# --- K3 and K7 contracts ------------------------------------------------------

def _check_unported(total_batch, batch_rows, compute_dtype,
                    ported=COMPUTE_DTYPES, later: str = ""):
    """Raise NotImplementedError for a compute dtype outside ``ported``
    (``later`` names the ROADMAP item that ports it), and ValueError for a
    ``total_batch`` below the call's rows (:func:`_global_batch`)."""
    if compute_dtype not in ported:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: these kernels take "
            f"{' or '.join(ported)}" + (f"; {later}" if later else ""))
    _global_batch(total_batch, batch_rows)


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


def sum_partials(psum, losses: dict, *tensors):
    """(losses, *tensors) summed over the data axis by ``psum`` (a
    callable taking and returning a list of tensors; None: unchanged) —
    the JAX producers' ``jax.lax.psum(..., psum_axis)`` of a data-sharded
    call's partial losses, grads and activity."""
    if psum is None:
        return (losses, *tensors)
    keys = list(losses)
    out = psum([losses[k] for k in keys] + list(tensors))
    return (dict(zip(keys, out[:len(keys)])), *out[len(keys):])


def _tiled_grads(fwd, bwd, encoder, bias, alphas, batch, batch_tile,
                 feat_tile, total_batch, compute_dtype, coef_mask):
    _, n_feats, _, b = _tied_shapes(encoder, bias, batch)
    _check_unported(total_batch, b, compute_dtype)
    _check_tiles(b, n_feats, batch_tile, feat_tile)
    cm = _float_mask(coef_mask)
    resid = fwd(encoder, bias, batch, cm, compute_dtype)
    dw, db, act, loss4 = bwd(encoder, bias, alphas, batch, resid, cm,
                             compute_dtype, total_batch)
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
    resid = fwd(encoder, decoder, bias, batch, compute_dtype)
    de, dwn, db, act, loss4 = bwd(encoder, decoder, bias, alphas, batch,
                                  resid, compute_dtype, total_batch)
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
                        batch_tile: Optional[int], feat_tile: Optional[int],
                        compute_dtype: str = "float32"
                        ) -> tuple[torch.Tensor, int, int]:
    """The kernels' input contract: a contiguous batch — a bf16 one as it
    is under bf16 compute (the products read it directly, and its fp32
    value, exact, feeds r), float32 otherwise (every other dtype is cast;
    the fp32 kernels read fp32) — and a (batch, feature) tile pair — the
    kernels' own tiles unless the caller pins one — that divides both
    axes."""
    if not (compute_dtype == "bfloat16" and batch.dtype == _BF16):
        batch = batch.to(torch.float32)
    batch = batch.contiguous()
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
        coef_mask: Optional[torch.Tensor] = None, psum=None):
    """Tiled-path producer for tied (and masked-tied) buckets: (losses,
    grads wrt the raw params {encoder, encoder_bias}, activity,
    kernel-grad norm [N]). ``psum`` (see :func:`sum_partials`) sums a
    data-sharded call's partial losses and grads before the normalization
    VJP; the kernel-grad norm stays this shard's."""
    from sparse_coding_tpu_torch.ops.fused_sae import normalize_with_vjp

    e = params_stacked["encoder"]
    batch, bt, ft = prepare_tiled_batch(batch, e.shape[1], batch_tile,
                                        feat_tile, compute_dtype)
    losses, dw, db, activity, grad_sq = tiled_tied_sae_grads(
        e, params_stacked["encoder_bias"], alphas, batch, batch_tile=bt,
        feat_tile=ft, total_batch=total_batch, compute_dtype=compute_dtype,
        coef_mask=coef_mask)
    losses, dw, db, activity = sum_partials(psum, losses, dw, db, activity)
    grads = {"encoder": normalize_with_vjp(e, dw), "encoder_bias": db}
    return losses, grads, activity, torch.sqrt(grad_sq)


def fused_untied_sae_tiled_loss_and_grads(
        params_stacked: dict, alphas: torch.Tensor,
        bias_decays: torch.Tensor, batch: torch.Tensor,
        batch_tile: Optional[int] = None, feat_tile: Optional[int] = None,
        total_batch: Optional[int] = None, compute_dtype: str = "float32",
        psum=None):
    """Tiled-path producer for untied buckets: (losses incl. "bias_decay",
    grads wrt the raw params {encoder, encoder_bias, decoder}, activity,
    kernel-grad norm [N] — taken before the bias decay and the decoder's
    normalization VJP). The batch-independent bias-decay terms are added
    after the kernels — and after ``psum`` on a data-sharded call —, once
    per member."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        normalize_with_vjp,
        untied_bias_decay_terms,
    )

    e, dec = params_stacked["encoder"], params_stacked["decoder"]
    bias = params_stacked["encoder_bias"]
    batch, bt, ft = prepare_tiled_batch(batch, e.shape[1], batch_tile,
                                        feat_tile, compute_dtype)
    losses, de, dwn, db, activity, grad_sq = tiled_untied_sae_grads(
        e, dec, bias, alphas, batch, batch_tile=bt, feat_tile=ft,
        total_batch=total_batch, compute_dtype=compute_dtype)
    losses, de, dwn, db, activity = sum_partials(psum, losses, de, dwn, db,
                                                 activity)
    losses["bias_decay"], db = untied_bias_decay_terms(bias, bias_decays, db)
    grads = {"encoder": de, "encoder_bias": db,
             "decoder": normalize_with_vjp(dec, dwn)}
    return losses, grads, activity, torch.sqrt(grad_sq)
