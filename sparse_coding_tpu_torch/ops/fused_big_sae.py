"""Fused train-step kernels for the giant single SAE: the counterpart of the
JAX package's ``ops/fused_big_sae.py`` (K8 ``big_sae_forward``, K9
``big_sae_backward``).

At the trainer's shape (batch 65,536, n_feats 16,384) the [batch, n_feats]
code matrix is 4 GiB in fp32, and autodiff materializes it more than once.
Two hand-written Hopper kernels (``ops/csrc``) never store it whole: both
walk the batch in chunks whose codes fit a workspace capped at
``WORKSPACE_BYTES`` (1 GiB), in order, each chunk's work done by
hand-written fp32 products with fused epilogues.

- ``big_sae_fwd`` — x̂ = relu(xc·E + t)·Wn, per chunk of at most
  ``fwd_chunk_rows`` rows: the chunk's codes Cᵀ (feature-major), then its
  rows of x̂ = Cᵀᵀ·Wn;
- ``big_sae_bwd`` — per chunk of at most ``bwd_chunk_rows`` rows: the
  chunk's codes C and dpre G, its share added into dE and dWn, and a
  reduction that adds its per-feature sums into dt, c_totals (activation
  mass Σ_b c) and the l0 counts; after the last chunk a matvec forms the
  encode-side centering grad −Σ_b Σ_f dpre·E[:, f] as −E·dt, with the
  l1/l0 sums. The CPU runs the same chunk schedule in plain torch.

Layouts are the JAX package's at every public function: E is [d, n] (the
kernels read it with its own row stride n), the dictionary [n, d], and the
decoder the kernels take is the row-normalized Wn = D / ‖D‖ (no clip, as
in the JAX function), formed here in torch.

Everything cheap or O(B·d) stays in torch, as in the JAX package: the
centering subtract, the residual (plus the tied centering), the
per-example MSEs, the normalization VJP and the tied decode-centering
gradient. Each kernel has a plain PyTorch version beside it; a wrapper
takes it only for CPU tensors, and on CUDA tensors launches its kernel or
raises.

``compute_dtype="bfloat16"`` (the JAX package's bf16 compute) takes each
kernel's bf16 form (``big_sae_fwd_bf16``, ``big_sae_bwd_bf16``): the same
schedule with its products on bf16 tensor cores with fp32 accumulation
(both kernels' on ``csrc/bgemm_wgmma.cuh``, TMA loads and ``wgmma``, one
product a launch) and the JAX package's
casts — xc, the raw encoder, Wn (normalized in fp32 first), r, the codes
and dpre rounded to bf16 where they enter a product; the ReLU, the
masks, dt, c_totals and the l1/l0 sums stay fp32, and dctr sums the
rounded dpre against the rounded encoder, as the JAX kernel's fifth
product does. On the card it runs those kernels or raises, never the
fp32 ones. The plain versions round with ``fused_sae_tiled._rounding``
and multiply in fp32, as the ensemble ones do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops.fused_sae import normalize_with_vjp
from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
    _BF16,
    BWD_CODE_BYTES,
    FWD_CODE_BYTES,
    _check_tiles,
    _check_unported,
    _global_batch,
    _on_cpu,
    _rounding,
    bf16_operand,
)

BF16 = "bfloat16"


def pick_big_sae_tiles(batch: int, n_feats: int, d: int,
                       compute_itemsize: int = 4
                       ) -> Optional[tuple[int, int]]:
    """The (batch_tile, feat_tile) the CUDA kernels block at when they take
    the shape, else None (the caller uses autodiff). The kernels take any
    1 <= d <= 4096 (``_build.BIG_MAX_D``: gpt2-medium's and Pythia-410M's
    MLP width) with batch and n_feats multiples of 32; their bf16 forms
    (``compute_itemsize`` 2) need d % 8 == 0 too."""
    if compute_itemsize not in (2, 4):
        return None
    if (batch % _build.BIG_BATCH_TILE or n_feats % _build.BIG_FEAT_TILE
            or not 1 <= d <= _build.BIG_MAX_D
            or (compute_itemsize == 2 and d % _build.BF16_D_MULTIPLE)):
        return None
    return _build.BIG_BATCH_TILE, _build.BIG_FEAT_TILE


def normalized_dict(dictionary: torch.Tensor) -> torch.Tensor:
    """Wn = D / ‖D‖_row, unclipped, as the JAX kernels' wrappers form it."""
    return dictionary / torch.linalg.vector_norm(dictionary, dim=-1,
                                                 keepdim=True)


def _shapes(params: dict, xc: torch.Tensor) -> tuple[int, int, int]:
    n, d = params["dict"].shape
    if tuple(params["encoder"].shape) != (d, n):
        raise ValueError(f"encoder must be {(d, n)}, got "
                         f"{tuple(params['encoder'].shape)}")
    if tuple(params["threshold"].shape) != (n,):
        raise ValueError(f"threshold must be {(n,)}, got "
                         f"{tuple(params['threshold'].shape)}")
    if xc.dim() != 2 or xc.shape[1] != d:
        raise ValueError(f"xc must be [B, {d}], got {tuple(xc.shape)}")
    return xc.shape[0], n, d


def _kernel_checks(name: str, b: int, n: int, d: int, compute_dtype: str,
                   **tensors) -> None:
    _build.check_cuda_tensors(name, **tensors)
    _build.check_big_shape(name, b, n, d, compute_dtype)


def _tiles(b, n, batch_tile, feat_tile):
    if batch_tile is not None and feat_tile is not None:
        _check_tiles(b, n, batch_tile, feat_tile)


# --- the chunk schedules ------------------------------------------------------

# K8 and K9 walk the batch in chunks whose codes — K8's Cᵀ [n, rows] fp32
# (bf16 form: bf16), K9's C and dpre G [rows, n] fp32 each (bf16 form: and
# their bf16 roundings) — fit this workspace; the whole [B, n] codes are
# never formed. The bytes a code takes by compute dtype are the ensemble
# kernels' (fused_sae_tiled.FWD_CODE_BYTES, BWD_CODE_BYTES).
WORKSPACE_BYTES = 2**30


def _chunk_rows(batch: int, n_feats: int, code_bytes: int) -> int:
    rows = WORKSPACE_BYTES // (code_bytes * n_feats) // 32 * 32
    return max(32, min(rows, batch))


def _row_chunks(batch: int, rows: int) -> list[tuple[int, int]]:
    return [(lo, min(lo + rows, batch)) for lo in range(0, batch, rows)]


def fwd_chunk_rows(batch: int, n_feats: int,
                   compute_dtype: str = "float32") -> int:
    """Rows per K8 chunk: the largest multiple of 32 whose [n, rows] codes
    (FWD_CODE_BYTES a code) fit WORKSPACE_BYTES (at least 32, at most the
    batch). At the trainer's shape (n = 16,384): 16,384 in fp32, 32,768 in
    bf16."""
    return _chunk_rows(batch, n_feats, FWD_CODE_BYTES[compute_dtype])


def fwd_chunks(batch: int, n_feats: int,
               compute_dtype: str = "float32") -> list[tuple[int, int]]:
    """K8's batch chunks [lo, hi), in the order they run; the last may be
    shorter. Each writes its own rows of x̂."""
    return _row_chunks(batch, fwd_chunk_rows(batch, n_feats, compute_dtype))


def bwd_chunk_rows(batch: int, n_feats: int,
                   compute_dtype: str = "float32") -> int:
    """Rows per K9 chunk: the largest multiple of 32 whose [rows, n]
    workspaces (BWD_CODE_BYTES a code: fp32 C and G, and in bf16 their
    roundings) fit WORKSPACE_BYTES (at least 32, at most the batch). At the
    trainer's shape (n = 16,384): 8,192 in fp32, 5,440 in bf16 (13 chunks
    of B = 65,536, the last 256 rows)."""
    return _chunk_rows(batch, n_feats, BWD_CODE_BYTES[compute_dtype])


def bwd_chunks(batch: int, n_feats: int,
               compute_dtype: str = "float32") -> list[tuple[int, int]]:
    """K9's batch chunks [lo, hi), in the order they are summed; the last
    may be shorter."""
    return _row_chunks(batch, bwd_chunk_rows(batch, n_feats, compute_dtype))


# --- big_sae_fwd (K8) ---------------------------------------------------------

def big_sae_forward_plain(params: dict, xc: torch.Tensor,
                          compute_dtype: str = "float32") -> torch.Tensor:
    """x̂ [B, d] = relu(xc·E + t)·Wn, materializing the codes. bf16 compute
    rounds xc, E, Wn and the codes where they enter a product."""
    rnd = _rounding(compute_dtype)
    c = torch.relu(rnd(xc) @ rnd(params["encoder"]) + params["threshold"])
    return rnd(c) @ rnd(normalized_dict(params["dict"]))


def fwd_codes(xk, e, t, ct) -> None:
    """Cᵀ [n, rows] = relu(Eᵀ·xkᵀ + t) into the workspace ``ct``."""
    rows, d = xk.shape
    _build.launch("big_sae_fwd_codes", xk.data_ptr(), e.data_ptr(),
                  t.data_ptr(), ct.data_ptr(), rows, e.shape[1], d,
                  _build.stream_ptr(xk))


def fwd_decode(ct, wn, xhat_k) -> None:
    """x̂k [rows, d] = Cᵀᵀ·Wn into ``xhat_k``, the chunk's rows of x̂."""
    rows, d = xhat_k.shape
    _build.launch("big_sae_fwd_decode", ct.data_ptr(), wn.data_ptr(),
                  xhat_k.data_ptr(), rows, wn.shape[0], d,
                  _build.stream_ptr(xhat_k))


def fwd_bf16_codes(xbk, eb, t, ctb) -> None:
    """Ctb [n, rows] = bf16(relu(Ebᵀ·xbkᵀ + t)) into the workspace ``ctb``
    (the bf16 form's)."""
    rows, d = xbk.shape
    _build.launch("big_sae_fwd_bf16_codes", xbk.data_ptr(), eb.data_ptr(),
                  t.data_ptr(), ctb.data_ptr(), rows, eb.shape[1], d,
                  _build.stream_ptr(xbk))


def fwd_bf16_decode(ctb, wnb, xhat_k) -> None:
    """x̂k [rows, d] = Ctbᵀ·Wnb into ``xhat_k`` (the bf16 form's)."""
    rows, d = xhat_k.shape
    _build.launch("big_sae_fwd_bf16_decode", ctb.data_ptr(), wnb.data_ptr(),
                  xhat_k.data_ptr(), rows, wnb.shape[0], d,
                  _build.stream_ptr(xhat_k))


def _forward_bf16(xc, e, t, wn) -> torch.Tensor:
    """The bf16 form of :func:`big_sae_forward` on the card."""
    b, d = xc.shape
    n = e.shape[1]
    xb = bf16_operand(xc, "big_sae_fwd_bf16_round")
    eb = bf16_operand(e, "big_sae_fwd_bf16_round")
    wnb = bf16_operand(wn, "big_sae_fwd_bf16_round")
    xhat = torch.empty((b, d), dtype=torch.float32, device=xc.device)
    ctb = torch.empty((fwd_chunk_rows(b, n, BF16) * n,), dtype=_BF16,
                      device=xc.device)
    for lo, hi in fwd_chunks(b, n, BF16):
        fwd_bf16_codes(xb[lo:hi], eb, t, ctb)
        fwd_bf16_decode(ctb, wnb, xhat[lo:hi])
    _build.LAUNCHES["big_sae_fwd_bf16"] += 1
    return xhat


def big_sae_forward(params: dict, xc: torch.Tensor,
                    batch_tile: Optional[int] = None,
                    feat_tile: Optional[int] = None,
                    compute_dtype: str = "float32") -> torch.Tensor:
    """x̂ = relu(xc·E + t)·Wn without materializing the codes (K8). ``params``
    holds the raw big-SAE params (dict/encoder/threshold); xc is
    pre-centered. ``batch_tile``/``feat_tile`` keep the JAX divisibility
    contract; the CUDA kernels block at their own tiles. CUDA: per chunk of
    :func:`fwd_chunks` the launches ``fwd_codes`` and ``fwd_decode``;
    counts one ``big_sae_fwd`` call. bf16 compute: the bf16 form,
    ``big_sae_fwd_bf16`` (xc, E and Wn rounded once, then
    ``fwd_bf16_codes`` and ``fwd_bf16_decode`` per chunk). CPU: the plain
    version (the chunks write disjoint rows of x̂ and sum nothing across
    one another, so their schedule leaves nothing for a plain twin to
    mirror)."""
    b, n, d = _shapes(params, xc)
    _check_unported(None, b, compute_dtype)
    _tiles(b, n, batch_tile, feat_tile)
    e, t = params["encoder"], params["threshold"]
    if _on_cpu("big_sae_fwd", xc, e, t, params["dict"]):
        return big_sae_forward_plain(params, xc, compute_dtype)
    wn = normalized_dict(params["dict"])
    _kernel_checks("big_sae_fwd", b, n, d, compute_dtype, xc=xc, encoder=e,
                   wn=wn, threshold=t)
    if compute_dtype == BF16:
        return _forward_bf16(xc, e, t, wn)
    xhat = torch.empty((b, d), dtype=torch.float32, device=xc.device)
    ct = torch.empty((fwd_chunk_rows(b, n) * n,), dtype=torch.float32,
                     device=xc.device)
    for lo, hi in fwd_chunks(b, n):
        fwd_codes(xc[lo:hi], e, t, ct)
        fwd_decode(ct, wn, xhat[lo:hi])
    _build.LAUNCHES["big_sae_fwd"] += 1
    return xhat


# --- big_sae_bwd (K9) ---------------------------------------------------------

def big_sae_backward_plain(params: dict, alpha: torch.Tensor,
                           xc: torch.Tensor, r: torch.Tensor,
                           compute_dtype: str = "float32",
                           total_batch: Optional[int] = None):
    """(dE [d, n] wrt the raw encoder, dWn [n, d] wrt the normalized
    dictionary, dt [n], dctr_enc [d] = −Σ_b dpre·Eᵀ, c_totals [n] = Σ_b c,
    [l1, l0] sums [2]) from the residual r = x̂ − x, materializing the
    codes. dpre = (coef·r·Wnᵀ + α/B) ⊙ [pre > 0], coef = 2/(B·d). bf16
    compute rounds xc, E, Wn, r, the codes and dpre where they enter a
    product (dctr: the rounded dpre against the rounded E); dt, c_totals
    and the sums stay over the fp32 values. ``total_batch`` (default B)
    takes B's place as the normalizer on a data-sharded call, whose
    outputs are then partial sums over its rows."""
    rnd = _rounding(compute_dtype)
    b, d = xc.shape
    tb = _global_batch(total_batch, b)
    xq, e = rnd(xc), rnd(params["encoder"])
    wn, rq = rnd(normalized_dict(params["dict"])), rnd(r)
    pre = xq @ e + params["threshold"]
    c = torch.relu(pre)
    mask = (pre > 0.0).to(torch.float32)
    coef = 2.0 / (tb * d)
    dpre = (coef * (rq @ wn.T) + alpha / tb) * mask
    dq = rnd(dpre)
    de = xq.T @ dq
    dwn = coef * (rnd(c).T @ rq)
    dt = dpre.sum(dim=0)
    dctr = -(dq @ e.T).sum(dim=0)
    scal = torch.stack([c.sum(), mask.sum()])
    return de, dwn, dt, dctr, c.sum(dim=0), scal


def _backward_chunked_plain(e, wn, t, alpha, xc, r,
                            compute_dtype: str = "float32", tb=None):
    """K9's chunk schedule in plain torch (the CPU twin of the kernels):
    the same chunks, each chunk's products and sums added in order, dctr
    from the sum of the (rounded) dpre, as the kernels form it."""
    rnd = _rounding(compute_dtype)
    b, d = xc.shape
    tb = _global_batch(tb, b)
    coef = 2.0 / (tb * d)
    xq, rq, e, wn = rnd(xc), rnd(r), rnd(e), rnd(wn)
    acc = None
    for lo, hi in bwd_chunks(b, e.shape[1], compute_dtype):
        xk, rk = xq[lo:hi], rq[lo:hi]
        c = torch.relu(xk @ e + t)
        mask = (c > 0.0).to(torch.float32)  # = [pre > 0], NaN included
        g = (coef * (rk @ wn.T) + alpha / tb) * mask
        gq = rnd(g)
        part = (xk.T @ gq, rnd(c).T @ rk, g.sum(dim=0), gq.sum(dim=0),
                c.sum(dim=0), mask.sum(dim=0))
        acc = part if acc is None else tuple(a + p for a, p in zip(acc, part))
    de, dwn, dt, dtq, c_totals, l0 = acc
    scal = torch.stack([c_totals.double().sum(), l0.double().sum()])
    return (de, coef * dwn, dt, -(e @ dtq), c_totals, scal.to(torch.float32))


def bwd_codes(xk, e, t, c) -> None:
    """C [rows, n] = relu(xk·E + t) into the workspace ``c``."""
    rows, d = xk.shape
    _build.launch("big_sae_bwd_codes", xk.data_ptr(), e.data_ptr(),
                  t.data_ptr(), c.data_ptr(), rows, e.shape[1], d,
                  _build.stream_ptr(xk))


def bwd_dpre(rk, wn, c, alpha, g, batch: int, coef: float) -> None:
    """G [rows, n] = (coef·rk·Wnᵀ + α/B)·[C > 0] into the workspace ``g``."""
    rows, d = rk.shape
    _build.launch("big_sae_bwd_dpre", rk.data_ptr(), wn.data_ptr(),
                  c.data_ptr(), alpha.data_ptr(), g.data_ptr(), rows,
                  wn.shape[0], d, batch, coef, _build.stream_ptr(rk))


def bwd_de(xk, g, de, first: bool) -> None:
    """dE = (0 if first else dE) + xkᵀ·G."""
    rows, d = xk.shape
    _build.launch("big_sae_bwd_de", xk.data_ptr(), g.data_ptr(),
                  de.data_ptr(), rows, de.shape[1], d, int(first),
                  _build.stream_ptr(xk))


def bwd_dwn(c, rk, dwn, first: bool, last: bool, coef: float) -> None:
    """dWn = (0 if first else dWn) + Cᵀ·rk, times coef when last."""
    rows, d = rk.shape
    _build.launch("big_sae_bwd_dwn", c.data_ptr(), rk.data_ptr(),
                  dwn.data_ptr(), rows, dwn.shape[0], d, int(first),
                  int(last), coef, _build.stream_ptr(rk))


def bwd_sums(c, g, rows: int, dt, c_totals, l0f, first: bool) -> None:
    """dt, c_totals and the per-feature l0 counts (+)= the column sums of
    the first ``rows`` rows of G, C and [C > 0]."""
    _build.launch("big_sae_bwd_sums", c.data_ptr(), g.data_ptr(),
                  dt.data_ptr(), c_totals.data_ptr(), l0f.data_ptr(), rows,
                  dt.shape[0], int(first), _build.stream_ptr(dt))


def bwd_dctr(e, dt, c_totals, l0f, dctr, scal) -> None:
    """dctr = −E·dt; scal = (Σ c_totals, Σ l0f)."""
    d, n = e.shape
    _build.launch("big_sae_bwd_dctr", e.data_ptr(), dt.data_ptr(),
                  c_totals.data_ptr(), l0f.data_ptr(), dctr.data_ptr(),
                  scal.data_ptr(), n, d, _build.stream_ptr(e))


def bwd_bf16_codes(xbk, eb, t, c, cb) -> None:
    """C [rows, n] = relu(xbk·Eb + t) into ``c`` and bf16(C) into ``cb``
    (the bf16 form's)."""
    rows, d = xbk.shape
    _build.launch("big_sae_bwd_bf16_codes", xbk.data_ptr(), eb.data_ptr(),
                  t.data_ptr(), c.data_ptr(), cb.data_ptr(), rows,
                  eb.shape[1], d, _build.stream_ptr(xbk))


def bwd_bf16_dpre(rbk, wnb, c, alpha, g, gb, batch: int, coef: float) -> None:
    """G [rows, n] = (coef·rbk·Wnbᵀ + α/B)·[C > 0] into ``g`` and bf16(G)
    into ``gb``."""
    rows, d = rbk.shape
    _build.launch("big_sae_bwd_bf16_dpre", rbk.data_ptr(), wnb.data_ptr(),
                  c.data_ptr(), alpha.data_ptr(), g.data_ptr(), gb.data_ptr(),
                  rows, wnb.shape[0], d, batch, coef, _build.stream_ptr(rbk))


def bwd_bf16_de(xbk, gb, de, first: bool) -> None:
    """dE = (0 if first else dE) + xbkᵀ·Gb."""
    rows, d = xbk.shape
    _build.launch("big_sae_bwd_bf16_de", xbk.data_ptr(), gb.data_ptr(),
                  de.data_ptr(), rows, de.shape[1], d, int(first),
                  _build.stream_ptr(xbk))


def bwd_bf16_dwn(cb, rbk, dwn, first: bool, last: bool, coef: float) -> None:
    """dWn = (0 if first else dWn) + Cbᵀ·rbk, times coef when last."""
    rows, d = rbk.shape
    _build.launch("big_sae_bwd_bf16_dwn", cb.data_ptr(), rbk.data_ptr(),
                  dwn.data_ptr(), rows, dwn.shape[0], d, int(first),
                  int(last), coef, _build.stream_ptr(rbk))


def bwd_bf16_sums(c, g, gb, rows: int, dt, dtb, c_totals, l0f,
                  first: bool) -> None:
    """dt, dtb, c_totals and the per-feature l0 counts (+)= the column sums
    of the first ``rows`` rows of G, Gb, C and [C > 0]."""
    _build.launch("big_sae_bwd_bf16_sums", c.data_ptr(), g.data_ptr(),
                  gb.data_ptr(), dt.data_ptr(), dtb.data_ptr(),
                  c_totals.data_ptr(), l0f.data_ptr(), rows, dt.shape[0],
                  int(first), _build.stream_ptr(dt))


def bwd_bf16_dctr(eb, dtb, c_totals, l0f, dctr, scal) -> None:
    """dctr = −Eb·dtb; scal = (Σ c_totals, Σ l0f)."""
    d, n = eb.shape
    _build.launch("big_sae_bwd_bf16_dctr", eb.data_ptr(), dtb.data_ptr(),
                  c_totals.data_ptr(), l0f.data_ptr(), dctr.data_ptr(),
                  scal.data_ptr(), n, d, _build.stream_ptr(eb))


def _bwd_outputs(n: int, d: int, device) -> tuple:
    """K9's outputs (dE, dWn, dt, c_totals, the per-feature l0 counts, dctr
    and the [l1, l0] sums), fp32 on ``device``."""
    kw = {"dtype": torch.float32, "device": device}
    return (torch.empty((d, n), **kw), torch.empty((n, d), **kw),
            *(torch.empty((n,), **kw) for _ in range(3)),
            torch.empty((d,), **kw), torch.empty((2,), **kw))


def _backward_bf16(e, wn, t, alpha, xc, r, tb):
    """The bf16 form of :func:`big_sae_backward` on the card."""
    b, d = xc.shape
    n = e.shape[1]
    de, dwn, dt, c_totals, l0f, dctr, scal = _bwd_outputs(n, d, xc.device)
    dtb = torch.empty_like(dt)
    xb, eb, wnb, rb = (bf16_operand(v, "big_sae_bwd_bf16_round")
                       for v in (xc, e, wn, r))
    rows = bwd_chunk_rows(b, n, BF16)
    ws = torch.empty((2, rows, n), dtype=torch.float32, device=xc.device)
    wsb = torch.empty((2, rows, n), dtype=_BF16, device=xc.device)
    (c, g), (cb, gb) = ws, wsb
    coef = float(np.float32(2.0 / (tb * d)))
    chunks = bwd_chunks(b, n, BF16)
    for i, (lo, hi) in enumerate(chunks):
        first, last = i == 0, i == len(chunks) - 1
        xk, rk = xb[lo:hi], rb[lo:hi]
        bwd_bf16_codes(xk, eb, t, c, cb)
        bwd_bf16_dpre(rk, wnb, c, alpha, g, gb, tb, coef)
        bwd_bf16_de(xk, gb, de, first)
        bwd_bf16_dwn(cb, rk, dwn, first, last, coef)
        bwd_bf16_sums(c, g, gb, hi - lo, dt, dtb, c_totals, l0f, first)
    bwd_bf16_dctr(eb, dtb, c_totals, l0f, dctr, scal)
    _build.LAUNCHES["big_sae_bwd_bf16"] += 1
    return de, dwn, dt, dctr, c_totals, scal


def big_sae_backward(params: dict, alpha: torch.Tensor, xc: torch.Tensor,
                     r: torch.Tensor, batch_tile: Optional[int] = None,
                     feat_tile: Optional[int] = None,
                     total_batch: Optional[int] = None,
                     compute_dtype: str = "float32"):
    """All parameter grads plus c_totals and the l1/l0 sums, the codes
    recomputed one batch chunk at a time (K9); see
    :func:`big_sae_backward_plain` for the outputs. CUDA: per chunk the
    launches ``bwd_codes``, ``bwd_dpre``, ``bwd_de``, ``bwd_dwn``,
    ``bwd_sums`` in order, then ``bwd_dctr``; counts one ``big_sae_bwd``
    call. bf16 compute: the bf16 form, ``big_sae_bwd_bf16`` (xc, E, Wn and
    r rounded once, the ``bwd_bf16_*`` chunk launches, then
    ``bwd_bf16_dctr``). CPU: the same chunk schedule in plain torch."""
    b, n, d = _shapes(params, xc)
    _check_unported(total_batch, b, compute_dtype)
    tb = _global_batch(total_batch, b)
    _tiles(b, n, batch_tile, feat_tile)
    if tuple(r.shape) != (b, d):
        raise ValueError(f"r must be {(b, d)}, got {tuple(r.shape)}")
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=xc.device)
    e, t = params["encoder"], params["threshold"]
    if _on_cpu("big_sae_bwd", xc, r, e, t, params["dict"], alpha):
        return _backward_chunked_plain(e, normalized_dict(params["dict"]), t,
                                       alpha, xc, r, compute_dtype, tb)
    wn = normalized_dict(params["dict"])
    alpha = alpha.reshape(1).contiguous()
    _kernel_checks("big_sae_bwd", b, n, d, compute_dtype, xc=xc, r=r,
                   encoder=e, wn=wn, threshold=t, alpha=alpha)
    if compute_dtype == BF16:
        return _backward_bf16(e, wn, t, alpha, xc, r, tb)
    de, dwn, dt, c_totals, l0f, dctr, scal = _bwd_outputs(n, d, xc.device)
    ws = torch.empty((2, bwd_chunk_rows(b, n), n), dtype=torch.float32,
                     device=xc.device)
    c, g = ws[0], ws[1]
    coef = float(np.float32(2.0 / (tb * d)))
    chunks = bwd_chunks(b, n)
    for i, (lo, hi) in enumerate(chunks):
        first, last = i == 0, i == len(chunks) - 1
        xk, rk = xc[lo:hi], r[lo:hi]
        bwd_codes(xk, e, t, c)
        bwd_dpre(rk, wn, c, alpha, g, tb, coef)
        bwd_de(xk, g, de, first)
        bwd_dwn(c, rk, dwn, first, last, coef)
        bwd_sums(c, g, hi - lo, dt, c_totals, l0f, first)
    bwd_dctr(e, dt, c_totals, l0f, dctr, scal)
    _build.LAUNCHES["big_sae_bwd"] += 1
    return de, dwn, dt, dctr, c_totals, scal


# --- the chunked kernels' launches, one by one -------------------------------

def one_chunk_launches(kernel: str, params: dict, xc: torch.Tensor,
                       r: Optional[torch.Tensor] = None,
                       alpha: Optional[torch.Tensor] = None) -> dict:
    """{part: (launch, FLOPs)} for every launch of ``kernel``
    (``big_sae_fwd``, ``big_sae_bwd`` or their bf16 forms
    ``big_sae_fwd_bf16``, ``big_sae_bwd_bf16``), in the order a call runs
    them, on the first chunk of its schedule over these CUDA inputs (xc
    [B, d], and for the backward the residual r [B, d] and alpha); the
    outputs and the chunk's workspace are allocated here. Each launch
    writes only its own buffers, so any one of them can be timed alone once
    the earlier ones have run. FLOPs counts the products' multiply-adds
    twice (dctr's matvec too), 0 for the sums and a bf16 form's first part,
    ``<kernel>_round``, which runs all of the call's roundings (xc, E, Wn
    and the backward's r)."""
    b, n, d = _shapes(params, xc)
    e, t = params["encoder"], params["threshold"]
    wn = normalized_dict(params["dict"])
    kw = {"dtype": torch.float32, "device": xc.device}
    if kernel in ("big_sae_fwd_bf16", "big_sae_bwd_bf16"):
        return _one_chunk_launches_bf16(kernel, e, t, wn, xc, r, alpha)
    if kernel == "big_sae_fwd":
        rows = fwd_chunk_rows(b, n)
        xk, gemm = xc[:rows], 2.0 * rows * n * d
        ct, xhat = torch.empty((n * rows,), **kw), torch.empty((rows, d), **kw)
        return {"big_sae_fwd_codes": (lambda: fwd_codes(xk, e, t, ct), gemm),
                "big_sae_fwd_decode": (lambda: fwd_decode(ct, wn, xhat),
                                       gemm)}
    if kernel != "big_sae_bwd":
        raise ValueError(f"{kernel} is not a chunked big-SAE kernel")
    rows = bwd_chunk_rows(b, n)
    xk, rk, gemm = xc[:rows], r[:rows], 2.0 * rows * n * d
    al = torch.as_tensor(alpha, **kw).reshape(1)
    c, g = torch.empty((rows, n), **kw), torch.empty((rows, n), **kw)
    de, dwn = torch.empty((d, n), **kw), torch.empty((n, d), **kw)
    dt, c_totals, l0f = (torch.zeros((n,), **kw) for _ in range(3))
    dctr, scal = torch.empty((d,), **kw), torch.empty((2,), **kw)
    coef = float(np.float32(2.0 / (b * d)))
    return {
        "big_sae_bwd_codes": (lambda: bwd_codes(xk, e, t, c), gemm),
        "big_sae_bwd_dpre": (lambda: bwd_dpre(rk, wn, c, al, g, b, coef),
                             gemm),
        "big_sae_bwd_de": (lambda: bwd_de(xk, g, de, True), gemm),
        "big_sae_bwd_dwn": (
            lambda: bwd_dwn(c, rk, dwn, True, False, coef), gemm),
        "big_sae_bwd_sums": (
            lambda: bwd_sums(c, g, rows, dt, c_totals, l0f, True), 0.0),
        "big_sae_bwd_dctr": (
            lambda: bwd_dctr(e, dt, c_totals, l0f, dctr, scal), 2.0 * n * d)}


def _one_chunk_launches_bf16(kernel, e, t, wn, xc, r, alpha) -> dict:
    """:func:`one_chunk_launches` for the bf16 forms."""
    b, d = xc.shape
    n = e.shape[1]
    fwd = kernel == "big_sae_fwd_bf16"
    sources = (xc, e, wn) if fwd else (xc, e, wn, r)
    copies = [torch.empty(v.shape, dtype=_BF16, device=xc.device)
              for v in sources]
    xb, eb, wnb = copies[:3]

    def round_all():
        for src, dst in zip(sources, copies):
            _build.launch(f"{kernel}_round", src.data_ptr(), dst.data_ptr(),
                          src.numel(), _build.stream_ptr(src))

    rows = (fwd_chunk_rows if fwd else bwd_chunk_rows)(b, n, BF16)
    xk, gemm = xb[:rows], 2.0 * rows * n * d
    parts = {f"{kernel}_round": (round_all, 0.0)}
    if fwd:
        ctb = torch.empty((n * rows,), dtype=_BF16, device=xc.device)
        xhat = torch.empty((rows, d), dtype=torch.float32, device=xc.device)
        parts["big_sae_fwd_bf16_codes"] = (
            lambda: fwd_bf16_codes(xk, eb, t, ctb), gemm)
        parts["big_sae_fwd_bf16_decode"] = (
            lambda: fwd_bf16_decode(ctb, wnb, xhat), gemm)
        return parts
    rk = copies[3][:rows]
    al = torch.as_tensor(alpha, dtype=torch.float32,
                         device=xc.device).reshape(1)
    (c, g), (cb, gb) = (torch.empty((2, rows, n), dtype=ty, device=xc.device)
                        for ty in (torch.float32, _BF16))
    de, dwn, dt, c_totals, l0f, dctr, scal = _bwd_outputs(n, d, xc.device)
    dtb = torch.zeros_like(dt)
    coef = float(np.float32(2.0 / (b * d)))
    parts.update({
        "big_sae_bwd_bf16_codes": (lambda: bwd_bf16_codes(xk, eb, t, c, cb),
                                   gemm),
        "big_sae_bwd_bf16_dpre": (
            lambda: bwd_bf16_dpre(rk, wnb, c, al, g, gb, b, coef), gemm),
        "big_sae_bwd_bf16_de": (lambda: bwd_bf16_de(xk, gb, de, True), gemm),
        "big_sae_bwd_bf16_dwn": (
            lambda: bwd_bf16_dwn(cb, rk, dwn, True, False, coef), gemm),
        "big_sae_bwd_bf16_sums": (
            lambda: bwd_bf16_sums(c, g, gb, rows, dt, dtb, c_totals, l0f,
                                  True), 0.0),
        "big_sae_bwd_bf16_dctr": (
            lambda: bwd_bf16_dctr(eb, dtb, c_totals, l0f, dctr, scal),
            2.0 * n * d)})
    return parts


# --- the loss-and-grads contract ----------------------------------------------

def fused_big_sae_loss_and_grads(params: dict, batch: torch.Tensor,
                                 l1_alpha, tied: bool,
                                 batch_tile: Optional[int] = None,
                                 feat_tile: Optional[int] = None,
                                 total_batch: Optional[int] = None,
                                 compute_dtype: str = "float32"):
    """Drop-in replacement for autograd of ``train/big_sae.py::_sae_loss``:
    (loss, aux, grads), aux = {"mse", "sparsity", "c_totals_delta",
    "mse_losses", "l0_mean"}, grads wrt the RAW params {dict, encoder,
    threshold, centering}. ``compute_dtype="bfloat16"`` runs both kernels'
    bf16 forms. Raises ValueError for a shape the kernels do not take (even
    on the CPU, as the JAX function does). ``total_batch`` normalizes the
    loss terms and grads on a data-sharded call (partial sums over this
    call's rows); the features are all local here, so a feature-sharded
    step composes K8 and K9 itself (``train/big_sae.py``)."""
    b, d = batch.shape
    n = params["dict"].shape[0]
    _check_unported(total_batch, b, compute_dtype)
    tb = _global_batch(total_batch, b)
    if batch_tile is None or feat_tile is None:
        tiles = pick_big_sae_tiles(
            b, n, d, compute_itemsize=2 if compute_dtype == BF16 else 4)
        if tiles is None:
            raise ValueError(
                f"no kernel tiles for batch={b} n_feats={n} d={d} (the "
                f"kernels need batch and n_feats multiples of "
                f"{_build.BIG_BATCH_TILE} and 1 <= d <= {_build.BIG_MAX_D}"
                + (f", bf16 compute d % {_build.BF16_D_MULTIPLE} == 0"
                   if compute_dtype == BF16 else "") + "); use the autodiff "
                "path")
        batch_tile, feat_tile = tiles
    batch = batch.to(torch.float32).contiguous()
    alpha = torch.as_tensor(l1_alpha, dtype=torch.float32,
                            device=batch.device)
    xc = (batch - params["centering"]).contiguous()
    x_hat = big_sae_forward(params, xc, batch_tile, feat_tile,
                            compute_dtype=compute_dtype)
    if tied:
        x_hat = x_hat + params["centering"]
    resid = (x_hat - batch).contiguous()  # r in the kernel math
    mse_losses = torch.mean(torch.square(resid), dim=-1)  # per example
    mse = torch.sum(torch.square(resid)) / (tb * d)

    de, dwn, dt, dctr_enc, c_totals, scal = big_sae_backward(
        params, alpha, xc, resid, batch_tile, feat_tile, total_batch=tb,
        compute_dtype=compute_dtype)
    sparsity = alpha * scal[0] / tb
    loss = mse + sparsity
    dctr = (dctr_enc + (2.0 / (tb * d)) * resid.sum(dim=0) if tied
            else dctr_enc)
    grads = {"dict": normalize_with_vjp(params["dict"], dwn),
             "encoder": de, "threshold": dt, "centering": dctr}
    aux = {"mse": mse, "sparsity": sparsity, "c_totals_delta": c_totals,
           "mse_losses": mse_losses, "l0_mean": scal[1] / tb}
    return loss, aux, grads
