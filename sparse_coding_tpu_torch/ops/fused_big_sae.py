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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops.fused_sae import normalize_with_vjp
from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
    _check_tiles,
    _check_unported,
    _on_cpu,
)


def _check_big_dtype(total_batch, batch_rows, compute_dtype) -> None:
    """K8/K9 take fp32 compute only; their bf16 forms are a later slice."""
    _check_unported(total_batch, batch_rows, compute_dtype,
                    ported=("float32",),
                    later="bf16 in K8/K9 is ROADMAP.md queue 1, item 16")


def pick_big_sae_tiles(batch: int, n_feats: int, d: int,
                       compute_itemsize: int = 4
                       ) -> Optional[tuple[int, int]]:
    """The (batch_tile, feat_tile) the CUDA kernels block at when they take
    the shape, else None (the caller uses autodiff). The kernels take any
    1 <= d <= 1024 with batch and n_feats multiples of 32; only float32
    compute is ported."""
    if compute_itemsize != 4:
        return None
    if (batch % _build.BIG_BATCH_TILE or n_feats % _build.BIG_FEAT_TILE
            or not 1 <= d <= _build.BIG_MAX_D):
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


def _kernel_checks(name: str, b: int, n: int, d: int, **tensors) -> None:
    _build.check_cuda_tensors(name, **tensors)
    _build.check_big_shape(name, b, n, d)


def _tiles(b, n, batch_tile, feat_tile):
    if batch_tile is not None and feat_tile is not None:
        _check_tiles(b, n, batch_tile, feat_tile)


# --- the chunk schedules ------------------------------------------------------

# K8 and K9 walk the batch in chunks whose codes — K8's Cᵀ [n, rows] fp32,
# K9's C and dpre G [rows, n] fp32 each — fit this workspace; the whole
# [B, n] codes are never formed.
WORKSPACE_BYTES = 2**30


def _chunk_rows(batch: int, n_feats: int, code_bytes: int) -> int:
    rows = WORKSPACE_BYTES // (code_bytes * n_feats) // 32 * 32
    return max(32, min(rows, batch))


def _row_chunks(batch: int, rows: int) -> list[tuple[int, int]]:
    return [(lo, min(lo + rows, batch)) for lo in range(0, batch, rows)]


def fwd_chunk_rows(batch: int, n_feats: int) -> int:
    """Rows per K8 chunk: the largest multiple of 32 whose [n, rows] fp32
    codes fit WORKSPACE_BYTES (at least 32, at most the batch). 16,384 at
    the trainer's shape (n = 16,384)."""
    return _chunk_rows(batch, n_feats, 4)


def fwd_chunks(batch: int, n_feats: int) -> list[tuple[int, int]]:
    """K8's batch chunks [lo, hi), in the order they run; the last may be
    shorter. Each writes its own rows of x̂."""
    return _row_chunks(batch, fwd_chunk_rows(batch, n_feats))


def bwd_chunk_rows(batch: int, n_feats: int) -> int:
    """Rows per K9 chunk: the largest multiple of 32 whose two [rows, n]
    fp32 workspaces fit WORKSPACE_BYTES (at least 32, at most the batch).
    8,192 at the trainer's shape (n = 16,384)."""
    return _chunk_rows(batch, n_feats, 2 * 4)


def bwd_chunks(batch: int, n_feats: int) -> list[tuple[int, int]]:
    """K9's batch chunks [lo, hi), in the order they are summed; the last
    may be shorter."""
    return _row_chunks(batch, bwd_chunk_rows(batch, n_feats))


# --- big_sae_fwd (K8) ---------------------------------------------------------

def big_sae_forward_plain(params: dict, xc: torch.Tensor) -> torch.Tensor:
    """x̂ [B, d] = relu(xc·E + t)·Wn, materializing the codes."""
    c = torch.relu(xc @ params["encoder"] + params["threshold"])
    return c @ normalized_dict(params["dict"])


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


def big_sae_forward(params: dict, xc: torch.Tensor,
                    batch_tile: Optional[int] = None,
                    feat_tile: Optional[int] = None,
                    compute_dtype: str = "float32") -> torch.Tensor:
    """x̂ = relu(xc·E + t)·Wn without materializing the codes (K8). ``params``
    holds the raw big-SAE params (dict/encoder/threshold); xc is
    pre-centered. ``batch_tile``/``feat_tile`` keep the JAX divisibility
    contract; the CUDA kernels block at their own tiles. CUDA: per chunk of
    :func:`fwd_chunks` the launches ``fwd_codes`` and ``fwd_decode``;
    counts one ``big_sae_fwd`` call. CPU: the plain version (the chunks
    write disjoint rows of x̂ and sum nothing across one another, so their
    schedule leaves nothing for a plain twin to mirror)."""
    b, n, d = _shapes(params, xc)
    _check_big_dtype(None, b, compute_dtype)
    _tiles(b, n, batch_tile, feat_tile)
    e, t = params["encoder"], params["threshold"]
    if _on_cpu("big_sae_fwd", xc, e, t, params["dict"]):
        return big_sae_forward_plain(params, xc)
    wn = normalized_dict(params["dict"])
    _kernel_checks("big_sae_fwd", b, n, d, xc=xc, encoder=e, wn=wn,
                   threshold=t)
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
                           xc: torch.Tensor, r: torch.Tensor):
    """(dE [d, n] wrt the raw encoder, dWn [n, d] wrt the normalized
    dictionary, dt [n], dctr_enc [d] = −Σ_b dpre·Eᵀ, c_totals [n] = Σ_b c,
    [l1, l0] sums [2]) from the residual r = x̂ − x, materializing the
    codes. dpre = (coef·r·Wnᵀ + α/B) ⊙ [pre > 0], coef = 2/(B·d)."""
    b, d = xc.shape
    e = params["encoder"]
    wn = normalized_dict(params["dict"])
    pre = xc @ e + params["threshold"]
    c = torch.relu(pre)
    mask = (pre > 0.0).to(torch.float32)
    coef = 2.0 / (b * d)
    dpre = (coef * (r @ wn.T) + alpha / b) * mask
    de = xc.T @ dpre
    dwn = coef * (c.T @ r)
    dt = dpre.sum(dim=0)
    dctr = -(dpre @ e.T).sum(dim=0)
    scal = torch.stack([c.sum(), mask.sum()])
    return de, dwn, dt, dctr, c.sum(dim=0), scal


def _backward_chunked_plain(e, wn, t, alpha, xc, r):
    """K9's chunk schedule in plain torch (the CPU twin of the kernels):
    the same chunks, each chunk's products and sums added in order."""
    b, d = xc.shape
    coef = 2.0 / (b * d)
    acc = None
    for lo, hi in bwd_chunks(b, e.shape[1]):
        xk, rk = xc[lo:hi], r[lo:hi]
        c = torch.relu(xk @ e + t)
        mask = (c > 0.0).to(torch.float32)  # = [pre > 0], NaN included
        g = (coef * (rk @ wn.T) + alpha / b) * mask
        part = (xk.T @ g, c.T @ rk, g.sum(dim=0), c.sum(dim=0),
                mask.sum(dim=0))
        acc = part if acc is None else tuple(a + p for a, p in zip(acc, part))
    de, dwn, dt, c_totals, l0 = acc
    scal = torch.stack([c_totals.double().sum(), l0.double().sum()])
    return (de, coef * dwn, dt, -(e @ dt), c_totals, scal.to(torch.float32))


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
    call. CPU: the same chunk schedule in plain torch."""
    b, n, d = _shapes(params, xc)
    _check_big_dtype(total_batch, b, compute_dtype)
    _tiles(b, n, batch_tile, feat_tile)
    if tuple(r.shape) != (b, d):
        raise ValueError(f"r must be {(b, d)}, got {tuple(r.shape)}")
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=xc.device)
    e, t = params["encoder"], params["threshold"]
    if _on_cpu("big_sae_bwd", xc, r, e, t, params["dict"], alpha):
        return _backward_chunked_plain(e, normalized_dict(params["dict"]), t,
                                       alpha, xc, r)
    wn = normalized_dict(params["dict"])
    alpha = alpha.reshape(1).contiguous()
    _kernel_checks("big_sae_bwd", b, n, d, xc=xc, r=r, encoder=e, wn=wn,
                   threshold=t, alpha=alpha)
    kw = {"dtype": torch.float32, "device": xc.device}
    de = torch.empty((d, n), **kw)
    dwn = torch.empty((n, d), **kw)
    dt = torch.empty((n,), **kw)
    c_totals = torch.empty((n,), **kw)
    l0f = torch.empty((n,), **kw)
    dctr = torch.empty((d,), **kw)
    scal = torch.empty((2,), **kw)
    ws = torch.empty((2, bwd_chunk_rows(b, n), n), **kw)
    c, g = ws[0], ws[1]
    coef = float(np.float32(2.0 / (b * d)))
    chunks = bwd_chunks(b, n)
    for i, (lo, hi) in enumerate(chunks):
        first, last = i == 0, i == len(chunks) - 1
        xk, rk = xc[lo:hi], r[lo:hi]
        bwd_codes(xk, e, t, c)
        bwd_dpre(rk, wn, c, alpha, g, b, coef)
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
    (``big_sae_fwd`` or ``big_sae_bwd``), in the order a call runs them, on
    the first chunk of its schedule over these CUDA inputs (xc [B, d], and
    for the backward the residual r [B, d] and alpha); the outputs and the
    chunk's workspace are allocated here. Each launch writes only its own
    buffers, so any one of them can be timed alone once the earlier ones
    have run. FLOPs counts the products' multiply-adds twice (dctr's
    matvec too), 0 for the sums."""
    b, n, d = _shapes(params, xc)
    e, t = params["encoder"], params["threshold"]
    wn = normalized_dict(params["dict"])
    kw = {"dtype": torch.float32, "device": xc.device}
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
    threshold, centering}. Raises ValueError for a shape the kernels do
    not take (even on the CPU, as the JAX function does)."""
    b, d = batch.shape
    n = params["dict"].shape[0]
    _check_big_dtype(total_batch, b, compute_dtype)
    if batch_tile is None or feat_tile is None:
        tiles = pick_big_sae_tiles(b, n, d)
        if tiles is None:
            raise ValueError(
                f"no kernel tiles for batch={b} n_feats={n} d={d} (the "
                f"kernels need batch and n_feats multiples of "
                f"{_build.BIG_BATCH_TILE} and 1 <= d <= {_build.BIG_MAX_D}); "
                "use the autodiff path")
        batch_tile, feat_tile = tiles
    batch = batch.to(torch.float32).contiguous()
    alpha = torch.as_tensor(l1_alpha, dtype=torch.float32,
                            device=batch.device)
    xc = (batch - params["centering"]).contiguous()
    x_hat = big_sae_forward(params, xc, batch_tile, feat_tile)
    if tied:
        x_hat = x_hat + params["centering"]
    resid = (x_hat - batch).contiguous()  # r in the kernel math
    mse_losses = torch.mean(torch.square(resid), dim=-1)  # per example
    mse = torch.sum(torch.square(resid)) / (b * d)

    de, dwn, dt, dctr_enc, c_totals, scal = big_sae_backward(
        params, alpha, xc, resid, batch_tile, feat_tile)
    sparsity = alpha * scal[0] / b
    loss = mse + sparsity
    dctr = dctr_enc + (2.0 / (b * d)) * resid.sum(dim=0) if tied else dctr_enc
    grads = {"dict": normalize_with_vjp(params["dict"], dwn),
             "encoder": de, "threshold": dt, "centering": dctr}
    aux = {"mse": mse, "sparsity": sparsity, "c_totals_delta": c_totals,
           "mse_losses": mse_losses, "l0_mean": scal[1] / b}
    return loss, aux, grads
