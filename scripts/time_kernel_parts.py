#!/usr/bin/env python3
"""Time the port's chunked kernels, whole calls and launch by launch, on
one CUDA card and print one JSON line.

- K8 (``big_sae_fwd``) and K9 (``big_sae_bwd``): one whole call of each at
  the big-SAE shape (batch 65,536, n=16,384, d=1024), and each of their
  launches on the first chunk of its 1 GiB workspace (16,384 and 8,192
  rows) where the checkout lists them (``fused_big_sae.one_chunk_launches``;
  a checkout without it gets the whole calls only);
- the tied and untied forwards and backwards (``sae_tied_fwd``,
  ``sae_tied_bwd``, ``sae_untied_fwd``, ``sae_untied_bwd``): one whole
  call of each at the canonical ensemble shape (32 members, batch 2048,
  n=2048, d=512), and each of their launches where the checkout lists them
  (``fused_sae_tiled.one_chunk_launches``, for the kernels whose parts
  the checkout's ``_build.LAUNCHES`` counts; else the whole calls only);
- the two backwards' bf16 forms (``sae_tied_bwd_bf16``,
  ``sae_untied_bwd_bf16``, ``compute_dtype="bfloat16"``) at the canonical
  shape and at chip_smoke.py phase 13's (16 members, batch 2048, n=8192,
  d=2048): one whole call of each, each of its launches on one chunk of
  every member (``fused_sae_tiled.one_chunk_launches_bf16``) with the
  products' TFLOP/s, and beside them one cuBLAS bf16 ``torch.bmm`` of each
  product shape (a yardstick of the mainloop's rate; the port never calls
  it). Each is timed in ``WINDOWS`` windows: the median, min and max and
  every window; the card's SM clock, power draw and temperature are
  sampled (``nvidia-smi``, every 50 ms) while the whole calls run;
- the big SAE's bf16 forms (``big_sae_fwd_bf16``, ``big_sae_bwd_bf16``)
  at the big-SAE shape: whole calls in ``WINDOWS`` windows with the card
  sampled, K8 bf16's launches on its first chunk (32,768 rows: round,
  codes, decode) and K9 bf16's on its first (5,440 rows;
  ``fused_big_sae.one_chunk_launches``) with the products' TFLOP/s, K9's
  later chunks' de and dwn (which add to the grads, ``_acc``), and beside
  each product one cuBLAS bf16 ``torch.mm`` of its shape (a yardstick;
  the port never calls it);
- the two forwards' bf16 forms (``sae_tied_fwd_bf16``,
  ``sae_untied_fwd_bf16``) at the same two shapes as ``bf16_bwd``: one
  whole call of each in ``WINDOWS`` windows with the card sampled, each
  of its launches on one chunk of every member (round, norms, codes,
  decode) with the products' TFLOP/s, and one cuBLAS bf16 ``torch.bmm``
  of each product's shape;
- the tied Adam epilogue (``sae_tied_adam_vjp``, K4) with fp32 and with
  bf16 moments, with and without the bias group, at the canonical shape
  and at phase 13's (16 members, n=8192, d=2048), then without the bias
  group over d = 512, 1024, 2048, 4096 at the canonical shape's element
  count (a row's width alone changing); the untied one
  (``sae_untied_adam_vjp``, K6) at the first two shapes as a control.
  Each in ``WINDOWS`` windows with its byte bound (each input read once,
  each output written once, at 3.35 TB/s) and its achieved TB/s.

``--only`` picks the groups (``big``, ``ensemble``, ``bf16_bwd``,
``big_bf16``, ``bf16_fwd``, ``adam``; all by default). A window is a CUDA-event
mean over ``--iters`` launches after one warm-up. The kernels of the checkout in
the working directory are built and timed, so two checkouts compare on
one card by running this script from each root in turns (A, B, B, A), in
one command:

    (cd parent && python3 /path/to/scripts/time_kernel_parts.py)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


BIG_SHAPE = (65536, 16384, 1024)  # (batch, n, d): BigSAEArgs' defaults


def big_inputs(g: torch.Generator):
    """The big-SAE shape's params, centered batch, residual and alpha."""
    b, n, d = BIG_SHAPE
    kw = {"dtype": torch.float32, "device": "cuda"}
    p = {"dict": torch.randn((n, d), generator=g, **kw),
         "encoder": torch.randn((d, n), generator=g, **kw) / math.sqrt(d),
         "threshold": torch.randn((n,), generator=g, **kw) * 0.1,
         "centering": torch.zeros((d,), **kw)}
    xc = torch.randn((b, d), generator=g, **kw)
    r = torch.randn((b, d), generator=g, **kw) * 0.1
    return p, xc, r, torch.tensor(1e-3, **kw)


def big(g: torch.Generator, iters: int) -> dict:
    """One whole call of K8 and of K9 at the big-SAE shape, then each of its
    launches where the checkout lists them (``one_chunk_launches``)."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    p, xc, r, al = big_inputs(g)
    calls = {
        "big_sae_fwd": (lambda: fb.big_sae_forward(p, xc), {}),
        "big_sae_bwd": (lambda: fb.big_sae_backward(p, al, xc, r),
                        {"r": r, "alpha": al}),
    }
    out = {}
    for name, (call, inputs) in calls.items():
        out[name] = time_ms(call, iters)
        if hasattr(fb, "one_chunk_launches"):
            parts = fb.one_chunk_launches(name, p, xc, **inputs)
            out.update({k: time_ms(fn, iters)
                        for k, (fn, _) in parts.items()})
            del parts
        torch.cuda.empty_cache()
    return out


BF16_SHAPES = {"canonical": (32, 2048, 2048, 512),
               "lm": (16, 2048, 8192, 2048)}
WINDOWS = 5


def windows_ms(fn, iters: int) -> dict:
    """``WINDOWS`` windows of ``time_ms``: their median, min, max and each
    window's mean."""
    w = [time_ms(fn, iters) for _ in range(WINDOWS)]
    return {"ms": float(np.median(w)), "min": min(w), "max": max(w),
            "windows": w}


class CardSampler:
    """Samples the card's SM clock (MHz), power draw (W) and temperature
    (C) through ``nvidia-smi`` every 50 ms from the first sample on until
    the block ends; ``stats`` maps each to its [min, median, max] over the
    samples (``None`` where nvidia-smi gave none)."""

    FIELDS = ("clocks.sm", "power.draw", "temperature.gpu")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=" + ",".join(self.FIELDS),
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.first = self.proc.stdout.readline()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        rest, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in [self.first, *rest.splitlines()]:
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        cols = [list(c) for c in zip(*rows)] if rows else [[]] * 3
        self.stats = {f: ([min(c), float(np.median(c)), max(c)] if c
                          else None)
                      for f, c in zip(self.FIELDS, cols)}
        self.stats["samples"] = len(rows)


def ensemble_inputs(g: torch.Generator, shape=BF16_SHAPES["canonical"]):
    """An ensemble shape's inputs (members, batch, n, d; the canonical one
    by default): encoder and decoder (glorot), bias, an L1 grid and a
    batch."""
    n_m, b, n, d = shape
    kw = {"dtype": torch.float32, "device": "cuda"}
    lim = math.sqrt(6.0 / (n + d))
    e = (torch.rand((n_m, n, d), generator=g, **kw) * 2 - 1) * lim
    dec = (torch.rand((n_m, n, d), generator=g, **kw) * 2 - 1) * lim
    bias = (torch.rand((n_m, n), generator=g, **kw) - 0.5) * 0.02
    al = torch.logspace(-4, -2, n_m, device="cuda")
    x = torch.randn((b, d), generator=g, **kw) / math.sqrt(d)
    return e, dec, bias, al, x


def ensemble(g: torch.Generator, iters: int) -> dict:
    """One whole call of each chunked ensemble kernel at the canonical
    shape, then each of its launches where the checkout lists them
    (``one_chunk_launches``)."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, bias, al, x = ensemble_inputs(g)
    rt = ft.sae_tied_fwd_plain(e, bias, x).contiguous()
    ru = ft.sae_untied_fwd_plain(e, dec, bias, x).contiguous()
    calls = {
        "sae_tied_fwd": (lambda: ft.sae_tied_fwd(e, bias, x), {}),
        "sae_tied_bwd": (lambda: ft.sae_tied_bwd(e, bias, al, x, rt),
                         {"alphas": al, "resid": rt}),
        "sae_untied_fwd": (lambda: ft.sae_untied_fwd(e, dec, bias, x),
                           {"decoder": dec}),
        "sae_untied_bwd": (lambda: ft.sae_untied_bwd(e, dec, bias, al, x,
                                                     ru),
                           {"decoder": dec, "alphas": al, "resid": ru}),
    }
    out = {}
    for name, (call, inputs) in calls.items():
        out[name] = time_ms(call, iters)
        if (hasattr(ft, "one_chunk_launches")
                and f"{name}_codes" in _build.LAUNCHES):
            parts = ft.one_chunk_launches(name, e, bias, x, **inputs)
            out.update({k: time_ms(fn, iters)
                        for k, (fn, _) in parts.items()})
            del parts
    return out


def bf16_group(calls: dict, bmms: dict, shape: tuple, e, bias, x,
               iters: int) -> dict:
    """Time bf16 ensemble forms at ``shape``: each whole call (``calls``:
    name -> (call, one_chunk_launches_bf16's keyword inputs)) with the
    card sampled, then each of its launches on one chunk of every member
    with the products' TFLOP/s; then one cuBLAS bf16 ``torch.bmm`` of each
    product's shape on random operands (``bmms``: key -> the shapes of A
    and B as stored, and whether each is read transposed)."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    n_m, b, n, d = shape
    flops = 2.0 * n_m * b * n * d
    out = {"shape": list(shape)}
    for name, (call, inputs) in calls.items():
        with CardSampler() as card:
            out[name] = windows_ms(call, iters)
        out[name]["card"] = card.stats
        torch.cuda.empty_cache()
        parts = ft.one_chunk_launches_bf16(name, e, bias, x, **inputs)
        for k, (fn, part_flops) in parts.items():
            out[k] = windows_ms(fn, iters)
            if part_flops:
                out[k]["tflops"] = part_flops / out[k]["ms"] / 1e9
        del parts
        torch.cuda.empty_cache()
    h = {"dtype": torch.bfloat16, "device": "cuda"}
    for key, (sa, sb, ta, tb) in bmms.items():
        a, bm = torch.randn(sa, **h), torch.randn(sb, **h)
        a, bm = (a.transpose(1, 2) if ta else a,
                 bm.transpose(1, 2) if tb else bm)
        res = torch.empty((n_m, a.shape[1], bm.shape[2]), **h)
        out[key] = windows_ms(lambda: torch.bmm(a, bm, out=res), iters)
        out[key]["tflops"] = flops / out[key]["ms"] / 1e9
        del a, bm, res
        torch.cuda.empty_cache()
    return out


def bf16_bwd(g: torch.Generator, iters: int, shape: tuple) -> dict:
    """:func:`bf16_group` of the two bf16 backwards, beside a ``bmm`` of
    [Z, rows, d] · [Z, d, n] (codes, dpre) and [Z, n, rows] · [Z, rows, d]
    (the weight grads)."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, bias, al, x = ensemble_inputs(g, shape)
    bf = "bfloat16"
    rt = ft.sae_tied_fwd_plain(e, bias, x, None, bf).contiguous()
    ru = ft.sae_untied_fwd_plain(e, dec, bias, x, bf).contiguous()
    calls = {
        "sae_tied_bwd_bf16": (
            lambda: ft.sae_tied_bwd(e, bias, al, x, rt, None, bf),
            {"alphas": al, "resid": rt}),
        "sae_untied_bwd_bf16": (
            lambda: ft.sae_untied_bwd(e, dec, bias, al, x, ru, bf),
            {"decoder": dec, "alphas": al, "resid": ru}),
    }
    n_m, b, n, d = shape
    bmms = {"bmm_nt": ((n_m, b, d), (n_m, n, d), False, True),
            "bmm_tn": ((n_m, b, n), (n_m, b, d), True, False)}
    return bf16_group(calls, bmms, shape, e, bias, x, iters)


def bf16_fwd(g: torch.Generator, iters: int, shape: tuple) -> dict:
    """:func:`bf16_group` of the two bf16 forwards, beside a ``bmm`` of
    [Z, n, d] · [Z, d, rows] (codes, feature-major) and [Z, rows, n] ·
    [Z, n, d] (decode)."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, bias, _, x = ensemble_inputs(g, shape)
    bf = "bfloat16"
    calls = {
        "sae_tied_fwd_bf16": (
            lambda: ft.sae_tied_fwd(e, bias, x, None, bf), {}),
        "sae_untied_fwd_bf16": (
            lambda: ft.sae_untied_fwd(e, dec, bias, x, bf),
            {"decoder": dec}),
    }
    n_m, b, n, d = shape
    bmms = {"bmm_codes": ((n_m, n, d), (n_m, d, b), False, False),
            "bmm_decode": ((n_m, n, b), (n_m, n, d), True, False)}
    return bf16_group(calls, bmms, shape, e, bias, x, iters)


def big_bf16(g: torch.Generator, iters: int) -> dict:
    """Whole calls of K8's and K9's bf16 forms at the big-SAE shape, K9
    bf16's launches on its first chunk with the products' TFLOP/s, the
    later chunks' de and dwn, and one cuBLAS bf16 ``torch.mm`` of each
    product's shape: [rows, d] · [d, n] (codes), [rows, d] · [n, d]ᵀ
    (dpre), [rows, d]ᵀ · [rows, n] (de), [rows, n]ᵀ · [rows, d] (dwn)."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    bf = "bfloat16"
    b, n, d = BIG_SHAPE
    p, xc, r, al = big_inputs(g)
    calls = {
        "big_sae_fwd_bf16": lambda: fb.big_sae_forward(p, xc,
                                                       compute_dtype=bf),
        "big_sae_bwd_bf16": lambda: fb.big_sae_backward(p, al, xc, r,
                                                        compute_dtype=bf)}
    rows = fb.bwd_chunk_rows(b, n, bf)
    out = {"shape": [b, n, d], "rows": rows,
           "chunks": len(fb.bwd_chunks(b, n, bf))}
    for name, call in calls.items():
        with CardSampler() as card:
            out[name] = windows_ms(call, iters)
        out[name]["card"] = card.stats
        torch.cuda.empty_cache()
    gemm = 2.0 * rows * n * d
    for kernel in ("big_sae_fwd_bf16", "big_sae_bwd_bf16"):
        parts = fb.one_chunk_launches(kernel, p, xc, r, al)
        for k, (fn, flops) in parts.items():
            out[k] = windows_ms(fn, iters)
            if flops:
                out[k]["tflops"] = flops / out[k]["ms"] / 1e9
        del parts
        torch.cuda.empty_cache()
    h = {"dtype": torch.bfloat16, "device": "cuda"}
    xk, rk = xc[:rows].to(torch.bfloat16), r[:rows].to(torch.bfloat16)
    eb, wnb = p["encoder"].to(torch.bfloat16), p["dict"].to(torch.bfloat16)
    cb, gb = torch.randn((rows, n), **h), torch.randn((rows, n), **h) * 1e-3
    de = torch.zeros((d, n), dtype=torch.float32, device="cuda")
    dwn = torch.zeros((n, d), dtype=torch.float32, device="cuda")
    c_out, de_out, dwn_out = (torch.empty(s, **h)
                              for s in ((rows, n), (d, n), (n, d)))
    timed = {
        "big_sae_bwd_bf16_de_acc": lambda: fb.bwd_bf16_de(xk, gb, de, False),
        "big_sae_bwd_bf16_dwn_acc": lambda: fb.bwd_bf16_dwn(
            cb, rk, dwn, False, False, 1.0),
        "mm_codes": lambda: torch.mm(xk, eb, out=c_out),
        "mm_dpre": lambda: torch.mm(rk, wnb.T, out=c_out),
        "mm_de": lambda: torch.mm(xk.T, gb, out=de_out),
        "mm_dwn": lambda: torch.mm(cb.T, rk, out=dwn_out)}
    for k, fn in timed.items():
        out[k] = windows_ms(fn, iters)
        out[k]["tflops"] = gemm / out[k]["ms"] / 1e9
    del xk, rk, cb, gb, de, dwn, c_out, de_out, dwn_out
    torch.cuda.empty_cache()
    # K8 bf16's products at its chunk's rows: [rows, d] · [d, n] (codes)
    # and [rows, n] · [n, d] (decode)
    fwd_rows = fb.fwd_chunk_rows(b, n, bf)
    out["fwd_rows"] = fwd_rows
    xf = xc[:fwd_rows].to(torch.bfloat16)
    cf = torch.randn((fwd_rows, n), **h)
    xhat = torch.empty((fwd_rows, d), **h)
    fwd_gemm = 2.0 * fwd_rows * n * d
    for k, fn in {"mm_fwd_codes": lambda: torch.mm(xf, eb, out=cf),
                  "mm_decode": lambda: torch.mm(cf, wnb, out=xhat)}.items():
        out[k] = windows_ms(fn, iters)
        out[k]["tflops"] = fwd_gemm / out[k]["ms"] / 1e9
    del xf, cf, xhat, eb, wnb
    torch.cuda.empty_cache()
    return out


HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's device memory rate
# (members, n, d): the canonical ensemble shape, phase 13's, then d swept
# at the canonical shape's element count
ADAM_SHAPES = {"canonical": (32, 2048, 512), "lm": (16, 8192, 2048)}
ADAM_SWEEP = {f"d{d}": (32, 2048 * 512 // d, d) for d in (512, 1024, 2048,
                                                         4096)}


def adam_inputs(g: torch.Generator, shape: tuple, moments, untied: bool):
    """An Adam epilogue's inputs at ``shape``: the raw dictionary (glorot)
    and its dW, a mid-training state (moments in ``moments``), per-member
    lr and bias corrections; for the untied one the decoder's too."""
    n_m, n, d = shape
    kw = {"dtype": torch.float32, "device": "cuda"}
    lim = math.sqrt(6.0 / (n + d))

    def side():
        w = (torch.rand((n_m, n, d), generator=g, **kw) * 2 - 1) * lim
        dw = torch.randn((n_m, n, d), generator=g, **kw) * 1e-3
        mu = (torch.randn((n_m, n, d), generator=g, **kw) * 1e-3).to(moments)
        nu = ((torch.rand((n_m, n, d), generator=g, **kw) + 0.5)
              * 1e-6).to(moments)
        return [w, dw, mu, nu]

    args = side() + (side() if untied else [])
    hyp = [torch.full((n_m,), v, **kw) for v in (1e-3, 0.5, 0.01)]
    return args + hyp


def with_bound(rec: dict, nbytes: float) -> dict:
    """``rec`` (a ``windows_ms`` record) with the bytes the call must move
    (each input read once, each output written once), its byte bound, the
    share of it reached and the achieved TB/s."""
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    rec.update(bytes=nbytes, bound_ms=bound, share=bound / rec["ms"],
               tbps=nbytes / rec["ms"] / 1e9)
    return rec


def adam(g: torch.Generator, iters: int) -> dict:
    """The tied Adam epilogue with fp32 and bf16 moments (with and without
    the bias group) at ADAM_SHAPES and, without it, over ADAM_SWEEP; the
    untied one at ADAM_SHAPES as a control. Each: ``windows_ms``, the
    bytes it must move, its bound and achieved TB/s."""
    from sparse_coding_tpu_torch.ops import fused_sae as fs

    out = {}
    cases = [(tag, shape, bias) for tag, shape in ADAM_SHAPES.items()
             for bias in (False, True)]
    cases += [(tag, shape, False) for tag, shape in ADAM_SWEEP.items()]
    for moments in (torch.float32, torch.bfloat16):
        mb = torch.finfo(moments).bits // 8
        mname = "bf16" if moments == torch.bfloat16 else "f32"
        for tag, shape, bias in cases:
            n_m, n, d = shape
            args = adam_inputs(g, shape, moments, untied=False)
            kw = {}
            if bias:
                rows = lambda s: torch.randn((n_m, n), generator=g,
                                             device="cuda") * s
                kw = dict(bias=rows(0.01), db=rows(1e-3), mu_b=rows(1e-3),
                          nu_b=rows(1e-6).abs())
            nbytes = (3 * 4 + 4 * mb) * n_m * n * d + 12 * n_m + (
                28 * n_m * n if bias else 0)
            key = f"tied_{mname}_{tag}" + ("_bias" if bias else "")
            out[key] = with_bound(windows_ms(
                lambda: fs.sae_tied_adam_vjp(*args, **kw), iters), nbytes)
            del args, kw
            torch.cuda.empty_cache()
        for tag, shape in ADAM_SHAPES.items():
            n_m, n, d = shape
            args = adam_inputs(g, shape, moments, untied=True)
            nbytes = (6 * 4 + 8 * mb) * n_m * n * d + 12 * n_m
            out[f"untied_{mname}_{tag}"] = with_bound(windows_ms(
                lambda: fs.sae_untied_adam_vjp(*args), iters), nbytes)
            del args
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only",
                    default="big,ensemble,bf16_bwd,big_bf16,bf16_fwd,adam",
                    help="comma-separated groups to time")
    args = ap.parse_args()
    groups = args.only.split(",")
    if not torch.cuda.is_available():
        print("time_kernel_parts: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from sparse_coding_tpu_torch.ops import _build

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator("cuda").manual_seed(0)
    out = {"tree": os.getcwd(), "card": card}
    if "big" in groups:
        out["big"] = big(g, args.iters)
    if "ensemble" in groups:
        out["ensemble"] = ensemble(g, args.iters)
    if "bf16_bwd" in groups:
        out["bf16_bwd"] = {
            tag: bf16_bwd(g, args.iters, shape)
            for tag, shape in BF16_SHAPES.items()}
    if "big_bf16" in groups:
        out["big_bf16"] = big_bf16(g, args.iters)
    if "bf16_fwd" in groups:
        out["bf16_fwd"] = {
            tag: bf16_fwd(g, args.iters, shape)
            for tag, shape in BF16_SHAPES.items()}
    if "adam" in groups:
        with CardSampler() as sampled:
            out["adam"] = adam(g, args.iters)
        out["adam"]["card"] = sampled.stats
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
