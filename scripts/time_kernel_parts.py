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
  the checkout's ``_build.LAUNCHES`` counts; else the whole calls only).

Times are CUDA-event means over ``--iters`` launches after one warm-up.
The kernels of the checkout in the working directory are built and timed,
so two checkouts compare in one session by running this script from each
root in turns (A, B, B, A):

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


def big(g: torch.Generator, iters: int) -> dict:
    """One whole call of K8 and of K9 at the big-SAE shape, then each of its
    launches where the checkout lists them (``one_chunk_launches``)."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    b, n, d = 65536, 16384, 1024
    kw = {"dtype": torch.float32, "device": "cuda"}
    p = {"dict": torch.randn((n, d), generator=g, **kw),
         "encoder": torch.randn((d, n), generator=g, **kw) / math.sqrt(d),
         "threshold": torch.randn((n,), generator=g, **kw) * 0.1,
         "centering": torch.zeros((d,), **kw)}
    xc = torch.randn((b, d), generator=g, **kw)
    r = torch.randn((b, d), generator=g, **kw) * 0.1
    al = torch.tensor(1e-3, **kw)
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


def ensemble_inputs(g: torch.Generator):
    """The canonical ensemble shape's inputs: encoder and decoder (glorot),
    bias, an L1 grid and a batch."""
    n_m, b, n, d = 32, 2048, 2048, 512
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
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
    print(json.dumps({"tree": os.getcwd(), "card": card,
                      "big": big(g, args.iters),
                      "ensemble": ensemble(g, args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
