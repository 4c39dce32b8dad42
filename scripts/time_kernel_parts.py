#!/usr/bin/env python3
"""Time the port's three chunked kernels, launch by launch, on one CUDA card
and print one JSON line.

- K9 (``big_sae_bwd``): each of its launches on one 8,192-row chunk at the
  big-SAE shape (d=1024, n=16,384), the size of one chunk of its 1 GiB
  workspace;
- the untied backward (``sae_untied_bwd``) and forward
  (``sae_untied_fwd``): one whole call of each at the canonical ensemble
  shape (32 members, batch 2048, n=2048, d=512), and each of their
  launches where the checkout has them.

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


def k9_parts(g: torch.Generator, iters: int) -> dict:
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    rows, n, d, batch = 8192, 16384, 1024, 65536
    kw = {"dtype": torch.float32, "device": "cuda"}
    xk = torch.randn((rows, d), generator=g, **kw)
    rk = torch.randn((rows, d), generator=g, **kw) * 0.1
    e = torch.randn((d, n), generator=g, **kw) / math.sqrt(d)
    t = torch.randn((n,), generator=g, **kw) * 0.1
    wn = fb.normalized_dict(torch.randn((n, d), generator=g, **kw))
    al = torch.full((1,), 1e-3, **kw)
    c, gw = torch.empty((rows, n), **kw), torch.empty((rows, n), **kw)
    de, dwn = torch.empty((d, n), **kw), torch.empty((n, d), **kw)
    dt, ct, l0f = (torch.zeros((n,), **kw) for _ in range(3))
    coef = float(np.float32(2.0 / (batch * d)))
    parts = {
        "big_sae_bwd_codes": lambda: fb.bwd_codes(xk, e, t, c),
        "big_sae_bwd_dpre": lambda: fb.bwd_dpre(rk, wn, c, al, gw, batch,
                                                coef),
        "big_sae_bwd_de": lambda: fb.bwd_de(xk, gw, de, True),
        "big_sae_bwd_dwn": lambda: fb.bwd_dwn(c, rk, dwn, True, False, coef),
        "big_sae_bwd_sums": lambda: fb.bwd_sums(c, gw, rows, dt, ct, l0f,
                                                True),
    }
    return {k: time_ms(fn, iters) for k, fn in parts.items()}


def untied(g: torch.Generator, iters: int) -> dict:
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    n_m, b, n, d = 32, 2048, 2048, 512
    kw = {"dtype": torch.float32, "device": "cuda"}
    lim = math.sqrt(6.0 / (n + d))
    e = (torch.rand((n_m, n, d), generator=g, **kw) * 2 - 1) * lim
    dec = (torch.rand((n_m, n, d), generator=g, **kw) * 2 - 1) * lim
    bias = (torch.rand((n_m, n), generator=g, **kw) - 0.5) * 0.02
    al = torch.logspace(-4, -2, n_m, device="cuda")
    x = torch.randn((b, d), generator=g, **kw) / math.sqrt(d)
    r = ft.sae_untied_fwd_plain(e, dec, bias, x).contiguous()
    out = {"sae_untied_fwd": time_ms(
        lambda: ft.sae_untied_fwd(e, dec, bias, x), iters),
        "sae_untied_bwd": time_ms(
        lambda: ft.sae_untied_bwd(e, dec, bias, al, x, r), iters)}
    if hasattr(ft, "untied_fwd_chunks"):
        wn = torch.empty((n_m, n, d), **kw)
        ct = torch.empty((n_m * n * b,), **kw)
        rf = torch.empty((n_m, b, d), **kw)
        fwd_parts = {
            "sae_untied_fwd_norms": lambda: ft.untied_fwd_norms(dec, wn),
            "sae_untied_fwd_codes": lambda: ft.untied_fwd_codes(x, e, bias,
                                                                ct),
            "sae_untied_fwd_decode": lambda: ft.untied_fwd_decode(
                ct, wn, x, rf, b),
        }
        out.update({k: time_ms(fn, iters) for k, fn in fwd_parts.items()})
        del wn, ct, rf
    if not hasattr(ft, "untied_bwd_chunks"):
        return out
    c, gw = (torch.empty((n_m, b, n), **kw) for _ in range(2))
    de, dwn = (torch.empty((n_m, n, d), **kw) for _ in range(2))
    db, act, csum, nrm = (torch.empty((n_m, n), **kw) for _ in range(4))
    part = torch.empty((n_m, ft.UNTIED_LOSS_SLICES, 2), **kw)
    loss4 = torch.empty((n_m, 4), **kw)
    coef = float(np.float32(2.0 / (b * d)))
    parts = {
        "sae_untied_bwd_norms": lambda: ft.untied_bwd_norms(dec, nrm),
        "sae_untied_bwd_codes": lambda: ft.untied_bwd_codes(x, e, bias, c),
        "sae_untied_bwd_dpre": lambda: ft.untied_bwd_dpre(
            r, dec, nrm, c, al, gw, b, coef),
        "sae_untied_bwd_de": lambda: ft.untied_bwd_de(x, gw, de, True),
        "sae_untied_bwd_dwn": lambda: ft.untied_bwd_dwn(c, r, dwn, b, True,
                                                        True, coef),
        "sae_untied_bwd_sums": lambda: ft.untied_bwd_sums(c, gw, b, db, act,
                                                          csum, True),
        "sae_untied_bwd_loss": lambda: ft.untied_bwd_loss(
            r, de, dwn, db, act, csum, al, part, loss4),
    }
    out.update({k: time_ms(fn, iters) for k, fn in parts.items()})
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
                      "k9": k9_parts(g, args.iters),
                      "untied": untied(g, args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
