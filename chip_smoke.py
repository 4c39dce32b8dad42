#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparse_coding_tpu_torch``) on one
NVIDIA GPU. Imports nothing of JAX and nothing of the JAX package.

Phases — any failure raises, and the script exits non-zero with no result:

1. card: name and power limit (nvidia-smi), then every CUDA kernel is
   built from ``sparse_coding_tpu_torch/ops/csrc`` (one nvcc per source,
   all started together);
2. kernels: each kernel (sae_tied_fwd, sae_tied_bwd, sae_tied_adam_vjp) and
   each of the four tied contracts (K1 fused_tied_sae_grads, K2
   fused_tied_sae_train_step, K3 tiled_tied_sae_grads, K4
   fused_tied_adam_vjp_update) is held against its plain PyTorch version
   on the same inputs on the card, at the main path's shapes and at two
   small odd shapes; each kernel and its plain version are timed at the
   main path's shapes;
3. main path: a synthetic activation store (d=512) is written with the
   port's ChunkWriter, then ``basic_l1_sweep`` trains 32 tied SAEs (an L1
   grid, ratio 4, batch 2048) for one epoch (208 steps, metrics at steps
   100 and 200) on the default kernel path ``train_step_tiled``, with
   every launch count zeroed just before and read just after; the logged
   losses must be finite, eval.json must order the L1 grid, and the
   artifacts must load;
4. reference: the same epoch from the same init in the same batch order
   on the autodiff path (plain PyTorch, no kernel); each member's logged
   single-batch mse must match the main path's;
5. other paths: a few steps each of all four kernel paths through
   ``Ensemble`` (counts zeroed before each), held against the autodiff
   path from the same init on the same batches;
6. summary: one ``{"kernels": [...]}`` line, the card's name and power
   limit, and the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py`` (one card;
``--report PATH`` also writes every measurement as JSON).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth. The kernels run true fp32 (no TF32).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# main path: Pythia-70M residual width, ratio 4, a 32-member L1 grid
D, RATIO, N_MEMBERS, BATCH = 512, 4, 32, 2048
N_FEATS = D * RATIO
ROWS_PER_CHUNK = 16 * BATCH
# one epoch of 13 chunks = 208 steps: basic_l1_sweep logs every 100 steps,
# so the main path logs at steps 100 and 200
N_CHUNKS = 13
SEED, LR = 0, 1e-3
DEV = "cuda"

# tolerances of kernel vs plain version, both fp32 on the card. Float
# outputs: |Δ|max <= RTOL·max|ref|. The two sides sum in different orders
# (blocked SIMT loops vs cuBLAS), ~1e-6 relative; a pre-activation within
# rounding of 0 can flip its ReLU mask on one side, which moves that
# feature's dW row by |dpre·x| and its activity count by 1 — so dW-like
# outputs carry a looser bound and activity a count bound.
RTOL_EXACT = 1e-5     # r, losses, the Adam epilogue on identical inputs
RTOL_GRAD = 1e-3      # dW, db and everything Adam computes from them
ACT_COUNT_TOL = 8     # activity: mask flips per (member, feature)
RTOL_PATH_LOSS = 1e-4  # per-step losses of a kernel path vs autodiff
# A kernel path's encoder vs autodiff's after a few steps from a fresh
# init, as ‖ΔE‖/‖E‖: Adam's first steps move each element by about
# ±lr·sign(g), so an element whose gradient lies within rounding of 0 can
# step the other way (2·lr) on one side — a handful among 33.5M elements.
REL_FRO_PATH = 1e-4
# The main path's logged single-batch mse vs the autodiff reference's at
# the same step, |Δ|/mse per member: 100–200 Adam steps grow the paths'
# rounding differences (phase 5's 1e-5-level gaps after 3 steps), but a
# kernel fault moves the mse far more than this.
RTOL_REFERENCE_MSE = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
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


def compare(label: str, got, ref, rtol: float, atol: float = 0.0) -> dict:
    """|got − ref|max against atol + rtol·max|ref|; raises on a miss or a
    non-finite value. Returns the errors."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{label}: non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    bound = atol + rtol * scale
    if not err <= bound:
        raise AssertionError(f"{label}: max abs err {err:.3e} > {bound:.3e} "
                             f"(rtol {rtol}, atol {atol}, max|ref| "
                             f"{scale:.3e})")
    return {"max_abs_err": err, "max_rel_err": err / scale if scale else 0.0,
            "tol": bound}


# --- phase 2: kernels --------------------------------------------------------

def make_inputs(gen: torch.Generator, n_members: int, batch: int,
                n_feats: int, d: int, x=None) -> dict:
    """Kernel inputs on the card: glorot dictionaries, small biases, an L1
    grid, and a mid-training Adam state (so an update is not just the
    sign of the gradient, which a rounding-level gradient could flip)."""
    dev = torch.device(DEV)
    lim = math.sqrt(6.0 / (n_feats + d))
    e = (torch.rand((n_members, n_feats, d), generator=gen) * 2 - 1) * lim
    if x is None:
        x = torch.randn((batch, d), generator=gen) / math.sqrt(d)
    g_scale = 1e-4
    mu = torch.randn((n_members, n_feats, d), generator=gen) * g_scale
    nu = (torch.rand((n_members, n_feats, d), generator=gen) + 0.5) \
        * g_scale ** 2
    count = torch.full((n_members,), 100, dtype=torch.int32)
    b1, b2 = 0.9, 0.999
    c = count.float() + 1
    return {
        "e": e.to(dev), "x": x.to(dev).float().contiguous(),
        "bias": (torch.rand((n_members, n_feats), generator=gen) - 0.5)
        .mul(0.02).to(dev),
        "alphas": torch.logspace(-4, -2, n_members).to(dev),
        "dw": (torch.randn((n_members, n_feats, d), generator=gen) * g_scale)
        .to(dev),
        "mu": mu.to(dev), "nu": nu.to(dev),
        "mu_b": (torch.randn((n_members, n_feats), generator=gen) * g_scale)
        .to(dev),
        "nu_b": ((torch.rand((n_members, n_feats), generator=gen) + 0.5)
                 * g_scale ** 2).to(dev),
        "lrs": torch.full((n_members,), 1e-3).to(dev),
        "bc1": (1.0 - torch.tensor(b1) ** c).to(dev),
        "bc2": (1.0 - torch.tensor(b2) ** c).to(dev),
    }


def check_kernels(inp: dict, tag: str) -> dict:
    """Every kernel and contract against its plain version on ``inp``."""
    from sparse_coding_tpu_torch.ops import fused_sae as fs
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, x, bias, al = inp["e"], inp["x"], inp["bias"], inp["alphas"]
    batch = x.shape[0]
    out = {}

    def cmp(name, pairs):
        errs = {}
        for field, (got, ref, rtol, atol) in pairs.items():
            errs[field] = compare(f"{tag}:{name}.{field}", got, ref, rtol,
                                  atol)
        out[name] = errs
        worst = max(v["max_rel_err"] for v in errs.values())
        detail = ", ".join("%s %.1e" % (k, v["max_abs_err"])
                           for k, v in errs.items())
        log(f"  {tag} {name}: ok, worst rel err {worst:.2e} ({detail})")

    r = ft.sae_tied_fwd(e, bias, x)
    r_ref = ft.sae_tied_fwd_plain(e, bias, x)
    cmp("sae_tied_fwd", {"r": (r, r_ref, RTOL_EXACT, 0.0)})

    # the bwd kernel and its plain version get the SAME residual
    got = ft.sae_tied_bwd(e, bias, al, x, r_ref)
    ref = ft.sae_tied_bwd_plain(e, bias, al, x, r_ref)
    cmp("sae_tied_bwd", {
        "dw": (got[0], ref[0], RTOL_GRAD, 0.0),
        "db": (got[1], ref[1], RTOL_GRAD, 0.0),
        "activity": (got[2], ref[2], 0.0, ACT_COUNT_TOL),
        "loss4": (got[3][:, :2], ref[3][:, :2], RTOL_EXACT, 0.0),
        "l0": (got[3][:, 2], ref[3][:, 2], RTOL_GRAD, 0.0),
        "grad_sq": (got[3][:, 3], ref[3][:, 3], RTOL_GRAD, 0.0)})

    args = (e, inp["dw"], inp["mu"], inp["nu"], inp["lrs"], inp["bc1"],
            inp["bc2"])
    bias_grp = dict(bias=bias, db=inp["dw"][:, :, 0].contiguous(),
                    mu_b=inp["mu_b"], nu_b=inp["nu_b"])
    got = fs.sae_tied_adam_vjp(*args, **bias_grp)
    ref = fs.sae_tied_adam_vjp_plain(*args, **bias_grp)
    cmp("sae_tied_adam_vjp", {
        "e": (got[0], ref[0], RTOL_EXACT, 0.0),
        "mu": (got[1], ref[1], RTOL_EXACT, 0.0),
        "nu": (got[2], ref[2], RTOL_EXACT, 0.0),
        "un_sq": (got[3], ref[3], RTOL_EXACT, 0.0),
        "bias": (got[4][0], ref[4][0], RTOL_EXACT, 0.0),
        "mu_b": (got[4][1], ref[4][1], RTOL_EXACT, 0.0),
        "nu_b": (got[4][2], ref[4][2], RTOL_EXACT, 0.0)})

    def loss_pairs(got_l, ref_l):
        return {f"loss_{k}": (got_l[k], ref_l[k],
                              RTOL_GRAD if k == "l0" else RTOL_EXACT, 0.0)
                for k in ("mse", "l1", "l0")}

    # K1: fused_tied_sae_grads
    got = fs.fused_tied_sae_grads(e, bias, al, x)
    ref = fs.fused_tied_sae_grads_plain(e, bias, al, x)
    cmp("K1 fused_tied_sae_grads", {
        **loss_pairs(got[0], ref[0]),
        "dw": (got[1], ref[1], RTOL_GRAD, 0.0),
        "db": (got[2], ref[2], RTOL_GRAD, 0.0),
        "activity": (got[3], ref[3], 0.0, ACT_COUNT_TOL)})

    # K2: fused_tied_sae_train_step
    k2 = (e, bias, inp["mu"], inp["nu"], inp["mu_b"], inp["nu_b"], al,
          inp["lrs"], inp["bc1"], inp["bc2"], x)
    got = fs.fused_tied_sae_train_step(*k2)
    ref = fs.fused_tied_sae_train_step_plain(*k2)
    names = ("e", "bias", "mu_e", "nu_e", "mu_b", "nu_b")
    cmp("K2 fused_tied_sae_train_step", {
        **loss_pairs(got[0], ref[0]),
        **{n: (g, rf, RTOL_GRAD, 0.0)
           for n, g, rf in zip(names, got[1:7], ref[1:7])},
        "activity": (got[7], ref[7], 0.0, ACT_COUNT_TOL)})

    # K3: tiled_tied_sae_grads
    bt = 256 if batch % 256 == 0 else 32
    ftile = 256 if e.shape[1] % 256 == 0 else 32
    got = ft.tiled_tied_sae_grads(e, bias, al, x, bt, ftile)
    ref = ft.tiled_tied_sae_grads_plain(e, bias, al, x, bt, ftile)
    cmp("K3 tiled_tied_sae_grads", {
        **loss_pairs(got[0], ref[0]),
        "dw": (got[1], ref[1], RTOL_GRAD, 0.0),
        "db": (got[2], ref[2], RTOL_GRAD, 0.0),
        "activity": (got[3], ref[3], 0.0, ACT_COUNT_TOL),
        "grad_sq": (got[4], ref[4], RTOL_GRAD, 0.0)})

    # K4: fused_tied_adam_vjp_update
    got = fs.fused_tied_adam_vjp_update(*args, ftile=32)
    ref = fs.fused_tied_adam_vjp_update_plain(*args, ftile=32)
    cmp("K4 fused_tied_adam_vjp_update", {
        n: (g, rf, RTOL_EXACT, 0.0)
        for n, g, rf in zip(("e", "mu", "nu", "un_sq"), got, ref)})
    sync()
    return out


def bounds(inp: dict, nnz: int) -> dict:
    """Least time the card could take for each kernel's work on ``inp``:
    max(bytes / HBM rate, fp32 ops / fp32 peak). Each input is read once
    and each output written once; the codes are sparse, so the products
    that involve them count only this data's ``nnz`` active (member, row,
    feature) triples."""
    n_m, n, d = inp["e"].shape
    b = inp["x"].shape[0]
    f4 = 4
    enc = 2.0 * n_m * b * n * d  # pre = x·Wᵀ, dense
    act = 2.0 * nnz * d          # one product over the active codes
    work = {
        "sae_tied_fwd": (
            enc + act + n_m * n * d * 3,
            f4 * (b * d + n_m * n * d + n_m * n + n_m * b * d)),
        "sae_tied_bwd": (
            enc + 3 * act + n_m * n * d * 3,
            f4 * (b * d + 2 * n_m * b * d + 2 * n_m * n * d + 3 * n_m * n
                  + n_m)),
        "sae_tied_adam_vjp": (
            24.0 * n_m * n * d,
            f4 * (7 * n_m * n * d + 3 * n_m)),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        out[name] = {"bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": ops, "bytes": nbytes}
    return out


def time_kernels(inp: dict) -> dict:
    from sparse_coding_tpu_torch.ops import fused_sae as fs
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, x, bias, al = inp["e"], inp["x"], inp["bias"], inp["alphas"]
    r = ft.sae_tied_fwd_plain(e, bias, x)
    adam = (e, inp["dw"], inp["mu"], inp["nu"], inp["lrs"], inp["bc1"],
            inp["bc2"])
    pairs = {
        "sae_tied_fwd": (lambda: ft.sae_tied_fwd(e, bias, x),
                         lambda: ft.sae_tied_fwd_plain(e, bias, x), 5),
        "sae_tied_bwd": (lambda: ft.sae_tied_bwd(e, bias, al, x, r),
                         lambda: ft.sae_tied_bwd_plain(e, bias, al, x, r), 5),
        "sae_tied_adam_vjp": (lambda: fs.sae_tied_adam_vjp(*adam),
                              lambda: fs.sae_tied_adam_vjp_plain(*adam), 20),
    }
    out = {}
    for name, (kern, plain, iters) in pairs.items():
        # in turns: plain, kernel, kernel, plain
        p1 = time_ms(plain, iters)
        k1 = time_ms(kern, iters)
        k2 = time_ms(kern, iters)
        p2 = time_ms(plain, iters)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                     "library_ms": None}
        log(f"  {name}: kernel {min(k1, k2):.3f} ms, plain "
            f"{min(p1, p2):.3f} ms")
    return out


# --- phase 3: main path ------------------------------------------------------

def write_store(folder: Path, n_rows: int, seed: int) -> None:
    """Synthetic activations with the repo's generator, written by the
    port's ChunkWriter (bfloat16 on disk, as harvests write them)."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkWriter
    from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator

    g = torch.Generator(DEV).manual_seed(seed)
    gen = RandomDatasetGenerator.create(g, D, 2 * N_FEATS, 32, 0.999)
    w = ChunkWriter(folder, D, chunk_size_gb=ROWS_PER_CHUNK * D * 2 / 2**30,
                    dtype="bfloat16")
    if w.rows_per_chunk != ROWS_PER_CHUNK:
        raise AssertionError(f"rows per chunk {w.rows_per_chunk}")
    for lo in range(0, n_rows, 8192):
        w.add(gen.batch(g, min(8192, n_rows - lo)))
    w.finalize()


def read_metrics(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def main_path(store: Path, out_dir: Path, l1_values, n_steps: int) -> dict:
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    dicts = basic_l1_sweep(store, out_dir, l1_values, dict_ratio=RATIO,
                           batch_size=BATCH, lr=LR, n_epochs=1, seed=SEED,
                           device=DEV)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"  basic_l1_sweep: {wall:.2f} s wall, launches {launches}")
    for name in _build.KERNELS:
        if launches[name] != n_steps:
            raise AssertionError(f"{name}: {launches[name]} launches on "
                                 f"the main path, expected one per step "
                                 f"({n_steps})")

    recs = read_metrics(out_dir / "metrics.jsonl")
    if [r["step"] for r in recs] != list(range(100, n_steps + 1, 100)):
        raise AssertionError(f"metrics.jsonl: steps "
                             f"{[r['step'] for r in recs]}")
    first, last = recs[0], recs[-1]
    for rec in recs:
        bad = [k for k, v in rec.items() if isinstance(v, float)
               and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics at step "
                                 f"{rec['step']}: {bad}")
    mse = {r["step"]: [r[f"l1={l1:.2e}/mse"] for l1 in l1_values]
           for r in recs}
    acts_per_s = ((last["step"] - first["step"]) * BATCH
                  / (last["ts"] - first["ts"]))
    log(f"  mse at steps {list(mse)}: member 0 "
        f"{[f'{m[0]:.4e}' for m in mse.values()]}, member "
        f"{len(l1_values) - 1} {[f'{m[-1]:.4e}' for m in mse.values()]}; "
        f"{acts_per_s:.0f} acts/s (steps {first['step']}-{last['step']}, "
        "data loading included)")

    # eval.json: finite, and the L1 grid orders the members — the weakest
    # penalty reconstructs best and keeps the most features active
    evals = json.loads((out_dir / "epoch_0" / "eval.json").read_text())
    if len(evals) != len(l1_values) or not all(
            math.isfinite(s["fvu"]) and math.isfinite(s["l0"])
            and s["fvu"] >= 0.0 for s in evals):
        raise AssertionError(f"eval.json: {evals}")
    if not (evals[0]["fvu"] < min(1.0, evals[-1]["fvu"])
            and evals[0]["l0"] > evals[-1]["l0"]):
        raise AssertionError(f"eval.json: the L1 grid does not order fvu "
                             f"and l0: {evals[0]} vs {evals[-1]}")
    loaded = load_learned_dicts(out_dir / "epoch_0" / "learned_dicts.pkl")
    if len(loaded) != len(l1_values) or len(dicts) != len(l1_values):
        raise AssertionError("learned_dicts.pkl: wrong member count")
    for ld, _ in loaded:
        w = ld.get_learned_dict()
        if tuple(w.shape) != (N_FEATS, D) or not torch.isfinite(w).all():
            raise AssertionError(f"learned dict {tuple(w.shape)}")
    log(f"  eval.json: fvu {evals[0]['fvu']:.4f} (l1 {l1_values[0]:.1e}) .. "
        f"{evals[-1]['fvu']:.4f} (l1 {l1_values[-1]:.1e}); l0 "
        f"{evals[0]['l0']:.1f} .. {evals[-1]['l0']:.1f}")
    return {"wall_s": wall, "launches": launches, "acts_per_s": acts_per_s,
            "steps": n_steps, "mse": mse, "eval": evals}


# --- phase 4: the main path's epoch on autodiff ------------------------------

def reference_epoch(store: Path, l1_values, main: dict) -> dict:
    """basic_l1_sweep's epoch again — the same member inits, the same
    batch order — on the autodiff path, which launches no kernel. Each
    member's single-batch mse at the main path's logged steps must match
    the main path's, and the steps where mse rose are listed for both."""
    from sparse_coding_tpu_torch.data.chunk_store import device_prefetch
    from sparse_coding_tpu_torch.data.shard_store import open_store
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE
    from sparse_coding_tpu_torch.ops import _build

    gen = torch.Generator().manual_seed(SEED)
    members = [FunctionalTiedSAE.init(gen, D, N_FEATS, l1_alpha=float(l1))
               for l1 in l1_values]
    ens = Ensemble(members, FunctionalTiedSAE, lr=LR, use_fused=False,
                   device=DEV)
    batches = open_store(store).epoch(BATCH, np.random.default_rng(SEED))
    _build.reset_launches()
    mse, step = {}, 0
    for step, batch in enumerate(device_prefetch(batches, DEV), 1):
        aux = ens.step_batch(batch)
        if step in main["mse"]:
            mse[step] = aux.losses["l_reconstruction"].cpu().tolist()
    if step != main["steps"] or any(_build.LAUNCHES.values()):
        raise AssertionError(f"reference: {step} steps, launches "
                             f"{_build.LAUNCHES}")
    rel = [abs(k - a) / a for s in mse
           for k, a in zip(main["mse"][s], mse[s])]
    steps = sorted(mse)
    rose = {name: [i for i in range(len(l1_values))
                   if m[steps[-1]][i] > m[steps[0]][i]]
            for name, m in (("kernel", main["mse"]), ("autodiff", mse))}
    log(f"  autodiff over the same {step} steps: mse rel diff to the main "
        f"path max {max(rel):.2e}; members whose mse rose from step "
        f"{steps[0]} to {steps[-1]}: kernel path {rose['kernel']}, "
        f"autodiff {rose['autodiff']}")
    if not max(rel) <= RTOL_REFERENCE_MSE:
        raise AssertionError(f"main path's mse is {max(rel):.2e} from the "
                             f"autodiff reference's (> "
                             f"{RTOL_REFERENCE_MSE})")
    return {"mse": mse, "mse_max_rel_diff": max(rel), "rose": rose}


# --- phase 5: every kernel path vs autodiff -----------------------------------

EXPECTED_LAUNCHES = {
    "two_stage": {"sae_tied_fwd": 1, "sae_tied_bwd": 1,
                  "sae_tied_adam_vjp": 0},
    "train_step": {"sae_tied_fwd": 1, "sae_tied_bwd": 1,
                   "sae_tied_adam_vjp": 1},
    "two_stage_tiled": {"sae_tied_fwd": 1, "sae_tied_bwd": 1,
                        "sae_tied_adam_vjp": 0},
    "train_step_tiled": {"sae_tied_fwd": 1, "sae_tied_bwd": 1,
                         "sae_tied_adam_vjp": 1},
}


def other_paths(batches: list, l1_values) -> dict:
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE
    from sparse_coding_tpu_torch.ops import _build

    def members():
        g = torch.Generator().manual_seed(1)
        return [FunctionalTiedSAE.init(g, D, N_FEATS, l1_alpha=float(l1))
                for l1 in l1_values]

    ref = Ensemble(members(), FunctionalTiedSAE, lr=LR, use_fused=False,
                   device=DEV)
    ref_losses = [ref.step_batch(b).losses["loss"] for b in batches]
    out = {}
    for path, expected in EXPECTED_LAUNCHES.items():
        ens = Ensemble(members(), FunctionalTiedSAE, lr=LR,
                       fused_path=path, device=DEV)
        _build.reset_launches()
        losses = [ens.step_batch(b).losses["loss"] for b in batches]
        sync()
        launches = dict(_build.LAUNCHES)
        want = {k: v * len(batches) for k, v in expected.items()}
        if launches != want or ens.fused_path != path:
            raise AssertionError(f"{path}: launches {launches}, expected "
                                 f"{want} (resolved {ens.fused_path})")
        errs = [compare(f"{path}: step {i} loss", got, want_l,
                        RTOL_PATH_LOSS)
                for i, (got, want_l) in enumerate(zip(losses, ref_losses))]
        p, pr = ens.state.params["encoder"], ref.state.params["encoder"]
        rel_fro = float(torch.linalg.vector_norm(p - pr)
                        / torch.linalg.vector_norm(pr))
        if not rel_fro <= REL_FRO_PATH:
            raise AssertionError(f"{path}: encoder drifted from autodiff, "
                                 f"relative Frobenius {rel_fro:.2e}")
        worst = max(e["max_rel_err"] for e in errs)
        out[path] = {"launches": launches, "loss_max_rel_err": worst,
                     "encoder_rel_fro": rel_fro}
        log(f"  {path}: launches {launches}; vs autodiff: loss rel err "
            f"{worst:.2e}, encoder relative Frobenius {rel_fro:.2e}")
    return out


# --- main --------------------------------------------------------------------

MASK_COUNTS = ("activity", "l0")

KERNEL_META = {
    "sae_tied_fwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_tied_fwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae_tiled.py:344",
        "contracts": ["K1", "K2", "K3"]},
    "sae_tied_bwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_tied_bwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae_tiled.py:387",
        "contracts": ["K1", "K2", "K3"]},
    "sae_tied_adam_vjp": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_tied_adam_vjp.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae.py:1053",
        "contracts": ["K2", "K4"]},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write every measurement here as JSON")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from sparse_coding_tpu_torch.ops import _build

    report: dict = {}
    t_start = time.perf_counter()
    log("phase 1: card and build")
    card = card_line()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    out = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"  built {list(_build.KERNELS)} in {report['build_s']:.1f} s")
    for name in _build.KERNELS:
        for line in (out / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels vs plain versions")
    g = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=Path.cwd()) as tmp:
        store = Path(tmp) / "store"
        n_steps = N_CHUNKS * ROWS_PER_CHUNK // BATCH
        write_store(store, N_CHUNKS * ROWS_PER_CHUNK, seed=SEED)
        from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

        x_main = torch.as_tensor(ChunkStore(store).load_chunk(0)[:BATCH])
        checks = {}
        for tag, shape in (("small", (3, 96, 96, 40)),
                           ("wide", (2, 64, 64, 600))):
            checks[tag] = check_kernels(make_inputs(g, *shape), tag)
        main_inp = make_inputs(g, N_MEMBERS, BATCH, N_FEATS, D, x=x_main)
        checks["main"] = check_kernels(main_inp, "main")
        report["checks"] = checks
        from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

        nnz = int(ft.sae_tied_bwd_plain(
            main_inp["e"], main_inp["bias"], main_inp["alphas"],
            main_inp["x"], ft.sae_tied_fwd_plain(
                main_inp["e"], main_inp["bias"], main_inp["x"]))[2].sum())
        timing = time_kernels(main_inp)
        bnd = bounds(main_inp, nnz)
        report["active_codes"] = nnz
        del main_inp

        log(f"phase 3: main path — basic_l1_sweep, {N_MEMBERS} members, "
            f"d={D}, n={N_FEATS}, batch {BATCH}, {n_steps} steps, "
            "train_step_tiled")
        l1_values = [float(v) for v in np.logspace(-4, -2, N_MEMBERS)]
        report["main_path"] = main_path(store, Path(tmp) / "out", l1_values,
                                        n_steps)

        log("phase 4: the main path's epoch on autodiff")
        report["reference"] = reference_epoch(store, l1_values,
                                              report["main_path"])

        log("phase 5: every kernel path vs autodiff")
        cs = ChunkStore(store).load_chunk(1)
        batches = [torch.as_tensor(cs[i * BATCH:(i + 1) * BATCH]).to(DEV)
                   for i in range(3)]
        report["other_paths"] = other_paths(batches, l1_values)

    kernels = []
    for name in _build.KERNELS:
        # the float outputs' error; the outputs that count ReLU masks
        # (activity per feature, l0 per row) apart — there a flipped mask
        # moves a count by 1, not a value by rounding
        checked = checks["main"][name]
        errs = {k: v for k, v in checked.items() if k not in MASK_COUNTS}
        kernels.append({
            "name": name, "route": "cuda", **{
                k: KERNEL_META[name][k] for k in ("source", "replaces")},
            "launches": report["main_path"]["launches"][name],
            "max_abs_err": max(v["max_abs_err"] for v in errs.values()),
            "max_rel_err": max(v["max_rel_err"] for v in errs.values()),
            "mask_count_abs_err": {k: checked[k]["max_abs_err"]
                                   for k in MASK_COUNTS if k in checked},
            "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
            "bound_ms": bnd[name]["bound_ms"],
            "bound_by": bnd[name]["bound_by"],
            "library_ms": timing[name]["library_ms"],
            "contracts": KERNEL_META[name]["contracts"]})
    report["kernels"] = kernels
    report["timing"] = timing
    report["bounds"] = bnd
    report["card"] = card
    report["total_s"] = time.perf_counter() - t_start
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=2))
    log(f"done in {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
