"""Kernel-path choice for the card (subset of the JAX package's
``ops/roofline.py``).

The four path labels and the paths each bucket family has are the JAX
package's, so port results stay comparable with the reference. The JAX
package ranks paths with a TPU VMEM admission model; that model is not
ported (rebuilding it for Hopper's shared memory and registers is later
work). On the card every path rides the same fixed-tile kernels, so the
chooser is simple: the tied and untied families default to
``train_step_tiled`` (the fewest passes over the [N, n, d] state), the
masked family to ``two_stage_tiled`` (its ``coef_mask`` rides the
two-stage kernels only), ``fused_path`` forces any path the family has,
and a shape the kernels' blocking does not take resolves to no path (the
Ensemble raises on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from sparse_coding_tpu_torch.ops import _build

KERNEL_PATHS = ("train_step", "train_step_tiled", "two_stage",
                "two_stage_tiled")
# the paths each bucket family has, and the one it runs unless forced
FAMILY_PATHS = {
    "tied": KERNEL_PATHS,
    "untied": KERNEL_PATHS,
    "masked_tied": ("two_stage", "two_stage_tiled"),
}
DEFAULT_PATHS = {"tied": "train_step_tiled", "untied": "train_step_tiled",
                 "masked_tied": "two_stage_tiled"}


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One resolved choice: ``path`` is a KERNEL_PATHS label, or None for
    autodiff; ``reason`` says why."""

    path: Optional[str]
    reason: str = ""


# the H100 SXM's HBM3 rate and fp32 peak outside the tensor cores (NVIDIA
# data sheet), as obs/perf.py and chip_smoke.py use them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


@dataclasses.dataclass(frozen=True)
class FlushPlan:
    """Roofline of one serving bucket replay: the bytes it must move, the
    fp32 flops it does, and the least time the card could take for
    them."""

    hbm_bytes: float
    flops: float
    est_s: float


def serve_flush_plan(op: str, bucket: int, n_feats: int, d: int, *,
                     n_stack: int = 1, itemsize: int = 4) -> FlushPlan:
    """The JAX package's ``serve_flush_plan`` on the card's peaks: the
    dict params stream once per stacked member, the padded input and the
    result once; one [bucket, d] x [d, n] product per op (two for
    predict) per member. The serving engine's probe (obs/perf.py) reads
    it."""
    n = max(1, int(n_stack))
    p = float(n_feats) * d * 4  # dict params (fp32 resident)
    x = float(bucket) * (d if op != "decode" else n_feats) * itemsize
    out_w = {"encode": n_feats, "decode": d, "predict": d}.get(op, n_feats)
    c = float(bucket) * out_w * itemsize
    mad = 2.0 * bucket * n_feats * d
    flops = {"predict": 2 * mad}.get(op, mad) * n
    hbm = n * p + x + n * c
    return FlushPlan(hbm_bytes=hbm, flops=flops,
                     est_s=max(hbm / PEAK_BYTES_PER_S,
                               flops / PEAK_FP32_FLOPS))


def model_flops_per_activation(n_members: int, n_feats: int, d: int) -> float:
    """~12·n·d flops per activation per member: encode + decode matmuls
    forward (2·n·d each), ~2x for backward — the flops the MODEL requires,
    independent of the kernel path (the tiled paths execute more through
    recompute; required flops are the MFU convention)."""
    return 12.0 * float(n_feats) * float(d) * float(n_members)


def check_path(family: str, path: str) -> None:
    """Raise ValueError unless ``family`` has kernel path ``path``."""
    if path not in KERNEL_PATHS:
        raise ValueError(f"unknown kernel path {path!r}")
    if path not in FAMILY_PATHS[family]:
        raise ValueError(
            f"fused_path={path!r}: the {family} family has no such path "
            f"(it has {FAMILY_PATHS[family]}; the masked family's coef_mask "
            "rides the two-stage kernels only)")


def choose_plan(*, batch: int, n_feats: int, d: int, family: Optional[str],
                forced_path: Optional[str] = None) -> KernelPlan:
    """The path the next step runs. ``family`` is "tied", "untied" or
    "masked_tied" for an eligible bucket; anything else resolves to
    autodiff."""
    if family not in FAMILY_PATHS:
        return KernelPlan(None, reason="family_ineligible")
    path = forced_path or DEFAULT_PATHS[family]
    check_path(family, path)
    if (batch % _build.BATCH_TILE or n_feats % _build.FEAT_TILE
            or d > _build.MAX_D):
        return KernelPlan(None, reason=(f"forced_unfit:{forced_path}"
                                        if forced_path else
                                        "no_admissible_tile"))
    return KernelPlan(path, reason="forced" if forced_path else "default")
