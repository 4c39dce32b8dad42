"""Kernel-path choice for the card (subset of the JAX package's
``ops/roofline.py``).

The four path labels are the JAX package's, so port results stay
comparable with the reference. The JAX package ranks paths with a TPU
VMEM admission model; that model is not ported (rebuilding it for Hopper's
shared memory and registers is later work). On the card every path rides
the same fixed-tile kernels, so the chooser is simple: the default is
``train_step_tiled`` (the fewest passes over the [N, n, d] state),
``fused_path`` forces any of the four, and a shape the kernels' blocking
does not take resolves to no path (the Ensemble raises on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from sparse_coding_tpu_torch.ops import _build

KERNEL_PATHS = ("train_step", "train_step_tiled", "two_stage",
                "two_stage_tiled")
DEFAULT_PATH = "train_step_tiled"


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One resolved choice: ``path`` is a KERNEL_PATHS label, or None for
    autodiff; ``reason`` says why."""

    path: Optional[str]
    reason: str = ""


def model_flops_per_activation(n_members: int, n_feats: int, d: int) -> float:
    """~12·n·d flops per activation per member: encode + decode matmuls
    forward (2·n·d each), ~2x for backward — the flops the MODEL requires,
    independent of the kernel path (the tiled paths execute more through
    recompute; required flops are the MFU convention)."""
    return 12.0 * float(n_feats) * float(d) * float(n_members)


def choose_plan(*, batch: int, n_feats: int, d: int, family: Optional[str],
                forced_path: Optional[str] = None) -> KernelPlan:
    """The path the next step runs. ``family`` is "tied" for an eligible
    bucket, anything else resolves to autodiff."""
    if family != "tied":
        return KernelPlan(None, reason="family_ineligible")
    path = forced_path or DEFAULT_PATH
    if path not in KERNEL_PATHS:
        raise ValueError(f"unknown kernel path {path!r}")
    if (batch % _build.BATCH_TILE or n_feats % _build.FEAT_TILE
            or d > _build.MAX_D):
        return KernelPlan(None, reason=(f"forced_unfit:{forced_path}"
                                        if forced_path else
                                        "no_admissible_tile"))
    return KernelPlan(path, reason="forced" if forced_path else "default")
