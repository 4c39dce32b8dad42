"""FVU-vs-sparsity frontier plots and score generation (the JAX
package's ``plotting/frontiers.py``): a score generator that evaluates
every saved dict on an eval slab on the card, and a frontier renderer.
matplotlib is imported when a figure is drawn, never at import."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.metrics.core import (
    fraction_variance_unexplained,
    mean_l0,
)
from sparse_coding_tpu_torch.metrics.geometry import _scalar_hypers
from sparse_coding_tpu_torch.plotting.helpers import _new_fig
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts


@torch.no_grad()
def generate_scores(dict_files: Sequence[str | Path], eval_batch,
                    out_path: Optional[str | Path] = None,
                    device=None) -> list[dict]:
    """FVU + L0 for every (dict, hyperparams) across artifact files, on
    ``device`` (default: the card); the scores stay there and are read
    once."""
    dev = resolve_device(device)
    batch = torch.as_tensor(eval_batch, dtype=torch.float32).to(dev)
    entries, metrics = [], []
    for path in dict_files:
        for ld, hyper in load_learned_dicts(path, device=dev):
            entries.append({"file": str(path), **_scalar_hypers(hyper)})
            metrics.append(torch.stack([
                fraction_variance_unexplained(ld, batch), mean_l0(ld, batch)]))
    values = torch.stack(metrics).tolist() if metrics else []
    scores = [{**e, "fvu": fvu, "l0": l0}
              for e, (fvu, l0) in zip(entries, values)]
    if out_path is not None:
        from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(out_path, json.dumps(scores, indent=2))
    return scores


def plot_fvu_sparsity(scores: Sequence[dict], group_by: str = "dict_size",
                      save_path: Optional[str | Path] = None,
                      show: bool = False, title: str = "FVU vs sparsity"):
    """Frontier scatter: x = L0, y = FVU, one series per group. Returns
    the figure; ``show`` is accepted for the JAX signature, and the Agg
    canvas has no window to show it on."""
    fig, ax = _new_fig(figsize=(7, 5))
    groups: dict = {}
    for s in scores:
        groups.setdefault(s.get(group_by, "all"), []).append(s)
    for key in sorted(groups, key=str):
        pts = sorted(groups[key], key=lambda s: s["l0"])
        ax.plot([p["l0"] for p in pts], [p["fvu"] for p in pts],
                marker="o", ms=4, label=f"{group_by}={key}")
    ax.set_xlabel("mean L0 (active features/sample)")
    ax.set_ylabel("fraction of variance unexplained")
    ax.set_title(title)
    ax.set_xscale("log")
    ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150)
    return fig
