"""Sweep-grid, activity and dead-feature plots (the JAX package's
``plotting/sweeps.py``). The data functions (``sweep_grid``,
``n_active_features`` on the card) need no matplotlib; the plots import
it when they draw, which they do only when given a ``save_path``."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.metrics.core import mean_nonzero_activations
from sparse_coding_tpu_torch.metrics.geometry import _scalar_hypers
from sparse_coding_tpu_torch.plotting.helpers import _new_fig, save_figure
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts


def sweep_grid(scores: Sequence[dict], x_key: str = "l1_alpha",
               y_key: str = "dict_size", value_key: str = "fvu") -> tuple:
    """Pivot sweep scores into a (x_vals, y_vals, grid) heatmap input."""
    xs = sorted({s[x_key] for s in scores})
    ys = sorted({s[y_key] for s in scores})
    grid = np.full((len(ys), len(xs)), np.nan)
    for s in scores:
        grid[ys.index(s[y_key]), xs.index(s[x_key])] = s[value_key]
    return xs, ys, grid


def plot_sweep_grid(scores, x_key="l1_alpha", y_key="dict_size",
                    value_key="fvu", save_path: Optional[str | Path] = None):
    """The pivoted grid, drawn as a heatmap to ``save_path`` when given."""
    xs, ys, grid = sweep_grid(scores, x_key, y_key, value_key)
    if save_path is not None:
        fig, ax = _new_fig(figsize=(7, 5))
        im = ax.imshow(grid, aspect="auto", origin="lower", cmap="viridis")
        ax.set_xticks(range(len(xs)), [f"{x:.1e}" if isinstance(x, float)
                                       else x for x in xs],
                      rotation=45, fontsize=7)
        ax.set_yticks(range(len(ys)), ys, fontsize=7)
        ax.set_xlabel(x_key)
        ax.set_ylabel(y_key)
        fig.colorbar(im, label=value_key)
        fig.tight_layout()
        save_figure(fig, save_path)
    return xs, ys, grid


@torch.no_grad()
def n_active_features(dict_files: Sequence[str | Path], eval_batch,
                      threshold: float = 0.0, device=None) -> list[dict]:
    """Active-feature counts per dict (firing frequency above
    ``threshold`` on ``eval_batch``), on ``device`` (default: the card);
    the counts are read once."""
    dev = resolve_device(device)
    batch = torch.as_tensor(eval_batch, dtype=torch.float32).to(dev)
    entries, counts = [], []
    for path in dict_files:
        for ld, hyper in load_learned_dicts(path, device=dev):
            entries.append((_scalar_hypers(hyper), int(ld.n_feats)))
            counts.append(torch.sum(
                mean_nonzero_activations(ld, batch) > threshold))
    n_active = torch.stack(counts).tolist() if counts else []
    return [{**hyper, "n_active": int(n), "n_feats": n_feats}
            for (hyper, n_feats), n in zip(entries, n_active)]


def plot_n_active(records: Sequence[dict], x_key: str = "l1_alpha",
                  save_path: Optional[str | Path] = None) -> None:
    """Active features against ``x_key``, the dict size beside them;
    drawn to ``save_path`` when given."""
    if save_path is None:
        return
    fig, ax = _new_fig(figsize=(7, 5))
    pts = sorted(records, key=lambda r: r[x_key])
    ax.plot([p[x_key] for p in pts], [p["n_active"] for p in pts], marker="o")
    ax.plot([p[x_key] for p in pts], [p["n_feats"] for p in pts], ls="--",
            color="gray", label="dict size")
    ax.set_xscale("log")
    ax.set_xlabel(x_key)
    ax.set_ylabel("active features")
    ax.legend()
    fig.tight_layout()
    save_figure(fig, save_path)


def plot_num_dead(records: Sequence[dict], x_key: str = "l1_alpha",
                  save_path: Optional[str | Path] = None) -> None:
    """Dead-feature counts against ``x_key``; drawn to ``save_path`` when
    given."""
    if save_path is None:
        return
    fig, ax = _new_fig(figsize=(7, 5))
    pts = sorted(records, key=lambda r: r[x_key])
    ax.plot([p[x_key] for p in pts],
            [p["n_feats"] - p["n_active"] for p in pts], marker="o",
            color="crimson")
    ax.set_xscale("log")
    ax.set_xlabel(x_key)
    ax.set_ylabel("dead features")
    fig.tight_layout()
    save_figure(fig, save_path)
