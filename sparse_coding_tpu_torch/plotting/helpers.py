"""Small render-to-image helpers (the JAX package's
``plotting/helpers.py``): histograms, scatters, annotated grids, the
capacity plots, KL and bottleneck curves, and the figure setup the
file-figure plotters share.

Every figure is drawn on its own Agg canvas (``_new_fig``), which renders
headless and leaves pyplot's process-wide backend alone. matplotlib is
imported when a figure is drawn, never at import: hosts without it import
these modules freely and run every function that draws nothing."""

from __future__ import annotations

import types
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _fig_to_array(fig) -> np.ndarray:
    """Rasterize a figure to an RGB array."""
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()


def _new_fig(**kwargs):
    """A Figure on its own Agg canvas: renders headless and leaves
    pyplot's process-wide backend alone."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(**kwargs)
    FigureCanvasAgg(fig)
    return fig, fig.subplots()


def _finish(fig, save_path, dpi: int = 120) -> np.ndarray:
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=dpi)
    return _fig_to_array(fig)


def plot_hist(scores, x_label: str = "", y_label: str = "", bins: int = 50,
              save_path: Optional[str | Path] = None, **kwargs) -> np.ndarray:
    """Histogram of ``scores`` (array or tensor), saved to ``save_path``
    when given; returns the rendered RGB image."""
    fig, ax = _new_fig(figsize=(5, 4))
    ax.hist(_host(scores).ravel(), bins=bins, **kwargs)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    return _finish(fig, save_path)


def plot_scatter(scores_x, scores_y, x_label: str = "", y_label: str = "",
                 save_path: Optional[str | Path] = None,
                 **kwargs) -> np.ndarray:
    """Scatter of two score vectors (arrays or tensors)."""
    fig, ax = _new_fig(figsize=(5, 4))
    ax.scatter(_host(scores_x).ravel(), _host(scores_y).ravel(), s=6,
               **kwargs)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    return _finish(fig, save_path)


def plot_grid(scores: np.ndarray, first_tick_labels, second_tick_labels,
              first_label: str, second_label: str,
              save_path: Optional[str | Path] = None, **kwargs) -> np.ndarray:
    """Annotated heatmap."""
    fig, ax = _new_fig(figsize=(6, 5))
    im = ax.imshow(_host(scores), origin="lower", aspect="auto", **kwargs)
    ax.set_xticks(range(len(first_tick_labels)), first_tick_labels,
                  rotation=45, fontsize=7)
    ax.set_yticks(range(len(second_tick_labels)), second_tick_labels,
                  fontsize=7)
    ax.set_xlabel(first_label)
    ax.set_ylabel(second_label)
    fig.colorbar(im)
    return _finish(fig, save_path)


def _hyper_label(hyper: dict) -> str:
    return ", ".join(f"{k}={v:.2g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in hyper.items() if isinstance(v, (int, float)))


def plot_capacities(dicts: List[Tuple[Any, Dict]],
                    save_path: Optional[str | Path] = None) -> np.ndarray:
    """Capacity distribution per dict, each sorted descending."""
    from sparse_coding_tpu_torch.metrics.core import capacity_per_feature

    fig, ax = _new_fig(figsize=(7, 5))
    for ld, hyper in dicts:
        caps = np.sort(_host(capacity_per_feature(ld)))[::-1]
        ax.plot(caps, label=_hyper_label(hyper))
    ax.set_xlabel("feature rank")
    ax.set_ylabel("capacity")
    ax.legend(fontsize=7)
    return _finish(fig, save_path)


def plot_capacity_scatter(dicts: List[Tuple[Any, Dict]], eval_batch,
                          save_path: Optional[str | Path] = None
                          ) -> np.ndarray:
    """Capacity against firing frequency per feature; ``eval_batch`` is
    moved to each dict's device."""
    from sparse_coding_tpu_torch.metrics.core import (
        capacity_per_feature,
        mean_nonzero_activations,
    )

    fig, ax = _new_fig(figsize=(6, 5))
    for ld, hyper in dicts:
        batch = torch.as_tensor(eval_batch, dtype=torch.float32).to(
            ld.get_learned_dict().device)
        caps = _host(capacity_per_feature(ld))
        freq = _host(mean_nonzero_activations(ld, batch))
        ax.scatter(freq, caps, s=4, alpha=0.5,
                   label=str(hyper.get("l1_alpha", "")))
    ax.set_xlabel("firing frequency")
    ax.set_ylabel("capacity")
    ax.set_xscale("symlog", linthresh=1e-4)
    ax.legend(fontsize=7)
    return _finish(fig, save_path)


def plot_kl_div(records: Sequence[dict], x_key: str = "l0",
                kl_key: str = "kl",
                save_path: Optional[str | Path] = None) -> np.ndarray:
    """KL divergence under patching against ``x_key``."""
    fig, ax = _new_fig(figsize=(6, 4))
    pts = sorted(records, key=lambda r: r[x_key])
    ax.plot([p[x_key] for p in pts], [p[kl_key] for p in pts], marker="o")
    ax.set_xlabel(x_key)
    ax.set_ylabel("KL divergence")
    return _finish(fig, save_path)


def bottleneck_plot(series: Dict[str, Sequence[Tuple[float, float]]],
                    x_label: str = "bottleneck size", y_label: str = "metric",
                    save_path: Optional[str | Path] = None) -> np.ndarray:
    """Metric against bottleneck size, one line per series."""
    fig, ax = _new_fig(figsize=(6, 4))
    for name, pts in sorted(series.items()):
        pts = sorted(pts)
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                label=name)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.set_xscale("log")
    ax.legend(fontsize=8)
    return _finish(fig, save_path)


def get_pyplot():
    """The JAX package's pyplot handle, as far as its plotters use it:
    ``subplots`` (:func:`_new_fig`, a Figure on its own Agg canvas, so no
    plot switches the process's backend) and ``close`` (nothing to
    release: the Figure is garbage collected)."""
    return types.SimpleNamespace(subplots=_new_fig, close=lambda fig: None)


def save_figure(fig, save_path) -> None:
    """mkdir-parents + savefig(dpi=150), shared by the file-figure
    plotters."""
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=150)
