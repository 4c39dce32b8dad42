"""Small render-to-image helpers (the ``plot_hist`` of the JAX package's
``plotting/helpers.py``). matplotlib is imported when a figure is drawn,
never at import: hosts without it import this module freely."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch


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


def plot_hist(scores, x_label: str = "", y_label: str = "", bins: int = 50,
              save_path: Optional[str | Path] = None, **kwargs) -> np.ndarray:
    """Histogram of ``scores`` (array or tensor), saved to ``save_path``
    when given; returns the rendered RGB image."""
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    fig, ax = _new_fig(figsize=(5, 4))
    ax.hist(np.asarray(scores).ravel(), bins=bins, **kwargs)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return _fig_to_array(fig)
