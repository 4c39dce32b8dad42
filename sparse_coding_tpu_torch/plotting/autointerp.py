"""Auto-interpretation comparison plots (the JAX package's
``plotting/autointerp.py``): score violins with bootstrap CIs per
transform. Axis conventions: score range −0.2…0.6, per-location
mean-score caps 0.2 (residual) / 0.35 (MLP). The summaries need no
matplotlib; the figure is drawn only when a ``save_path`` is given."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from sparse_coding_tpu_torch.plotting.helpers import _new_fig, save_figure

SCORE_RANGE = (-0.2, 0.6)
MEAN_SCORE_CAP = {"residual": 0.2, "mlp": 0.35}


def plot_score_violins(scores_by_transform: dict[str, Sequence[float]],
                       save_path: Optional[str | Path] = None,
                       title: str = "auto-interpretation scores") -> dict:
    """Violin plot with bootstrap 95% CIs per transform; returns
    {transform: (mean, std)}."""
    names = sorted(scores_by_transform)
    data = [np.asarray(scores_by_transform[n], float) for n in names]
    if save_path is not None:
        fig, ax = _new_fig(figsize=(1.2 * len(names) + 3, 5))
        ax.violinplot(data, showmeans=True)
        for i, vals in enumerate(data, start=1):
            boot = [np.mean(np.random.default_rng(s).choice(vals, len(vals)))
                    for s in range(200)]
            lo, hi = np.percentile(boot, [2.5, 97.5])
            ax.plot([i, i], [lo, hi], color="black", lw=2)
        ax.set_xticks(range(1, len(names) + 1), names, rotation=30,
                      ha="right")
        ax.set_ylim(*SCORE_RANGE)
        ax.set_ylabel("top-and-random correlation score")
        ax.set_title(title)
        fig.tight_layout()
        save_figure(fig, save_path)
    return {n: (float(np.mean(d)), float(np.std(d))) for n, d in
            zip(names, data)}


def plot_autointerp_vs_baselines(results_root: str | Path,
                                 save_path: Optional[str | Path] = None,
                                 layer_loc: str = "residual") -> dict:
    """Read per-transform score folders and summarize (and draw) the
    comparison."""
    from sparse_coding_tpu_torch.interp.run import read_transform_scores

    scores = read_transform_scores(results_root)
    return plot_score_violins(scores, save_path=save_path,
                              title=f"autointerp vs baselines ({layer_loc})")
