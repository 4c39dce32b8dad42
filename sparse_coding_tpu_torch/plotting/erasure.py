"""Concept-erasure plots (the JAX package's ``plotting/erasure.py``):
probe AUROC against edit magnitude along the feature-erasure curve with
the LEACE point, and the task metric as the top-ranked features are
ablated. matplotlib is imported when a figure is drawn, never at
import."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

from sparse_coding_tpu_torch.plotting.helpers import _new_fig


def _save(fig, save_path) -> None:
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150)


def plot_erasure_tradeoff(curve: Sequence[dict], leace: Optional[dict] = None,
                          x_key: str = "edit_magnitude", y_key: str = "auroc",
                          save_path: Optional[str | Path] = None,
                          title: str = "concept erasure tradeoff") -> None:
    """Probe AUROC (or KL) against edit magnitude along the
    feature-erasure curve, LEACE as a reference point."""
    fig, ax = _new_fig(figsize=(7, 5))
    pts = sorted(curve, key=lambda r: r[x_key])
    ax.plot([p[x_key] for p in pts], [p[y_key] for p in pts], marker="o",
            label="feature erasure")
    for p in pts:
        ax.annotate(str(p.get("n_erased", "")), (p[x_key], p[y_key]),
                    fontsize=7, xytext=(3, 3), textcoords="offset points")
    if leace is not None and x_key in leace and y_key in leace:
        ax.scatter([leace[x_key]], [leace[y_key]], marker="*", s=150,
                   color="crimson", label="LEACE", zorder=3)
    ax.set_xlabel(x_key)
    ax.set_ylabel(y_key)
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    _save(fig, save_path)


def plot_task_ablation_curve(curve: dict, ranking=None,
                             save_path: Optional[str | Path] = None,
                             title: str = "task metric vs features ablated",
                             ylabel: str = "task metric (IOI logit diff)"
                             ) -> None:
    """The task metric as the top-m ranked features are jointly ablated
    (a ``tasks/feature_ident.py::cumulative_ablation_curve`` result), the
    unablated base as a reference line."""
    fig, ax = _new_fig(figsize=(7, 4.5))
    m = len(curve["metrics"])
    xs = range(1, m + 1)
    ax.plot(xs, curve["metrics"], marker="o", label="top-m ablated")
    ax.axhline(curve["base_metric"], color="gray", ls="--",
               label="base (no ablation)")
    if ranking is not None:
        for x, feat in zip(xs, ranking):
            ax.annotate(str(int(feat)), (x, float(curve["metrics"][x - 1])),
                        fontsize=7, xytext=(3, 3),
                        textcoords="offset points")
    ax.set_xlabel("features ablated (ranked by causal effect)")
    ax.set_ylabel(ylabel)
    if m <= 30:  # per-point ticks are unreadable beyond that
        ax.set_xticks(list(xs))
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    _save(fig, save_path)
