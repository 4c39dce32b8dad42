"""Time-series figures over training snapshots (the JAX package's
``plotting/timeseries.py``): the mean autointerp score per snapshot from
an ``interp.run.interpret_across_chunks`` output tree, and active-feature
counts per member over a sweep's ``_N/`` snapshot folders (one
``metrics.geometry.activity_sweep`` census on the card). Each returns its
series; the figure is drawn only when a ``save_path`` is given."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from sparse_coding_tpu_torch.plotting.helpers import _new_fig, save_figure


def _snapshot_dirs(root: str | Path) -> list[Path]:
    """``_N`` snapshot folders in training order."""
    dirs = [p for p in Path(root).glob("_*")
            if p.is_dir() and p.name[1:].isdigit()]
    return sorted(dirs, key=lambda p: int(p.name[1:]))


def plot_autointerp_across_chunks(interp_output_root: str | Path,
                                  save_path: Optional[str | Path] = None,
                                  score_key: str = "top_random_score"
                                  ) -> dict:
    """Mean autointerp score ± 95% CI per training snapshot, one series per
    ensemble member, from the tree ``interpret_across_chunks`` writes
    (``<output_folder>/_N/<artifact>_<i>/feature_*/scores.json``). Returns
    {member: {"snapshots": [...], "mean": [...], "ci95": [...]}}."""
    from sparse_coding_tpu_torch.interp.run import read_scores

    series: dict[str, dict[str, list]] = {}
    for snap in _snapshot_dirs(interp_output_root):
        for member_dir in sorted(p for p in snap.iterdir() if p.is_dir()):
            scores = [rec[score_key]
                      for rec in read_scores(member_dir).values()
                      if score_key in rec]
            if not scores:
                continue
            s = series.setdefault(member_dir.name,
                                  {"snapshots": [], "mean": [], "ci95": []})
            vals = np.asarray(scores, float)
            s["snapshots"].append(int(snap.name[1:]))
            s["mean"].append(float(vals.mean()))
            s["ci95"].append(
                float(1.96 * vals.std(ddof=1) / np.sqrt(len(vals)))
                if len(vals) > 1 else 0.0)
    if save_path is not None and series:
        fig, ax = _new_fig(figsize=(7, 4.5))
        for name, s in sorted(series.items()):
            ax.errorbar(s["snapshots"], s["mean"], yerr=s["ci95"],
                        marker="o", capsize=3, label=name)
        ax.set_xlabel("training snapshot (chunks seen)")
        ax.set_ylabel(f"mean {score_key}")
        ax.set_title("auto-interpretation over training")
        ax.legend(fontsize=7)
        fig.tight_layout()
        save_figure(fig, save_path)
    return series


def plot_n_active_over_time(sweep_output: str | Path, activations,
                            threshold: int = 10, batch_size: int = 1000,
                            save_path: Optional[str | Path] = None,
                            device=None) -> dict:
    """Active-feature counts (active in more than ``threshold`` rows) for
    every ensemble member at every saved training snapshot of a sweep
    output tree, over ``activations`` (an array or a store, streamed
    once for all snapshots), on ``device`` (default: the card). Returns
    {member_label: {"snapshots": [...], "n_active": [...]}}."""
    from sparse_coding_tpu_torch.metrics.geometry import activity_sweep

    file_snapshot: dict[str, int] = {}
    all_files: list = []
    for snap in _snapshot_dirs(sweep_output):
        for f in sorted(snap.glob("*_learned_dicts.pkl")):
            file_snapshot[str(f)] = int(snap.name[1:])
            all_files.append(f)
    recs = activity_sweep(all_files, activations, threshold=threshold,
                          batch_size=batch_size,
                          device=device) if all_files else []

    series: dict[str, dict[str, list]] = {}
    for rec in recs:
        hyper_bits = [f"{k}={rec[k]}" for k in ("l1_alpha", "dict_size")
                      if k in rec]
        # the member index tells apart seed replicates that share every
        # hyperparameter: identical labels must not merge series
        label = (" ".join(hyper_bits) or "member") + \
            f" (n={rec['n_feats']}) #{rec['member']}"
        s = series.setdefault(label, {"snapshots": [], "n_active": []})
        s["snapshots"].append(file_snapshot[rec["artifact"]])
        s["n_active"].append(int(rec["n_ever_active"]))
    if save_path is not None and series:
        fig, ax = _new_fig(figsize=(7, 4.5))
        for name, s in sorted(series.items()):
            ax.plot(s["snapshots"], s["n_active"], marker="o", label=name)
        ax.set_xlabel("training snapshot (chunks seen)")
        ax.set_ylabel(f"features active > {threshold} times")
        ax.set_title("active features over training")
        ax.legend(fontsize=7)
        fig.tight_layout()
        save_figure(fig, save_path)
    return series
