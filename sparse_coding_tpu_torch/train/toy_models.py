"""Toy-models replication (the JAX package's ``train/toy_models.py``):
SAEs at several L1 values, trained in one ensemble on a ground-truth
sparse dataset, scored by MMCS and representedness against the true
dictionary — the stage-1 acceptance gate.

The ensemble trains through ``Ensemble``'s default path, on the card the
tied kernels. The data and inits come from ``torch.Generator``s seeded
with ``cfg.seed`` (the data's on the run's device, the inits' on the
CPU), as ``train/experiments.py`` seeds: other numbers than the JAX
package's three ``jax.random`` streams, the same distributions.

Run: ``python -m sparse_coding_tpu_torch.train.toy_models [--device cpu]
[ToyArgs flags]``; writes ``toy_output/toy_recovery.json`` and its plot.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.config import ToyArgs
from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.metrics.core import (
    fraction_variance_unexplained,
    mmcs_to_fixed,
    representedness,
)
from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE


def run_toy_replication(cfg: ToyArgs, l1_values=None,
                        output_folder: Optional[str] = None,
                        device=None) -> list[dict]:
    """Train an L1 ensemble on a toy ground-truth dataset on ``device``
    (default: the card); return each member's recovery metrics."""
    dev = resolve_device(device)
    l1_values = list(l1_values) if l1_values is not None else [
        cfg.l1_alpha / 3, cfg.l1_alpha, cfg.l1_alpha * 3]
    g_data = torch.Generator(dev).manual_seed(cfg.seed)
    g_init = torch.Generator().manual_seed(cfg.seed)
    gen = RandomDatasetGenerator.create(
        g_data, cfg.activation_dim, cfg.n_ground_truth_features,
        cfg.feature_num_nonzero, cfg.feature_prob_decay,
        correlated=cfg.correlated_components)

    n_dict = int(cfg.n_ground_truth_features * cfg.learned_dict_ratio)
    members = [FunctionalTiedSAE.init(g_init, cfg.activation_dim, n_dict,
                                      l1_alpha=float(l1))
               for l1 in l1_values]
    ens = Ensemble(members, FunctionalTiedSAE, lr=cfg.lr, device=dev)

    steps = cfg.epochs * cfg.dataset_size // cfg.batch_size
    for _ in range(steps):
        ens.step_batch(gen.batch(g_data, cfg.batch_size))

    eval_batch = gen.batch(g_data, 4096)
    results = []
    for ld, l1 in zip(ens.to_learned_dicts(), l1_values):
        ld = ld.to(dev)
        results.append({
            "l1_alpha": float(l1),
            "mmcs_to_truth": float(mmcs_to_fixed(ld, gen.feats)),
            "representedness": float(representedness(gen.feats, ld).mean()),
            "fvu": float(fraction_variance_unexplained(ld, eval_batch)),
        })

    if output_folder is not None:
        from sparse_coding_tpu_torch.resilience.atomic import (
            atomic_write_text,
        )

        out = Path(output_folder)
        out.mkdir(parents=True, exist_ok=True)
        atomic_write_text(out / "toy_recovery.json",
                          json.dumps(results, indent=2))
        _plot_recovery(results, out / "toy_recovery.png")
    return results


def _plot_recovery(results, save_path) -> None:
    from sparse_coding_tpu_torch.plotting.helpers import _new_fig

    fig, ax = _new_fig(figsize=(6, 4))
    l1s = [r["l1_alpha"] for r in results]
    ax.plot(l1s, [r["representedness"] for r in results], marker="o",
            label="representedness")
    ax.plot(l1s, [r["mmcs_to_truth"] for r in results], marker="s",
            label="MMCS to truth")
    ax.plot(l1s, [r["fvu"] for r in results], marker="^", label="FVU")
    ax.set_xscale("log")
    ax.set_xlabel("l1_alpha")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ns, rest = ap.parse_known_args(argv)
    cfg = ToyArgs.from_cli(rest)
    results = run_toy_replication(cfg, output_folder="toy_output",
                                  device=ns.device)
    for r in results:
        print(r)


if __name__ == "__main__":
    main()
