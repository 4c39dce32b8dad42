"""Minimal single-device L1 sweep over a directory of activation chunks —
the port of the JAX package's ``train/basic_sweep.py``, its "minimum
end-to-end slice": one tied-SAE ensemble over an l1 grid, fed from a
ChunkStore through device prefetch, saving learned dicts + FVU/L0 per
epoch.

Same epoch order as the JAX sweep (``np.random.default_rng(seed)``) and
the same ``epoch_<i>/learned_dicts.pkl`` + ``eval.json`` artifacts. The
member inits come from a ``torch.Generator`` seeded with ``seed``, so they
differ from the JAX run's ``jax.random`` inits.

Run: ``python -m sparse_coding_tpu_torch.train.basic_sweep
--dataset_folder DIR --output_folder DIR [--batch_size N ...]``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.config import EnsembleArgs
from sparse_coding_tpu_torch.data.chunk_store import (
    ChunkStore,
    device_prefetch,
    window_stacks,
)
from sparse_coding_tpu_torch.data.shard_store import open_store
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.metrics.core import (
    fraction_variance_unexplained,
    mean_l0,
)
from sparse_coding_tpu_torch.models.sae import FunctionalSAE, FunctionalTiedSAE
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.utils.artifacts import save_learned_dicts
from sparse_coding_tpu_torch.utils.logging import MetricsLogger


def basic_l1_sweep(
    dataset_dir: str | Path,
    output_dir: str | Path,
    l1_values: Sequence[float],
    dict_ratio: float = 4.0,
    batch_size: int = 1024,
    lr: float = 1e-3,
    n_epochs: int = 1,
    tied: bool = True,
    adam_epsilon: float = 1e-8,
    seed: int = 0,
    mesh=None,
    use_wandb: bool = False,
    scan_steps: int = 1,
    device=None,
) -> list:
    """Train one ensemble member per l1 value; save per-epoch artifacts.
    Returns the final [(LearnedDict, hyperparams)]. ``device=None`` runs
    on the card (and raises without one). Every 100 steps, as in the JAX
    sweep, one metrics line holds each member's loss, mse and l0."""
    if mesh is not None:
        raise NotImplementedError("meshes wait for the multi-GPU slice")
    if use_wandb:
        raise NotImplementedError("wandb logging is not ported; metrics go "
                                  "to metrics.jsonl")
    dev = resolve_device(device)
    store = open_store(dataset_dir)
    d = store.activation_dim
    n_dict = int(d * dict_ratio)
    sig = FunctionalTiedSAE if tied else FunctionalSAE

    gen = torch.Generator().manual_seed(seed)
    members = [sig.init(gen, d, n_dict, l1_alpha=float(l1))
               for l1 in l1_values]
    ens = Ensemble(members, sig, lr=lr, adam_eps=adam_epsilon, device=dev)

    rng = np.random.default_rng(seed)
    step = last_log = 0
    scan_k = max(1, int(scan_steps))
    with MetricsLogger(output_dir, run_name="basic_l1_sweep") as logger:
        for epoch in range(n_epochs):
            batches = store.epoch(batch_size, rng)
            if scan_k > 1:
                batches = window_stacks(batches, scan_k)
            for batch in device_prefetch(batches, dev):
                if scan_k > 1:
                    aux = ens.run_steps(batch)
                    step += batch.shape[0]
                    last = lambda v: v[-1]
                else:
                    aux = ens.step_batch(batch)
                    step += 1
                    last = lambda v: v
                if step - last_log >= 100:
                    last_log = step
                    # one host sync for all members per log window
                    stats = torch.stack([
                        last(aux.losses["loss"]),
                        last(aux.losses["l_reconstruction"]),
                        last(aux.l0)]).cpu().numpy()
                    logger.log({f"l1={l1:.2e}/{k}": float(stats[j, i])
                                for i, l1 in enumerate(l1_values)
                                for j, k in enumerate(("loss", "mse", "l0"))},
                               step=step)
            _save_epoch(ens, l1_values, dict_ratio, store, output_dir, epoch,
                        rng)
    return [(ld, {"l1_alpha": float(l1), "dict_size": n_dict})
            for ld, l1 in zip(ens.to_learned_dicts(), l1_values)]


def _save_epoch(ens: Ensemble, l1_values, dict_ratio, store: ChunkStore,
                output_dir, epoch: int, rng) -> None:
    out = Path(output_dir) / f"epoch_{epoch}"
    tagged = [(ld, {"l1_alpha": float(l1), "dict_ratio": dict_ratio})
              for ld, l1 in zip(ens.to_learned_dicts(), l1_values)]
    save_learned_dicts(tagged, out / "learned_dicts.pkl")
    # quick eval on a fresh slab — the same rng draws as the JAX sweep
    chunk = store.load_chunk(int(rng.integers(store.n_chunks)))
    eval_batch = torch.as_tensor(
        chunk[rng.permutation(chunk.shape[0])[:4096]], device=ens.device)
    stats = []
    for ld, hyper in tagged:
        ld = ld.to(ens.device)
        stats.append({
            "l1_alpha": hyper["l1_alpha"],
            "fvu": float(fraction_variance_unexplained(ld, eval_batch)),
            "l0": float(mean_l0(ld, eval_batch))})
    atomic_write_text(out / "eval.json", json.dumps(stats, indent=2))


def main(argv=None) -> None:
    cfg = EnsembleArgs.from_cli(argv)
    basic_l1_sweep(cfg.dataset_folder, cfg.output_folder,
                   list(np.logspace(-4, -2, 16)),
                   dict_ratio=cfg.learned_dict_ratio,
                   batch_size=cfg.batch_size, lr=cfg.lr, tied=cfg.tied_ae,
                   adam_epsilon=cfg.adam_epsilon, seed=cfg.seed,
                   use_wandb=cfg.use_wandb, scan_steps=cfg.scan_steps)


if __name__ == "__main__":
    main()
