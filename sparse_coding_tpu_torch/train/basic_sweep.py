"""Minimal single-device L1 sweep over a directory of activation chunks —
the port of the JAX package's ``train/basic_sweep.py``, its "minimum
end-to-end slice": one SAE ensemble over an l1 grid — tied
(``FunctionalTiedSAE``) or, with ``tied=False``, untied
(``FunctionalSAE``) — fed from a ChunkStore through device prefetch,
saving learned dicts + FVU/L0 per epoch. On the card either family trains
on its kernels (``train_step_tiled``).

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
    sweep, one metrics line holds each member's loss, mse and l0. On a
    ``mesh`` (:mod:`parallel.mesh`) every rank reads the same batches,
    trains its member shard on its rows, and rank 0 alone writes the
    metrics and the artifacts; every rank returns every dict."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    store = open_store(dataset_dir)
    d = store.activation_dim
    n_dict = int(d * dict_ratio)
    sig = FunctionalTiedSAE if tied else FunctionalSAE

    gen = torch.Generator().manual_seed(seed)
    members = [sig.init(gen, d, n_dict, l1_alpha=float(l1))
               for l1 in l1_values]
    ens = Ensemble(members, sig, lr=lr, adam_eps=adam_epsilon,
                   **({"device": dev} if mesh is None else {"mesh": mesh}))

    rng = np.random.default_rng(seed)
    step = last_log = 0
    scan_k = max(1, int(scan_steps))
    logger = (MetricsLogger(output_dir, use_wandb=use_wandb,
                            run_name="basic_l1_sweep")
              if writer else None)
    try:
        for epoch in range(n_epochs):
            batches = store.epoch(batch_size, rng)
            if scan_k > 1:
                batches = window_stacks(batches, scan_k)
            # on a mesh each rank moves only its own rows to its device
            for batch in (device_prefetch(batches, dev) if mesh is None
                          else batches):
                if scan_k > 1:
                    aux = ens.run_steps(batch)
                    step += batch.shape[0]
                    last = lambda v: v[-1]
                else:
                    aux = ens.step_batch(batch)
                    step += 1
                    last = lambda v: v
                if step - last_log >= 100 and writer:
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
                        rng, writer)
    finally:
        if logger is not None:
            logger.close()
    return [(ld, {"l1_alpha": float(l1), "dict_size": n_dict})
            for ld, l1 in zip(ens.to_learned_dicts(), l1_values)]


def _save_epoch(ens: Ensemble, l1_values, dict_ratio, store: ChunkStore,
                output_dir, epoch: int, rng, writer: bool = True) -> None:
    """The epoch's dicts and quick evals; every rank of a mesh gathers the
    dicts and draws the eval rows (the batch rng stays in step), the
    ``writer`` alone evaluates and writes."""
    out = Path(output_dir) / f"epoch_{epoch}"
    tagged = [(ld, {"l1_alpha": float(l1), "dict_ratio": dict_ratio})
              for ld, l1 in zip(ens.to_learned_dicts(), l1_values)]
    # quick eval on a fresh slab — the same rng draws as the JAX sweep
    chunk = store.load_chunk(int(rng.integers(store.n_chunks)))
    rows = rng.permutation(chunk.shape[0])[:4096]
    if not writer:
        return
    save_learned_dicts(tagged, out / "learned_dicts.pkl")
    eval_batch = torch.as_tensor(chunk[rows], device=ens.device)
    stats = []
    for ld, hyper in tagged:
        ld = ld.to(ens.device)
        stats.append({
            "l1_alpha": hyper["l1_alpha"],
            "fvu": float(fraction_variance_unexplained(ld, eval_batch)),
            "l0": float(mean_l0(ld, eval_batch))})
    atomic_write_text(out / "eval.json", json.dumps(stats, indent=2))


def main(argv=None) -> None:
    """CLI; ``--mesh_model M --mesh_data D`` runs under ``torchrun
    --nproc_per_node M*D``."""
    from sparse_coding_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )

    cfg = EnsembleArgs.from_cli(argv)
    mesh = None
    if cfg.mesh_data > 1 or cfg.mesh_model > 1:
        initialize_distributed()
        mesh = make_mesh(cfg.mesh_model, cfg.mesh_data)
    try:
        basic_l1_sweep(cfg.dataset_folder, cfg.output_folder,
                       list(np.logspace(-4, -2, 16)),
                       dict_ratio=cfg.learned_dict_ratio,
                       batch_size=cfg.batch_size, lr=cfg.lr,
                       tied=cfg.tied_ae, adam_epsilon=cfg.adam_epsilon,
                       seed=cfg.seed, mesh=mesh, use_wandb=cfg.use_wandb,
                       scan_steps=cfg.scan_steps)
    finally:
        if mesh is not None:
            shutdown_distributed()


if __name__ == "__main__":
    main()
