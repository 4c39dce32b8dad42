"""Experiment registry: functions building the ensembles for ``sweep()``
(the port's copy of the JAX package's ``train/experiments.py``, for the
experiments whose families the port trains on its kernels; the others
raise, naming ROADMAP.md queue 1, item 8).

An experiment takes ``(cfg, mesh, device=...)`` and returns
``[(Ensemble, member_hyperparams, name)]``. Member inits come from a
``torch.Generator`` seeded from ``cfg.seed`` (``jax.random`` streams
cannot be reproduced in torch), so they differ from the JAX package's; a
caller that needs the JAX run's numbers passes its members through
``inits={entry name: [(params, buffers), ...]}`` (numpy arrays, e.g. a
``device_get`` of the JAX experiment's members), and the port builds its
Ensemble from those. The engine knobs come from the config: ``use_fused``
(``auto``/``on``/``off``), ``fused_path`` and ``sentinel``; the JAX
package's tile knobs and ``fused_interpret`` have no counterpart (the
card's kernels block at fixed tiles, and the CPU runs the plain versions).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.config import EnsembleArgs
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.models.sae import (
    FunctionalMaskedTiedSAE,
    FunctionalSAE,
    FunctionalTiedSAE,
)

DEFAULT_L1_RANGE = list(np.logspace(-4, -2, 16))  # the reference's grid


def _engine_kwargs(cfg: EnsembleArgs) -> dict:
    """The engine knobs every experiment passes, from the sweep config."""
    use_fused = {"on": True, "off": False}.get(
        str(getattr(cfg, "use_fused", "auto")), "auto")
    return dict(sentinel=bool(getattr(cfg, "sentinel", True)),
                use_fused=use_fused,
                fused_path=getattr(cfg, "fused_path", None))


def _activation_dim(cfg: EnsembleArgs) -> int:
    from sparse_coding_tpu_torch.data.shard_store import open_store

    return open_store(cfg.dataset_folder).activation_dim


def _build(sig, name: str, cfg: EnsembleArgs, seed: int, make_member,
           specs: Sequence, inits: Optional[dict], device) -> Ensemble:
    """One entry's Ensemble: members carried in through ``inits[name]``,
    else drawn in order from a generator seeded with ``seed``."""
    if inits is not None and name in inits:
        from sparse_coding_tpu_torch.utils.carry import members_from_numpy

        members = members_from_numpy(inits[name])
        if len(members) != len(specs):
            raise ValueError(f"inits[{name!r}] holds {len(members)} "
                             f"members, the grid {len(specs)}")
    else:
        gen = torch.Generator().manual_seed(int(seed))
        members = [make_member(gen, spec) for spec in specs]
    return Ensemble(members, sig, lr=cfg.lr, adam_eps=cfg.adam_epsilon,
                    device=device, **_engine_kwargs(cfg))


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "meshes wait for the multi-GPU slice (ROADMAP.md queue 1, "
            "item 11)")


def dense_l1_range_experiment(cfg: EnsembleArgs, mesh=None,
                              l1_range: Optional[Sequence[float]] = None,
                              activation_dim: Optional[int] = None,
                              inits: Optional[dict] = None, device=None):
    """An l1 sweep at one dictionary ratio, tied or untied
    (``cfg.tied_ae``)."""
    _check_mesh(mesh)
    l1s = list(l1_range if l1_range is not None else DEFAULT_L1_RANGE)
    d = activation_dim or _activation_dim(cfg)
    n_dict = int(d * cfg.learned_dict_ratio)
    sig = FunctionalTiedSAE if cfg.tied_ae else FunctionalSAE
    ens = _build(sig, "dense_l1_range", cfg, cfg.seed,
                 lambda g, l1: sig.init(g, d, n_dict, l1_alpha=float(l1)),
                 l1s, inits, device)
    hypers = [{"l1_alpha": float(l1), "dict_size": n_dict,
               "tied": cfg.tied_ae} for l1 in l1s]
    return [(ens, hypers, "dense_l1_range")]


def tied_vs_not_experiment(cfg: EnsembleArgs, mesh=None,
                           l1_range: Optional[Sequence[float]] = None,
                           activation_dim: Optional[int] = None,
                           inits: Optional[dict] = None, device=None):
    """Tied and untied ensembles over the same l1 grid."""
    _check_mesh(mesh)
    l1s = list(l1_range if l1_range is not None else DEFAULT_L1_RANGE)
    d = activation_dim or _activation_dim(cfg)
    n_dict = int(d * cfg.learned_dict_ratio)
    out = []
    for tied, sig, name in [(True, FunctionalTiedSAE, "tied"),
                            (False, FunctionalSAE, "untied")]:
        ens = _build(sig, name, cfg, cfg.seed + tied,
                     lambda g, l1, sig=sig: sig.init(g, d, n_dict,
                                                     l1_alpha=float(l1)),
                     l1s, inits, device)
        hypers = [{"l1_alpha": float(l1), "dict_size": n_dict, "tied": tied}
                  for l1 in l1s]
        out.append((ens, hypers, name))
    return out


def dict_ratio_experiment(cfg: EnsembleArgs, mesh=None,
                          ratios: Sequence[float] = (0.5, 1, 2, 4, 8, 16, 32),
                          l1_alpha: float = 8.577e-4,
                          activation_dim: Optional[int] = None,
                          inits: Optional[dict] = None, device=None):
    """Mixed dictionary sizes in one masked-tied ensemble (the stack is the
    largest size; each member's coef_mask keeps its own). The l1 default
    is the reference's canonical operating point."""
    _check_mesh(mesh)
    d = activation_dim or _activation_dim(cfg)
    sizes = [int(d * r) for r in ratios]
    n_stack = max(sizes)
    ens = _build(FunctionalMaskedTiedSAE, "dict_ratio", cfg, cfg.seed,
                 lambda g, n: FunctionalMaskedTiedSAE.init(
                     g, d, n, n_stack, l1_alpha=l1_alpha),
                 sizes, inits, device)
    hypers = [{"l1_alpha": l1_alpha, "dict_size": n, "dict_ratio": r}
              for n, r in zip(sizes, ratios)]
    return [(ens, hypers, "dict_ratio")]


def zero_l1_baseline_experiment(cfg: EnsembleArgs, mesh=None,
                                activation_dim: Optional[int] = None,
                                inits: Optional[dict] = None, device=None):
    """An l1=0 pure-reconstruction member beside a small l1 grid."""
    return dense_l1_range_experiment(cfg, mesh, l1_range=[0.0, 1e-4, 1e-3],
                                     activation_dim=activation_dim,
                                     inits=inits, device=device)


def long_l1_range_experiment(cfg: EnsembleArgs, mesh=None,
                             activation_dim: Optional[int] = None,
                             inits: Optional[dict] = None, device=None):
    """A 32-point l1 grid."""
    return dense_l1_range_experiment(cfg, mesh,
                                     l1_range=list(np.logspace(-5, -2, 32)),
                                     activation_dim=activation_dim,
                                     inits=inits, device=device)


def _not_ported(name: str, item: int, what: str):
    def experiment(cfg, mesh=None, **kwargs):
        raise NotImplementedError(
            f"experiment {name!r} needs {what}, not ported yet (ROADMAP.md "
            f"queue 1, item {item})")

    experiment.__name__ = f"{name}_experiment"
    return experiment


EXPERIMENTS = {
    "dense_l1_range": dense_l1_range_experiment,
    "tied_vs_not": tied_vs_not_experiment,
    "topk": _not_ported("topk", 8, "TopKEncoder and EnsembleGroup buckets"),
    "dict_ratio": dict_ratio_experiment,
    "zero_l1_baseline": zero_l1_baseline_experiment,
    "long_l1_range": long_l1_range_experiment,
    "residual_denoising": _not_ported("residual_denoising", 8,
                                      "the LISTA family and EnsembleGroup"),
    "centered_l1_range": _not_ported("centered_l1_range", 8,
                                     "BatchedPCA and the centered tied SAE"),
    "reverse_l1_range": _not_ported("reverse_l1_range", 8, "ReverseSAE"),
    "positive_l1_range": _not_ported("positive_l1_range", 8,
                                     "the positive SAE family"),
    "semilinear_l1_range": _not_ported("semilinear_l1_range", 8,
                                       "the semilinear SAE family"),
    "rica": _not_ported("rica", 8, "the RICA family"),
}


def get_experiment(name: str):
    return EXPERIMENTS[name]
