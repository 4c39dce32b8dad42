"""Experiment registry: functions building the ensembles for ``sweep()``
(the port's copy of the JAX package's ``train/experiments.py``, all
twelve experiments).

An experiment takes ``(cfg, mesh, device=...)`` and returns
``[(Ensemble | EnsembleGroup, member_hyperparams, name)]``; the group
entries (``topk``, ``residual_denoising``, ``reverse_l1_range``,
``positive_l1_range``, ``semilinear_l1_range``, ``rica``) bucket their
members by static buffers, as the JAX experiments do, with the JAX defaults,
grids and hyperparameter order. Member inits come from a
``torch.Generator`` seeded from ``cfg.seed`` (``jax.random`` streams
cannot be reproduced in torch), so they differ from the JAX package's; a
caller that needs the JAX run's numbers passes its members through
``inits={entry name: [(params, buffers), ...]}`` (numpy arrays, e.g. a
``device_get`` of the JAX experiment's members, in its member order), and
the port builds its entry from those. The engine knobs come from the config: ``use_fused``
(``auto``/``on``/``off``), ``fused_path`` and ``sentinel``; the JAX
package's tile knobs and ``fused_interpret`` have no counterpart (the
card's kernels block at fixed tiles, and the CPU runs the plain versions).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.config import EnsembleArgs
from sparse_coding_tpu_torch.ensemble import Ensemble, EnsembleGroup
from sparse_coding_tpu_torch.parallel.mesh import Mesh
from sparse_coding_tpu_torch.models.sae import (
    FunctionalMaskedTiedSAE,
    FunctionalSAE,
    FunctionalTiedSAE,
)

DEFAULT_L1_RANGE = list(np.logspace(-4, -2, 16))  # the reference's grid


def _sentinel(cfg: EnsembleArgs) -> bool:
    return bool(getattr(cfg, "sentinel", True))


def _engine_kwargs(cfg: EnsembleArgs) -> dict:
    """The engine knobs every single-bucket experiment passes, from the
    sweep config (the group experiments pass the sentinel alone, as in the
    JAX package)."""
    use_fused = {"on": True, "off": False}.get(
        str(getattr(cfg, "use_fused", "auto")), "auto")
    return dict(sentinel=_sentinel(cfg),
                use_fused=use_fused,
                fused_path=getattr(cfg, "fused_path", None))


def _activation_dim(cfg: EnsembleArgs) -> int:
    from sparse_coding_tpu_torch.data.shard_store import open_store

    return open_store(cfg.dataset_folder).activation_dim


def _members(name: str, seed: int, make_member, specs: Sequence,
             inits: Optional[dict]) -> list:
    """An entry's members: carried in through ``inits[name]``, else drawn
    in order from a generator seeded with ``seed``."""
    if inits is not None and name in inits:
        from sparse_coding_tpu_torch.utils.carry import members_from_numpy

        members = members_from_numpy(inits[name])
        if len(members) != len(specs):
            raise ValueError(f"inits[{name!r}] holds {len(members)} "
                             f"members, the grid {len(specs)}")
        return members
    gen = torch.Generator().manual_seed(int(seed))
    return [make_member(gen, spec) for spec in specs]


def _build(sig, name: str, cfg: EnsembleArgs, seed: int, make_member,
           specs: Sequence, inits: Optional[dict], device) -> Ensemble:
    """One single-bucket entry's Ensemble."""
    return Ensemble(_members(name, seed, make_member, specs, inits), sig,
                    lr=cfg.lr, adam_eps=cfg.adam_epsilon,
                    **_engine_place(device), **_engine_kwargs(cfg))


def _placement(mesh, device):
    """Where an entry's ensembles live: the mesh when there is one (each
    rank keeps its member shard), else ``device``."""
    return mesh if mesh is not None else device


def _engine_place(place) -> dict:
    """``Ensemble``'s placement keyword for a :func:`_placement`."""
    return ({"mesh": place} if isinstance(place, Mesh)
            else {"device": place})


def _device_of(place):
    """The device of a :func:`_placement` (a mesh's: this rank's)."""
    return place.device if isinstance(place, Mesh) else place


def dense_l1_range_experiment(cfg: EnsembleArgs, mesh=None,
                              l1_range: Optional[Sequence[float]] = None,
                              activation_dim: Optional[int] = None,
                              inits: Optional[dict] = None, device=None):
    """An l1 sweep at one dictionary ratio, tied or untied
    (``cfg.tied_ae``)."""
    device = _placement(mesh, device)
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
    device = _placement(mesh, device)
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
    device = _placement(mesh, device)
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


def _group(sig, name: str, cfg: EnsembleArgs, make_member, specs: Sequence,
           inits: Optional[dict], device, **ensemble_kwargs) -> EnsembleGroup:
    """One group entry: members carried in through ``inits[name]`` (in the
    JAX experiment's member order), else drawn in order from a generator
    seeded with ``cfg.seed``, then bucketed by their static buffers."""
    return EnsembleGroup.build(sig, _members(name, cfg.seed, make_member,
                                             specs, inits),
                               lr=cfg.lr, **_engine_place(device),
                               **ensemble_kwargs)


def topk_experiment(cfg: EnsembleArgs, mesh=None,
                    ks: Sequence[int] = (4, 8, 16, 32, 64, 128),
                    activation_dim: Optional[int] = None,
                    inits: Optional[dict] = None, device=None):
    """A TopK sweep across k: one bucket per k."""
    from sparse_coding_tpu_torch.models.topk import TopKEncoder

    device = _placement(mesh, device)
    d = activation_dim or _activation_dim(cfg)
    n_dict = int(d * cfg.learned_dict_ratio)
    group = _group(TopKEncoder, "topk", cfg,
                   lambda g, k: TopKEncoder.init(g, d, n_dict, k=int(k)),
                   ks, inits, device, sentinel=_sentinel(cfg))
    # the hypers follow the buckets' flattening order (to_learned_dicts
    # walks the buckets in insertion order), not sorted(ks)
    hypers = [{"k": dict(ens.state.static_buffers)["k"], "dict_size": n_dict}
              for ens in group.ensembles.values()
              for _ in range(ens.n_members)]
    return [(group, hypers, "topk")]


def residual_denoising_experiment(cfg: EnsembleArgs, mesh=None,
                                  l1_range: Optional[Sequence[float]] = None,
                                  n_hidden_layers: int = 2,
                                  activation_dim: Optional[int] = None,
                                  inits: Optional[dict] = None, device=None):
    """A LISTA-denoising encoder sweep."""
    from sparse_coding_tpu_torch.models.lista import (
        FunctionalLISTADenoisingSAE,
    )

    device = _placement(mesh, device)
    l1s = list(l1_range if l1_range is not None else np.logspace(-4, -2, 8))
    d = activation_dim or _activation_dim(cfg)
    n_dict = int(d * cfg.learned_dict_ratio)
    group = _group(FunctionalLISTADenoisingSAE, "residual_denoising", cfg,
                   lambda g, l1: FunctionalLISTADenoisingSAE.init(
                       g, d, n_dict, l1_alpha=float(l1),
                       n_hidden_layers=n_hidden_layers),
                   l1s, inits, device, sentinel=_sentinel(cfg))
    hypers = [{"l1_alpha": float(l1), "dict_size": n_dict,
               "n_hidden_layers": n_hidden_layers} for l1 in l1s]
    return [(group, hypers, "residual_denoising")]


def centered_l1_range_experiment(cfg: EnsembleArgs, mesh=None,
                                 l1_range: Optional[Sequence[float]] = None,
                                 activation_dim: Optional[int] = None,
                                 whiten: bool = True, centering=None,
                                 inits: Optional[dict] = None, device=None):
    """A tied SAE sweep in whitened space: a PCA whitening transform
    fitted on the store's first sound chunk becomes fixed rotation,
    translation and scaling buffers of every member. ``centering=(mean,
    rot, scale)`` skips the fit (``rot`` in row form, as ``center()``
    applies it); ``whiten=False`` keeps the rotation with unit scaling.
    The centering makes the bucket ineligible for the kernels: it trains
    on autodiff, as in the JAX package."""
    from sparse_coding_tpu_torch.models.pca import BatchedPCA

    device = _placement(mesh, device)
    l1s = list(l1_range if l1_range is not None else DEFAULT_L1_RANGE)
    if getattr(cfg, "center_activations", False):
        raise ValueError(
            "centered_l1_range centers via member buffers; combining it with "
            "cfg.center_activations would double-shift the data relative to "
            "the stored transform")
    if centering is None:
        from sparse_coding_tpu_torch.data.shard_store import (
            first_sound_chunk,
            open_store,
        )

        store = open_store(cfg.dataset_folder)
        acts = store.load_chunk(first_sound_chunk(store))
        pca = BatchedPCA(acts.shape[-1], device=_device_of(device))
        pca.train_batch(acts)
        mean, rot, inv_std = pca.get_centering_transform()
        # eigenvectors come as columns; center() applies rot as rows
        rot = rot.T
    else:
        mean, rot, inv_std = (torch.from_numpy(np.array(v, np.float32))
                              for v in centering)
    d = activation_dim or int(mean.shape[-1])
    scale = inv_std if whiten else torch.ones_like(inv_std)
    n_dict = int(d * cfg.learned_dict_ratio)
    ens = _build(FunctionalTiedSAE, "centered_l1_range", cfg, cfg.seed,
                 lambda g, l1: FunctionalTiedSAE.init(
                     g, d, n_dict, l1_alpha=float(l1), rotation=rot.cpu(),
                     translation=mean.cpu(), scaling=scale.cpu()),
                 l1s, inits, device)
    hypers = [{"l1_alpha": float(l1), "dict_size": n_dict, "tied": True,
               "centered": True, "whitened": whiten} for l1 in l1s]
    return [(ens, hypers, "centered_l1_range")]


def _simple_grid_experiment(sig, name: str, cfg: EnsembleArgs, l1s, d,
                            inits, device, init_kwargs=None,
                            hyper_key: str = "l1_alpha"):
    """The one-signature grid experiments below: one member per value."""
    n_dict = int(d * cfg.learned_dict_ratio)
    group = _group(sig, name, cfg,
                   lambda g, l1: sig.init(g, d, n_dict, float(l1),
                                          **(init_kwargs or {})),
                   l1s, inits, device, adam_eps=cfg.adam_epsilon,
                   sentinel=_sentinel(cfg))
    hypers = [{hyper_key: float(l1), "dict_size": n_dict} for l1 in l1s]
    return [(group, hypers, name)]


def reverse_l1_range_experiment(cfg: EnsembleArgs, mesh=None,
                                l1_range: Optional[Sequence[float]] = None,
                                activation_dim: Optional[int] = None,
                                inits: Optional[dict] = None, device=None):
    """A ReverseSAE (bias-subtracting decode) sweep."""
    from sparse_coding_tpu_torch.models.sae import FunctionalReverseSAE

    device = _placement(mesh, device)
    l1s = list(l1_range if l1_range is not None else DEFAULT_L1_RANGE)
    return _simple_grid_experiment(
        FunctionalReverseSAE, "reverse_l1_range", cfg, l1s,
        activation_dim or _activation_dim(cfg), inits, device)


def positive_l1_range_experiment(cfg: EnsembleArgs, mesh=None,
                                 l1_range: Optional[Sequence[float]] = None,
                                 activation_dim: Optional[int] = None,
                                 inits: Optional[dict] = None, device=None):
    """A nonnegative-dictionary, shifted-input tied SAE sweep."""
    from sparse_coding_tpu_torch.models.positive import (
        FunctionalPositiveTiedSAE,
    )

    device = _placement(mesh, device)
    l1s = list(l1_range if l1_range is not None else DEFAULT_L1_RANGE)
    return _simple_grid_experiment(
        FunctionalPositiveTiedSAE, "positive_l1_range", cfg, l1s,
        activation_dim or _activation_dim(cfg), inits, device)


def semilinear_l1_range_experiment(cfg: EnsembleArgs, mesh=None,
                                   l1_range: Optional[Sequence[float]] = None,
                                   activation_dim: Optional[int] = None,
                                   inits: Optional[dict] = None,
                                   device=None):
    """A two-layer-encoder SemiLinearSAE sweep."""
    from sparse_coding_tpu_torch.models.semilinear import SemiLinearSAE

    device = _placement(mesh, device)
    l1s = list(l1_range if l1_range is not None else DEFAULT_L1_RANGE)
    return _simple_grid_experiment(
        SemiLinearSAE, "semilinear_l1_range", cfg, l1s,
        activation_dim or _activation_dim(cfg), inits, device)


def rica_experiment(cfg: EnsembleArgs, mesh=None,
                    sparsity_range: Optional[Sequence[float]] = None,
                    activation_dim: Optional[int] = None,
                    inits: Optional[dict] = None, device=None):
    """A RICA (reconstruction ICA) sweep over the sparsity coefficient."""
    from sparse_coding_tpu_torch.models.rica import RICA

    device = _placement(mesh, device)
    coefs = list(sparsity_range if sparsity_range is not None
                 else np.logspace(-4, -2, 8))
    return _simple_grid_experiment(
        RICA, "rica", cfg, coefs, activation_dim or _activation_dim(cfg),
        inits, device, hyper_key="sparsity_coef")


EXPERIMENTS = {
    "dense_l1_range": dense_l1_range_experiment,
    "tied_vs_not": tied_vs_not_experiment,
    "topk": topk_experiment,
    "dict_ratio": dict_ratio_experiment,
    "zero_l1_baseline": zero_l1_baseline_experiment,
    "long_l1_range": long_l1_range_experiment,
    "residual_denoising": residual_denoising_experiment,
    "centered_l1_range": centered_l1_range_experiment,
    "reverse_l1_range": reverse_l1_range_experiment,
    "positive_l1_range": positive_l1_range_experiment,
    "semilinear_l1_range": semilinear_l1_range_experiment,
    "rica": rica_experiment,
}


def get_experiment(name: str):
    return EXPERIMENTS[name]
