"""Core dictionary metrics (the JAX package's ``metrics/core.py``):
reconstruction quality, sparsity and activity, dictionary similarity
(MMCS, representedness, Hungarian matching), streaming feature moments
over an array or a chunk store, geometry, and the supervised probes.

Every metric takes a ``LearnedDict`` and tensors on the dict's device.
The dataset-scale ones (``n_ever_active``, ``calc_moments_streaming``,
``streaming_eval_sweep``) also take a store — flat or sharded, anything
with ``chunk_reader`` — and stream it one chunk at a time onto the dict's
device, in fixed-size batches, rows carried across chunk boundaries.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.models.learned_dict import (
    LearnedDict,
    normalize_rows,
)
from sparse_coding_tpu_torch.models.sae import clip
from sparse_coding_tpu_torch.resilience.errors import UndersizedInputError

Tensor = torch.Tensor


# -- reconstruction quality --------------------------------------------------

def fraction_variance_unexplained(model: LearnedDict,
                                  batch: Tensor) -> Tensor:
    """FVU = E‖x − x̂‖² / E‖x − x̄‖²."""
    x_hat = model.predict(batch)
    residuals = torch.mean(torch.square(batch - x_hat))
    total = torch.mean(torch.square(batch - batch.mean(dim=0)))
    return residuals / total


def fvu_top_activating(model: LearnedDict, batch: Tensor,
                       n_top: int = 2) -> tuple[Tensor, Tensor]:
    """FVU split into the ``n_top`` features of largest mean activation
    and the rest, compared in the centered space (the reference's
    choice)."""
    c = model.encode(model.center(batch))
    # a stable sort, as jnp.argsort's: ties keep index order
    order = torch.argsort(-c.mean(dim=0), stable=True)
    is_top = torch.argsort(order, stable=True) < n_top
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    x_hat_top = model.center(model.decode(torch.where(is_top, c, zero)))
    x_hat_rest = model.center(model.decode(torch.where(is_top, zero, c)))
    variance = torch.mean(torch.square(batch - batch.mean(dim=0)))
    return (torch.mean(torch.square(batch - x_hat_top)) / variance,
            torch.mean(torch.square(batch - x_hat_rest)) / variance)


def r_squared(model: LearnedDict, batch: Tensor) -> Tensor:
    return 1.0 - fraction_variance_unexplained(model, batch)


# -- sparsity / activity -----------------------------------------------------

def mean_nonzero_activations(model: LearnedDict, batch: Tensor) -> Tensor:
    """Per-feature firing frequency."""
    c = model.encode(model.center(batch))
    return (c != 0).to(torch.float32).mean(dim=0)


def mean_l0(model: LearnedDict, batch: Tensor) -> Tensor:
    """Mean active features per sample."""
    c = model.encode(model.center(batch))
    return (c != 0).to(torch.float32).sum(dim=-1).mean()


def calc_feature_n_active(codes: Tensor) -> Tensor:
    """How many rows activate each feature."""
    return (codes != 0).sum(dim=0)


def _device_of(model: LearnedDict) -> torch.device:
    return model.get_learned_dict().device


def iter_slabs(activations, batch_size: int, device=None):
    """The dataset-scale metrics' input as device slabs: an in-RAM array
    or tensor is one slab; a store (anything with ``chunk_reader``)
    streams chunk by chunk, each slab a whole number of batches, the
    leftover rows carried on the host into the next chunk — so a store
    yields exactly the rows, in order, that the array of its
    concatenated chunks would; only the dataset's final remainder is
    dropped."""
    if not hasattr(activations, "chunk_reader"):
        yield torch.as_tensor(activations, dtype=torch.float32,
                              device=device)
        return
    left = None
    for chunk in activations.chunk_reader(range(activations.n_chunks)):
        if chunk is None:  # a quarantined hole
            continue
        arr = np.asarray(chunk, dtype=np.float32)
        if left is not None and left.shape[0]:
            arr = np.concatenate([left, arr], axis=0)
        n = (arr.shape[0] // batch_size) * batch_size
        left = arr[n:].copy()  # not a view: do not pin the whole chunk
        if n:
            yield torch.from_numpy(arr[:n]).to(device)


def _batches(slab: Tensor, batch_size: int):
    n = (slab.shape[0] // batch_size) * batch_size
    return slab[:n].reshape(-1, batch_size, slab.shape[-1])


def _moment_terms(c: Tensor) -> tuple:
    mean = c.mean(dim=0)
    return ((mean != 0).to(torch.float32), mean, (c ** 2).mean(dim=0),
            (c ** 3).mean(dim=0), (c ** 4).mean(dim=0))


def _scan(model: LearnedDict, activations, batch_size: int,
          counts: bool, moments: bool):
    """One pass over the input, one encode a batch: the ever-active counts
    and/or the raw-moment sums, and the number of batches."""
    n = model.n_feats
    dev = _device_of(model)
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    sums = [torch.zeros(n, dtype=torch.float32, device=dev)
            for _ in range(5)]
    k = 0
    with torch.no_grad():
        for slab in iter_slabs(activations, batch_size, dev):
            for batch in _batches(slab, batch_size):
                c = model.encode(batch)
                if counts:
                    count += calc_feature_n_active(c)
                if moments:
                    for acc, term in zip(sums, _moment_terms(c)):
                        acc += term
                k += 1
    return count, tuple(sums), k


def _finalize_moments(carry, k: int):
    """Raw-moment sums → (times_active, mean, var, skew, kurtosis, m4),
    population variance m2 − mean². No full batch (a dataset smaller than
    ``batch_size``) raises :class:`UndersizedInputError`: the moments
    would be NaN."""
    if k == 0:
        raise UndersizedInputError(
            "no full batch was consumed (dataset smaller than batch_size); "
            "moment statistics would be NaN — use a batch_size <= the row "
            "count")
    times_active, m1, m2, m3, m4 = carry
    mean, m2, m3, m4 = m1 / k, m2 / k, m3 / k, m4 / k
    var = m2 - mean ** 2
    skew = m3 / clip(var ** 1.5, 1e-8)
    kurtosis = m4 / clip(var ** 2, 1e-8)
    return times_active, mean, var, skew, kurtosis, m4


def n_ever_active(model: LearnedDict, activations, batch_size: int = 1000,
                  threshold: int = 10) -> int:
    """Features active more than ``threshold`` times over a dataset (an
    array or a store), in batches of ``batch_size``."""
    counts, _, _ = _scan(model, activations, batch_size, True, False)
    return int((counts > threshold).sum())


def calc_moments_streaming(model: LearnedDict, activations,
                           batch_size: int = 1000):
    """Per-feature (times_active, mean, var, skew, kurtosis, m4) over a
    dataset (an array or a store), from per-batch raw moments."""
    _, sums, k = _scan(model, activations, batch_size, False, True)
    return _finalize_moments(sums, k)


def streaming_eval_sweep(model: LearnedDict, activations,
                         batch_size: int = 1000, threshold: int = 10):
    """``n_ever_active`` and ``calc_moments_streaming`` in one pass over
    the dataset."""
    counts, sums, k = _scan(model, activations, batch_size, True, True)
    return int((counts > threshold).sum()), _finalize_moments(sums, k)


# -- dictionary similarity ---------------------------------------------------

def mcs_duplicates(ground: LearnedDict, model: LearnedDict) -> Tensor:
    """Max cosine similarity of each model atom to any ground atom."""
    sims = model.get_learned_dict() @ ground.get_learned_dict().T
    return sims.max(dim=-1).values


def mmcs(model: LearnedDict, model2: LearnedDict) -> Tensor:
    """Mean max cosine similarity of ``model``'s atoms to ``model2``'s."""
    return mcs_duplicates(model2, model).mean()


def mcs_to_fixed(model: LearnedDict, truth: Tensor) -> Tensor:
    """Max cosine similarity of each model atom to a fixed, normalized
    ground-truth dictionary."""
    sims = model.get_learned_dict() @ truth.T
    return sims.max(dim=-1).values


def mmcs_to_fixed(model: LearnedDict, truth: Tensor) -> Tensor:
    return mcs_to_fixed(model, truth).mean()


def mmcs_from_list(dicts: Sequence[LearnedDict]) -> Tensor:
    """Symmetric pairwise MMCS matrix (ones on the diagonal)."""
    n = len(dicts)
    out = torch.eye(n, dtype=torch.float32)
    for i in range(n):
        for j in range(i):
            out[i, j] = out[j, i] = float(mmcs(dicts[i], dicts[j]))
    return out


def representedness(features: Tensor, model: LearnedDict) -> Tensor:
    """How well each ground-truth feature is represented: its max cosine
    similarity to any atom."""
    sims = features @ model.get_learned_dict().T
    return sims.max(dim=-1).values


def hungarian_mcs(smaller: Tensor, larger: Tensor) -> Tensor:
    """One-to-one matched cosine similarities between a smaller and a
    larger dictionary (``scipy.optimize.linear_sum_assignment`` on the
    host)."""
    from scipy.optimize import linear_sum_assignment

    smaller, larger = (torch.as_tensor(v, dtype=torch.float32)
                       for v in (smaller, larger))
    sims = (normalize_rows(smaller) @ normalize_rows(larger).to(
        smaller.device).T).cpu().numpy()
    row, col = linear_sum_assignment(1.0 - sims)
    return torch.from_numpy(sims[row, col])


def mmcs_with_larger_grid(learned_dict_grid: Sequence[Sequence[Tensor]],
                          threshold: float = 0.9):
    """For an [n_l1, n_sizes] grid of dictionaries, each matched to the
    next larger one: (mean MCS grid, % of features above ``threshold``,
    the per-cell similarity arrays)."""
    n_l1, n_sizes = len(learned_dict_grid), len(learned_dict_grid[0])
    av = np.zeros((n_l1, n_sizes))
    above = np.zeros((n_l1, n_sizes))
    hists: list[list[Optional[np.ndarray]]] = [[None] * (n_sizes - 1)
                                               for _ in range(n_l1)]
    for i in range(n_l1):
        for j in range(n_sizes - 1):
            sims = hungarian_mcs(learned_dict_grid[i][j],
                                 learned_dict_grid[i][j + 1]).numpy()
            av[i, j] = sims.mean()
            above[i, j] = (sims > threshold).sum() / len(sims) * 100.0
            hists[i][j] = sims
    return av, above, hists


# -- feature statistics ------------------------------------------------------

def feature_moments(codes: Tensor) -> dict[str, Tensor]:
    """Per-feature mean, sample variance, and the reference's uncentered,
    variance-normalized skew and kurtosis."""
    var = codes.var(dim=0, correction=1)
    return {"mean": codes.mean(dim=0), "var": var,
            "skew": (codes ** 3).mean(dim=0) / clip(var ** 1.5, 1e-8),
            "kurtosis": (codes ** 4).mean(dim=0) / clip(var ** 2, 1e-8)}


# -- geometry ----------------------------------------------------------------

def neurons_per_feature(model: LearnedDict) -> Tensor:
    """Mean inverse Simpson index of the |dict| rows."""
    d = model.get_learned_dict()
    d = d / d.abs().sum(dim=-1, keepdim=True)
    return (1.0 / torch.square(d).sum(dim=-1)).mean()


def capacity_per_feature(model: LearnedDict) -> Tensor:
    """Capacity ‖dᵢ‖⁴ / Σⱼ⟨dᵢ,dⱼ⟩² (Scherlis et al. 2022)."""
    d = model.get_learned_dict()
    sq_dots = torch.square(d @ d.T)
    return torch.diagonal(sq_dots) / sq_dots.sum(dim=-1)


# -- supervised probes -------------------------------------------------------

def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, Tensor) else np.asarray(v)


def logistic_regression_auroc(activations, labels, **kwargs) -> float:
    """AUROC of a logistic-regression probe (sklearn, imported here: a
    host without it raises ImportError)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import roc_auc_score

    x, y = _host(activations), _host(labels)
    clf = LogisticRegression(**kwargs).fit(x, y)
    return float(roc_auc_score(y, clf.decision_function(x)))


def ridge_regression_auroc(activations, labels, **kwargs) -> float:
    """AUROC of a ridge-classifier probe (sklearn, imported here)."""
    from sklearn.linear_model import RidgeClassifier
    from sklearn.metrics import roc_auc_score

    x, y = _host(activations), _host(labels)
    clf = RidgeClassifier(**kwargs).fit(x, y)
    return float(roc_auc_score(y, clf.decision_function(x)))
