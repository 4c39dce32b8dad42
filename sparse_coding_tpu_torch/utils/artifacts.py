"""Learned-dictionary artifact files (the JAX package's
``utils/artifacts.py`` format).

``learned_dicts.pkl`` is a pickled list of records ``{cls, fields (numpy),
static, hyperparams}``: ``cls`` is the LearnedDict class name, ``fields``
its array-valued fields as numpy arrays (a dict of tensors, LISTA's
stacked layers, as a dict of arrays), ``static`` its non-array fields
(None included). Nothing of torch or jax is pickled, so a file written by
either side loads on the other.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.resilience.atomic import atomic_pickle_dump
from sparse_coding_tpu_torch.utils.tree import flatten_tree, map_tree

ARTIFACT_NAME = "learned_dicts.pkl"


def _dict_registry() -> dict[str, type]:
    """Every LearnedDict subclass registers when its module is imported:
    the model zoo and the big SAE's dict."""
    import sparse_coding_tpu_torch.models  # noqa: F401
    import sparse_coding_tpu_torch.train.big_sae  # noqa: F401
    from sparse_coding_tpu_torch.models.learned_dict import (
        LEARNED_DICT_REGISTRY,
    )

    return dict(LEARNED_DICT_REGISTRY)


def _is_tensor_tree(v) -> bool:
    leaves = flatten_tree(v).values()
    return bool(leaves) and all(isinstance(x, torch.Tensor) for x in leaves)


def save_learned_dicts(dicts: Sequence[tuple[Any, dict]],
                       path: str | Path) -> None:
    """dicts: [(LearnedDict, hyperparams), ...]."""
    records = []
    for d, hyper in dicts:
        fields, static = {}, {}
        for f in dataclasses.fields(d):
            v = getattr(d, f.name)
            if _is_tensor_tree(v):
                fields[f.name] = map_tree(
                    lambda t: t.detach().cpu().numpy(), v)
            else:
                static[f.name] = v
        records.append({"cls": type(d).__name__, "fields": fields,
                        "static": static, "hyperparams": dict(hyper)})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_pickle_dump(path, records)


def load_learned_dicts(path: str | Path,
                       select: Optional[Callable[[dict], bool]] = None,
                       skip_diverged: bool = False, device="cpu",
                       ) -> list[tuple[Any, dict]]:
    """Records back as (LearnedDict, hyperparams); ``select`` filters on
    hyperparams before any tensor is built, ``skip_diverged`` drops
    members tagged ``diverged=True``. Unpickle only files this program
    (or the JAX package) wrote."""
    with Path(path).open("rb") as fh:
        records = pickle.load(fh)
    registry = _dict_registry()
    out = []
    for rec in records:
        if skip_diverged and rec["hyperparams"].get("diverged"):
            continue
        if select is not None and not select(rec["hyperparams"]):
            continue
        cls = registry.get(rec["cls"])
        if cls is None:
            raise NotImplementedError(
                f"learned dict class {rec['cls']!r} is not ported yet")
        kwargs = {k: map_tree(lambda a: torch.as_tensor(np.asarray(a),
                                                    device=device), v)
                  for k, v in rec["fields"].items()}
        kwargs.update(rec["static"])
        out.append((cls(**kwargs), rec["hyperparams"]))
    return out
