"""Learned-dictionary artifact files (the JAX package's
``utils/artifacts.py`` format).

``learned_dicts.pkl`` is a pickled list of records ``{cls, fields (numpy),
static, hyperparams}``: ``cls`` is the LearnedDict class name, ``fields``
its array-valued fields as numpy arrays (a dict of tensors, LISTA's
stacked layers, as a dict of arrays), ``static`` its non-array fields
(None included). Nothing of torch or jax is pickled, so a file written by
either side loads on the other.

A field that holds learned dicts (``ConcatEnsembleDict.members``) is
where the two sides' files meet objects: the JAX package pickles its
member instances themselves. Here each member is written as a call of
the JAX class by module path (``getattr(import_module(...), name)``,
the port's module path with the JAX package's name), so the JAX loader
builds its own instances; the port never imports that class. Reading,
the unpickler stands in for the JAX package's classes, and each member
becomes the port class of the same name.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
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


_JAX_PACKAGE = "sparse_coding_tpu"
_PORT_PACKAGE = "sparse_coding_tpu_torch"


def _is_dict_tuple(v) -> bool:
    from sparse_coding_tpu_torch.models.learned_dict import LearnedDict

    return (isinstance(v, (tuple, list)) and bool(v)
            and all(isinstance(m, LearnedDict) for m in v))


class _ModuleRef:
    """Pickles as ``importlib.import_module(module)``."""

    def __init__(self, module: str):
        self.module = module

    def __reduce__(self):
        return importlib.import_module, (self.module,)


class _ClassRef:
    """Pickles as the JAX package's class ``name`` in ``module``."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __call__(self, *args, **kwargs):
        raise TypeError("a stand-in for pickling; not callable here")

    def __reduce__(self):
        return getattr, (_ModuleRef(self.module), self.name)


class _MemberCall:
    """Pickles as ``cls(**fields)`` of the JAX package's class of the
    same name as the port dict's, fields as numpy arrays."""

    def __init__(self, d):
        cls = type(d)
        module = _JAX_PACKAGE + cls.__module__[len(_PORT_PACKAGE):]
        self.fn = functools.partial(_ClassRef(module, cls.__name__),
                                    **_record_fields(d, merged=True))

    def __reduce__(self):
        return self.fn, ()


def _record_fields(d, merged: bool = False):
    """A dict's (array fields, static fields); ``merged`` gives one dict."""
    fields, static = {}, {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if _is_tensor_tree(v):
            fields[f.name] = map_tree(lambda t: t.detach().cpu().numpy(), v)
        elif _is_dict_tuple(v):
            fields[f.name] = tuple(_MemberCall(m) for m in v)
        else:
            static[f.name] = v
    return {**fields, **static} if merged else (fields, static)


def save_learned_dicts(dicts: Sequence[tuple[Any, dict]],
                       path: str | Path) -> None:
    """dicts: [(LearnedDict, hyperparams), ...]."""
    records = []
    for d, hyper in dicts:
        fields, static = _record_fields(d)
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
        records = _Unpickler(fh).load()
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
        kwargs = {k: _field(v, registry, device)
                  for k, v in rec["fields"].items()}
        kwargs.update(rec["static"])
        out.append((cls(**kwargs), rec["hyperparams"]))
    return out


class _Foreign:
    """What the unpickler builds for an instance of a JAX package class:
    its attributes, named by ``cls_name``."""

    cls_name = ""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)


@functools.lru_cache(maxsize=None)
def _foreign_class(name: str) -> type:
    return type(name, (_Foreign,), {"cls_name": name})


class _ForeignModule:
    def __init__(self, module: str):
        self.module = module

    def __getattr__(self, name: str):
        return _foreign_class(name)


def _is_jax_module(module: str) -> bool:
    return module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + ".")


def _import_module(module: str):
    if _is_jax_module(module):
        return _ForeignModule(module)
    return importlib.import_module(module)


class _Unpickler(pickle.Unpickler):
    """Plain unpickling, but the JAX package is never imported: its
    classes (and an ``import_module`` of its modules) resolve to
    stand-ins."""

    def find_class(self, module: str, name: str):
        if (module, name) == ("importlib", "import_module"):
            return _import_module
        if _is_jax_module(module):
            return _foreign_class(name)
        return super().find_class(module, name)


def _field(v, registry: dict, device):
    """A record's field as the port's: arrays as tensors on ``device``,
    the JAX package's dict instances as the port's classes."""
    if isinstance(v, (tuple, list)) and any(isinstance(m, _Foreign)
                                            for m in v):
        return type(v)(_field(m, registry, device) for m in v)
    if isinstance(v, _Foreign):
        cls = registry.get(v.cls_name)
        if cls is None:
            raise NotImplementedError(
                f"learned dict class {v.cls_name!r} is not ported yet")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (_field(a, registry, device)
                          if _is_array_tree(a) or isinstance(a, _Foreign)
                          else a)
                      for k, a in vars(v).items() if k in names})
    return map_tree(lambda a: torch.as_tensor(np.asarray(a), device=device),
                    v)


def _is_array_tree(v) -> bool:
    leaves = flatten_tree(v).values()
    return bool(leaves) and all(isinstance(x, (np.ndarray, np.generic))
                                for x in leaves)
