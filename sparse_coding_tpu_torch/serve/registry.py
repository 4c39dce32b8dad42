"""Multi-dict model registry for the serving engine (the port's copy of the
JAX package's ``serve/registry.py``).

Loads trained dictionaries from both artifact families — native
``learned_dicts.pkl`` (utils/artifacts.py, written by the port or the JAX
package) and reference torch ``learned_dicts.pt`` (utils/ref_interop.py,
through its allowlisted unpickler) — into a name → entry table the engine
captures bucket programs against. Registration is the trust and shape
boundary: every dict passes a signature audit (uniform
encode/decode/predict shapes, models/learned_dict.py contract) before it
becomes servable, and batch-coupled dicts (AddedNoise) are rejected
because the micro-batcher coalesces rows across requests.

Every entry lives on the registry's device: ``device=None`` means the
card (``resolve_device``); pass ``device="cpu"`` to serve on the CPU.

``register_stack`` builds the multi-dict path ("Ensembling Sparse
Autoencoders", PAPERS.md): N structurally identical dicts stack into one
tree with a leading member axis (``utils/trees.py stack_trees``), and the
engine scores one activation batch against all N in one program.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.models.learned_dict import LearnedDict
from sparse_coding_tpu_torch.utils.tree import map_tree
from sparse_coding_tpu_torch.utils.trees import _leaves, stack_trees


@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    name: str
    tree: Any  # LearnedDict; stacked (leading member axis) if n_stack
    cls_name: str
    n_stack: int | None  # None = single dict, int = stacked member count
    d_activation: int
    n_feats: int
    hyperparams: Any  # dict (single) or list[dict] (stack)

    @property
    def is_stack(self) -> bool:
        return self.n_stack is not None


def _layout(ld: LearnedDict) -> list:
    """The dict's fields as a comparable layout: each tensor leaf's
    shape and dtype, every other value as it is (None, a TopK ``k``)."""
    out: list = []

    def visit(v):
        out.append((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                   else ("static", v))
        return v

    map_tree(visit, ld, into_dataclasses=True)
    return out


def audit_signature(ld: LearnedDict) -> tuple[int, int]:
    """Enforce the uniform inference contract on a candidate dict: encode
    maps [b, d] → [b, n_feats], decode maps codes back to [b, d], predict
    preserves [b, d]. Runs on a 2-row zero batch on the dict's device (a
    startup-time cost, not a hot-path one) and returns (d_activation,
    n_feats)."""
    d = int(ld.activation_size)
    n = int(ld.n_feats)
    leaves = _leaves(ld)
    x = torch.zeros((2, d), dtype=torch.float32,
                    device=leaves[0].device if leaves else "cpu")
    c = ld.encode(x)
    if tuple(c.shape) != (2, n):
        raise TypeError(
            f"{type(ld).__name__}.encode([2, {d}]) returned shape "
            f"{tuple(c.shape)}, expected (2, {n}) — violates the uniform "
            "LearnedDict signature (models/learned_dict.py)")
    xr = ld.decode(c)
    if tuple(xr.shape) != (2, d):
        raise TypeError(
            f"{type(ld).__name__}.decode([2, {n}]) returned shape "
            f"{tuple(xr.shape)}, expected (2, {d})")
    p = ld.predict(x)
    if tuple(p.shape) != (2, d):
        raise TypeError(
            f"{type(ld).__name__}.predict([2, {d}]) returned shape "
            f"{tuple(p.shape)}, expected (2, {d})")
    return d, n


class ModelRegistry:
    """Name → :class:`RegistryEntry` table on one device. Mutations before
    ``ServingEngine.warmup()`` are free; dicts registered after warmup are
    served, but their first query pays an on-the-fly capture (counted by
    the engine's recompile metric)."""

    def __init__(self, audit: bool = True, device=None):
        self._audit = audit
        self.device = resolve_device(device)
        self._entries: dict[str, RegistryEntry] = {}

    # -- registration --------------------------------------------------------

    def register(self, name: str, ld: LearnedDict,
                 hyperparams: dict | None = None) -> RegistryEntry:
        if name in self._entries:
            raise ValueError(f"model {name!r} already registered")
        if not isinstance(ld, LearnedDict):
            raise TypeError(f"{name!r}: expected a LearnedDict, got "
                            f"{type(ld).__name__}")
        if type(ld).batch_coupled:
            raise TypeError(
                f"{name!r}: {type(ld).__name__} is batch_coupled (encode "
                "depends on the whole batch) — coalesced serving would "
                "change per-request results; serve it out-of-band instead")
        ld = ld.to(self.device)
        if self._audit:
            d, n = audit_signature(ld)
        else:
            d, n = int(ld.activation_size), int(ld.n_feats)
        entry = RegistryEntry(name=name, tree=ld,
                              cls_name=type(ld).__name__, n_stack=None,
                              d_activation=d, n_feats=n,
                              hyperparams=dict(hyperparams or {}))
        self._entries[name] = entry
        return entry

    def register_stack(self, name: str, dicts: Sequence[LearnedDict],
                       hyperparams: Sequence[dict] | None = None
                       ) -> RegistryEntry:
        """Register N structurally identical dicts as ONE stacked entry:
        same class, same static fields, same leaf shapes and dtypes."""
        if not dicts:
            raise ValueError("register_stack needs at least one dict")
        if name in self._entries:
            raise ValueError(f"model {name!r} already registered")
        head = dicts[0]
        for ld in dicts:
            if type(ld) is not type(head):
                raise TypeError(
                    f"{name!r}: mixed classes in stack "
                    f"({type(head).__name__} vs {type(ld).__name__})")
            if type(ld).batch_coupled:
                raise TypeError(f"{name!r}: {type(ld).__name__} is "
                                "batch_coupled and cannot be served")
            if _layout(ld) != _layout(head):
                raise TypeError(f"{name!r}: stack members differ in "
                                "structure or leaf shapes")
        members = [ld.to(self.device) for ld in dicts]
        if self._audit:
            d, n = audit_signature(members[0])
        else:
            d, n = int(head.activation_size), int(head.n_feats)
        entry = RegistryEntry(
            name=name, tree=stack_trees(members),
            cls_name=type(head).__name__, n_stack=len(dicts),
            d_activation=d, n_feats=n,
            hyperparams=[dict(h) for h in hyperparams] if hyperparams
            else [{} for _ in dicts])
        self._entries[name] = entry
        return entry

    # -- artifact loading ----------------------------------------------------

    def load_native(self, path: str | Path, prefix: str | None = None,
                    select: Callable[[dict], bool] | None = None
                    ) -> list[str]:
        """Load a native ``learned_dicts.pkl`` sweep artifact onto the
        registry's device; each record registers as ``{prefix}/{i}``.
        ``select`` filters by hyperparams before reconstruction
        (utils/artifacts.py::load_learned_dicts)."""
        from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

        pairs = load_learned_dicts(path, select=select, device=self.device)
        return self._register_pairs(pairs, prefix or Path(path).stem)

    def load_reference(self, path: str | Path,
                       prefix: str | None = None) -> list[str]:
        """Load a reference torch ``learned_dicts.pt`` through the
        allowlisted unpickler (utils/ref_interop.py) onto the registry's
        device and register each converted dict as ``{prefix}/{i}``."""
        from sparse_coding_tpu_torch.utils.ref_interop import (
            load_reference_learned_dicts,
        )

        pairs = load_reference_learned_dicts(path, device=self.device)
        return self._register_pairs(pairs, prefix or Path(path).stem)

    def _register_pairs(self, pairs, prefix: str) -> list[str]:
        names = []
        for i, (ld, hyper) in enumerate(pairs):
            name = f"{prefix}/{i}"
            self.register(name, ld, hyper)
            names.append(name)
        return names

    # -- lookup --------------------------------------------------------------

    def get(self, name: str) -> RegistryEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"model {name!r} not registered "
                           f"(have: {sorted(self._entries)})") from None

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)
