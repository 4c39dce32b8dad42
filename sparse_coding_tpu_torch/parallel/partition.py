"""Rule-based partition layer: the counterpart of the JAX package's
``parallel/partition.py``, the one home of "which leaf lives where" on the
("model", "data") mesh.

A placement is an ordered rule set — ``(regex, spec)`` pairs matched with
``re.search`` against each leaf's ``/``-joined tree path, first match
wins, 0-d and single-element leaves never split, a leaf no rule covers an
error — and the named rule sets below are the placement vocabulary of the
trainers. A spec is a tuple with one entry per leading dimension: a mesh
axis name splits that dimension over the axis, ``None`` keeps it whole
(the JAX ``PartitionSpec``'s entries, so ``tuple(P("model"))`` equals
:data:`MEMBER`).

One process per device, so "placing" a tree means keeping this rank's
slice of a full tree (:func:`place_tree`, behind the ``partition.place``
fault site) and gathering it back means an all-gather along each split
dimension (:func:`gather_tree`). The serving rule sets wait for the
port's serving layer.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import torch

from sparse_coding_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)

register_fault_site("partition.place",
                    "partition.place_tree — immediately before this rank "
                    "keeps its slice of a tree per the resolved partition "
                    "rules (the mesh placement seam: ensemble state, "
                    "big-SAE state, catalog rows)")

Spec = tuple

# -- the spec vocabulary ------------------------------------------------------

MEMBER: Spec = (MODEL_AXIS,)            # stacked [N, ...] member axis
BATCH: Spec = (DATA_AXIS,)              # activation rows [B, d]
STACKED_BATCH: Spec = (None, DATA_AXIS)  # [K, B, d] scan-window stacks
REPLICATED: Spec = ()
FEATURE_ROWS: Spec = (MODEL_AXIS, None)  # [n, d] feature-axis split
FEATURE_COLS: Spec = (None, MODEL_AXIS)  # [d, n] transposed feature split

Rules = Sequence[tuple[str, Spec]]

# -- named rule sets ----------------------------------------------------------

# Stacked ensemble training state: every leaf has a leading [N] member axis
# split over "model"; scalars (the step counter) replicate.
ENSEMBLE_STATE_RULES: Rules = ((r".*", MEMBER),)

# A big SAE's features over "model": dict rows, encoder columns,
# per-feature vectors; the centering replicates.
BIG_SAE_PARAM_RULES: Rules = (
    (r"(^|/)dict$", FEATURE_ROWS),
    (r"(^|/)encoder$", FEATURE_COLS),
    (r"(^|/)threshold$", MEMBER),
    (r"(^|/)centering$", REPLICATED),
)

# A big single dict's normalized decoder rows [n, d] for catalog queries,
# split as the big SAE's dict rows train.
CATALOG_FEATURE_RULES: Rules = ((r".*", FEATURE_ROWS),)

# The whole big-SAE state: the param rules (matching the Adam moments by
# name), per-feature activation totals over "model", and everything else
# (the worst-example tracker, the step counters) replicated.
BIG_SAE_STATE_RULES: Rules = BIG_SAE_PARAM_RULES + (
    (r"(^|/)c_totals$", MEMBER),
    (r".*", REPLICATED),
)

# Grouped-sweep state: member leaves over "model", the pooled-store
# statistics replicated.
GROUP_STATE_RULES: Rules = (
    (r"(^|/)(center|pooled_stats|group_stats)($|/)", REPLICATED),
    (r".*", MEMBER),
)


def batch_spec(stacked: bool = False) -> Spec:
    """The activation-batch spec: rows over "data" ([B, d], or [K, B, d]
    windows when ``stacked``)."""
    return STACKED_BATCH if stacked else BATCH


# -- trees --------------------------------------------------------------------


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] over the array leaves, '/'-joined paths
    ("params/encoder", "mu/dict") in traversal order; other leaves (a
    dataclass's flags and names) are skipped."""
    kids = _children(tree)
    if kids is None:
        return [(prefix.rstrip("/"), tree)] if _is_leaf(tree) else []
    out = []
    for k, v in kids:
        out.extend(tree_paths(v, f"{prefix}{k}/"))
    return out


def _map_paths(fn, tree, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        return fn(prefix.rstrip("/"), tree) if _is_leaf(tree) else tree
    mapped = [(k, _map_paths(fn, v, f"{prefix}{k}/")) for k, v in kids]
    if isinstance(tree, dict):
        return dict(mapped)
    if isinstance(tree, (list, tuple)):
        return type(tree)(v for _, v in mapped)
    return dataclasses.replace(tree, **dict(mapped))


def _rule_spec(rules: Rules, path: str, shape) -> Spec:
    for pattern, spec in rules:
        if re.search(pattern, path) is not None:
            return tuple(spec)
    raise ValueError(
        f"no partition rule matches leaf {path!r} (shape {tuple(shape)}); "
        "extend the rule set — placement must be total")


def spec_for(rules: Rules, path: str, shape) -> Spec:
    """The resolved spec of one leaf of the FULL tree: 0-d and
    single-element leaves replicate, else the first matching rule's."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0 or all(s == 1 for s in shape):
        return REPLICATED
    return _rule_spec(rules, path, shape)


def match_partition_rules(rules: Rules, tree: Any) -> Any:
    """The tree with each array leaf replaced by its resolved spec (see
    :func:`spec_for`)."""
    return _map_paths(lambda path, leaf: spec_for(rules, path, leaf.shape),
                      tree)


def _slice_leaf(leaf, spec: Spec, mesh: Mesh, path: str):
    out = leaf
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size, idx = mesh.shape[axis], mesh.coords[axis]
        if out.shape[dim] % size:
            raise ValueError(f"leaf {path!r} dimension {dim} of size "
                             f"{out.shape[dim]} is not divisible by mesh "
                             f"axis {axis!r} of size {size}")
        step = out.shape[dim] // size
        out = out.narrow(dim, idx * step, step)
    return out


def place_tree(tree: Any, mesh: Mesh, rules: Rules,
               site: str = "partition.place") -> Any:
    """This rank's slice of a FULL tree per its resolved rules, each leaf
    a contiguous tensor on ``mesh.device`` — THE placement seam (fault
    site ``partition.place``, hit once a placement). Every rank calls it
    with the same full tree."""
    fault_point(site)

    def place(path, leaf):
        t = torch.as_tensor(leaf)
        spec = spec_for(rules, path, t.shape)
        return _slice_leaf(t, spec, mesh, path).to(
            mesh.device).contiguous()

    return _map_paths(place, tree)


def gather_tree(tree: Any, mesh: Mesh, rules: Rules) -> Any:
    """The inverse of :func:`place_tree`: the full tree from every rank's
    slices (a collective: every rank calls it). A leaf's spec comes from
    the rules on its gathered shape, so a split member axis of one member
    a shard still gathers."""

    def gather(path, leaf):
        if leaf.dim() == 0:
            return leaf.clone()
        spec = _rule_spec(rules, path, leaf.shape)
        full = [s * (mesh.shape[a] if a is not None else 1)
                for s, a in zip(leaf.shape, spec + (None,) * leaf.dim())]
        if all(s == 1 for s in full):
            return leaf.clone()
        out = leaf
        for dim, axis in enumerate(spec):
            if axis is not None:
                out = mesh.all_gather(out, axis, dim=dim)
        return out

    return _map_paths(gather, tree)


def place_batch(batch, mesh: Mesh, stacked: bool = False):
    """This rank's rows of a global batch (or of each window of a
    [K, B, d] stack), on ``mesh.device``."""
    t = torch.as_tensor(batch)
    dim = 1 if stacked else 0
    size, idx = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    if t.shape[dim] % size:
        raise ValueError(f"batch size {t.shape[dim]} not divisible by mesh "
                         f"data axis {size}; drop the remainder or pad the "
                         "batch")
    step = t.shape[dim] // size
    return t.narrow(dim, idx * step, step).to(mesh.device).contiguous()


__all__ = [
    "MEMBER", "BATCH", "STACKED_BATCH", "REPLICATED",
    "FEATURE_ROWS", "FEATURE_COLS",
    "ENSEMBLE_STATE_RULES", "BIG_SAE_PARAM_RULES", "BIG_SAE_STATE_RULES",
    "CATALOG_FEATURE_RULES", "GROUP_STATE_RULES",
    "batch_spec", "tree_paths", "spec_for", "match_partition_rules",
    "place_tree", "gather_tree", "place_batch",
]
