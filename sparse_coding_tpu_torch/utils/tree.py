"""Trees of tensors: nested dicts, lists and tuples with tensors, arrays
or scalars at the leaves (LISTA's stacked layers, a checkpoint template).
One flattener and one mapper serve the whole port, so every module that
stores or moves such a tree agrees on its keys and nesting."""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable


def _children(tree, into_dataclasses: bool = False):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    if (into_dataclasses and dataclasses.is_dataclass(tree)
            and not isinstance(tree, type)):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _child(tree, key):
    return tree[key] if isinstance(tree, (dict, list, tuple)) else getattr(
        tree, key)


def flatten_tree(tree, prefix: str = "") -> dict:
    """The tree's leaves under flat ``"outer/0/inner"`` keys, in
    traversal order (None is a leaf too)."""
    items = _children(tree)
    if items is None:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: dict) -> dict:
    """The inverse of :func:`flatten_tree` for nested dicts, in key
    order."""
    out: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def unflatten_like(template, flat: dict):
    """``template``'s nesting, each leaf replaced by ``flat``'s value
    under its :func:`flatten_tree` key."""
    leaves = iter([flat[k] for k in flatten_tree(template)])
    return map_tree(lambda _: next(leaves), template)


def map_tree(fn: Callable[..., Any], tree, *rest,
             into_dataclasses: bool = False):
    """``fn`` applied to every leaf, the nesting kept; with ``rest``
    (trees of the same nesting), ``fn(leaf, *matching leaves)``.
    ``into_dataclasses`` also walks the fields of dataclass instances (a
    LearnedDict), which come back as copies with the mapped fields set
    (their ``__init__`` is not run again); otherwise they are leaves."""
    items = _children(tree, into_dataclasses)
    if items is None:
        return fn(tree, *rest)
    out = [(k, map_tree(fn, v, *(_child(r, k) for r in rest),
                        into_dataclasses=into_dataclasses))
           for k, v in items]
    if isinstance(tree, dict):
        return dict(out)
    if isinstance(tree, (list, tuple)):
        return type(tree)(v for _, v in out)
    new = copy.copy(tree)
    for k, v in out:
        object.__setattr__(new, k, v)
    return new
