"""Trees of tensors: nested dicts, lists and tuples with tensors, arrays
or scalars at the leaves (LISTA's stacked layers, a checkpoint template).
One flattener and one mapper serve the whole port, so every module that
stores or moves such a tree agrees on its keys and nesting."""

from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


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


def map_tree(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every leaf, the nesting kept."""
    items = _children(tree)
    if items is None:
        return fn(tree)
    out = [(k, map_tree(fn, v)) for k, v in items]
    if isinstance(tree, dict):
        return dict(out)
    return type(tree)(v for _, v in out)
