"""Stack and unstack trees of tensors along a leading member axis (the
JAX package's ``utils/trees.py``), on ``utils/tree.py``'s walker.

A tree is a tensor, a dict, list or tuple of trees, or a dataclass
instance (a ``LearnedDict``) whose fields are trees. Tensors are the
leaves that stack; any other value is static: it must be equal across the
trees being stacked and is kept as it is (a TopK dict's ``k``), as a JAX
pytree keeps its non-pytree fields.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from sparse_coding_tpu_torch.utils.tree import map_tree

Tree = Any


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor],
                 tree: Tree) -> Tree:
    return map_tree(lambda v: fn(v) if isinstance(v, torch.Tensor) else v,
                    tree, into_dataclasses=True)


def _leaves(tree: Tree) -> list[torch.Tensor]:
    found: list[torch.Tensor] = []
    _map_tensors(lambda t: found.append(t) or t, tree)
    return found


def _stack_leaf(first, *rest):
    if isinstance(first, torch.Tensor):
        return torch.stack((first, *rest), dim=0)
    for other in rest:
        if other != first:
            raise ValueError(f"static fields differ across trees: "
                             f"{first!r} vs {other!r}")
    return first


def stack_trees(trees: Sequence[Tree]) -> Tree:
    """Stack a list of structurally identical trees along a new leading
    axis."""
    if not trees:
        raise ValueError("cannot stack an empty list of trees")
    return map_tree(_stack_leaf, *trees, into_dataclasses=True)


def unstack_tree(tree: Tree) -> list[Tree]:
    """Invert :func:`stack_trees`: split the leading axis into a list of
    trees."""
    return [tree_index(tree, i) for i in range(tree_len(tree))]


def tree_index(tree: Tree, i: int) -> Tree:
    """Select member ``i`` of a stacked tree (views of its leaves)."""
    return _map_tensors(lambda leaf: leaf[i], tree)


def tree_len(tree: Tree) -> int:
    """Member count of a stacked tree (its first leaf's leading axis)."""
    leaves = _leaves(tree)
    return int(leaves[0].shape[0]) if leaves else 0


def tree_bytes(tree: Tree) -> int:
    """Total bytes across all leaves."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(tree))


def tree_cast(tree: Tree, dtype) -> Tree:
    """Cast all floating-point leaves to ``dtype``."""
    return _map_tensors(
        lambda leaf: leaf.to(dtype) if leaf.is_floating_point() else leaf,
        tree)
