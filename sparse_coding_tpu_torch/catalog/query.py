"""Catalog query ops (the JAX package's ``catalog/query.py``): batched
top-k decoder-row similarity and the union/vote aggregation over a
stacked multi-dict tree ("Ensembling Sparse Autoencoders",
arXiv:2505.16077). They run where their inputs live.

The top-k result is packed into one array ``[rows, 2k]`` (similarity
values, then neighbor indices cast to the value dtype);
:func:`unpack_neighbors` splits it back on the host. Index precision is
exact for any real dictionary (n_feats < 2**24).
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_coding_tpu_torch.utils.trees import tree_index, tree_len


def neighbor_topk(ld, x: torch.Tensor, k: int) -> torch.Tensor:
    """Cosine of each query row ``x`` [rows, d] against every (already
    normalized) decoder row, the top ``k`` over the feature axis, the
    largest first; equal values keep index order, as ``jax.lax.top_k``
    orders them (a stable descending sort; ``torch.topk`` promises no
    order among ties). Unit-normalize ``x`` for true cosines. Returns the
    packed [rows, 2k] (values ++ indices) array."""
    sims = x @ ld.get_learned_dict().T
    vals, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return torch.cat([vals, idx.to(vals.dtype)], dim=-1)


def union_vote(ld_stack, x: torch.Tensor) -> torch.Tensor:
    """Every member of a stacked multi-dict tree (``utils/trees.py``
    ``stack_trees``) encodes the same batch; each feature's vote is the
    number of members whose code fires. Member ``i`` encodes from views
    of the stack's leaves at ``i`` (nothing is copied out of the stack).
    Returns [rows, n_feats] vote counts in ``x``'s dtype."""
    votes = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(tree_len(ld_stack)):
        votes = votes + (tree_index(ld_stack, i).encode(x) > 0).to(x.dtype)
    return votes


def unpack_neighbors(packed) -> tuple[np.ndarray, np.ndarray]:
    """Host-side split of the packed neighbor result: [..., 2k] ->
    (values [..., k] float, indices [..., k] int32)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    k = packed.shape[-1] // 2
    return (packed[..., :k],
            packed[..., k:].astype(np.int32))


def place_catalog_rows(rows, mesh):
    """Shard one big dictionary's normalized decoder rows over a mesh's
    feature axis: waits for the port's multi-GPU work."""
    raise NotImplementedError(
        "placing catalog rows on a mesh waits for the port's multi-GPU "
        "work, ROADMAP.md queue 1, item 11")
