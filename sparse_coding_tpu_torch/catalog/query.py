"""Catalog query ops (the JAX package's ``catalog/query.py``): batched
top-k decoder-row similarity and the union/vote aggregation over a
stacked multi-dict tree ("Ensembling Sparse Autoencoders",
arXiv:2505.16077). They run where their inputs live, and the serving
engine captures them in CUDA graphs (serve/engine.py), so their shapes do
not depend on the data.

:func:`top_k` is ``jax.lax.top_k`` in one fixed-shape ``torch.topk``:
each fp32 value becomes its order-preserving int32 key, packed above the
reversed index into one int64, so every key is unique and equal values
come out lowest index first, as ``lax.top_k`` orders them (it ranks
+0.0 above −0.0, as the int keys do). :func:`neighbor_topk_plain` keeps
a stable full sort as the plain version it is held against.

The top-k result is packed into one array ``[rows, 2k]`` (similarity
values, then neighbor indices cast to the value dtype);
:func:`unpack_neighbors` splits it back on the host. Index precision is
exact for any real dictionary (n_feats < 2**24).
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_coding_tpu_torch.utils.trees import tree_index, tree_len


_LOW_BITS = 1 << 32


def order_key(values: torch.Tensor) -> torch.Tensor:
    """The int32 key of each fp32 value whose signed order is the values'
    total order (−0.0 below +0.0): negative floats flip their low 31
    bits."""
    bits = values.contiguous().view(torch.int32)
    return torch.bitwise_xor(bits, torch.bitwise_and(bits >> 31, 0x7FFFFFFF))


def top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest fp32 ``values`` over the last axis, largest
    first, and their int64 indices; equal values lowest index first, as
    ``jax.lax.top_k`` orders them. One ``torch.topk`` of a fixed shape on
    unique packed keys: no sort of the whole axis and no candidate set
    whose size depends on the data."""
    if values.dtype != torch.float32:
        raise TypeError(f"top_k packs fp32 keys; got {values.dtype}")
    n = values.shape[-1]
    rev = (n - 1) - torch.arange(n, device=values.device, dtype=torch.int64)
    packed = order_key(values).to(torch.int64) * _LOW_BITS + rev
    idx = (n - 1) - torch.remainder(
        torch.topk(packed, k, dim=-1, sorted=True).values, _LOW_BITS)
    return torch.gather(values, -1, idx), idx


def neighbor_topk(ld, x: torch.Tensor, k: int) -> torch.Tensor:
    """Cosine of each query row ``x`` [rows, d] against every (already
    normalized) decoder row, the top ``k`` over the feature axis
    (:func:`top_k`: the largest first, equal values in index order, as
    ``jax.lax.top_k`` orders them). Unit-normalize ``x`` for true
    cosines. Returns the packed [rows, 2k] (values ++ indices) array."""
    sims = x @ ld.get_learned_dict().T
    vals, idx = top_k(sims, k)
    return torch.cat([vals, idx.to(vals.dtype)], dim=-1)


def neighbor_topk_plain(ld, x: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`neighbor_topk` by a stable descending sort of all n
    similarities' :func:`order_key` of a row (the plain version it is
    held against)."""
    sims = x @ ld.get_learned_dict().T
    idx = torch.sort(order_key(sims), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    vals = torch.gather(sims, -1, idx)
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
    """This rank's share of one big dictionary's normalized decoder rows
    [n, d], split over the mesh's feature axis
    (``partition.CATALOG_FEATURE_RULES``: rows over "model", as the big
    SAE's dict rows train), through the placement seam."""
    from sparse_coding_tpu_torch.parallel import partition

    return partition.place_tree(rows, mesh, partition.CATALOG_FEATURE_RULES)
