"""Carry members and whole training states across from numpy — e.g. the
JAX package's ``FunctionalTiedSAE.init`` members, or a ``device_get`` of
its ``EnsembleState`` or ``BigSAEState`` — so the port and the reference
start from the same numbers and compute the same trajectory."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.ensemble import EnsembleState, split_buffers
from sparse_coding_tpu_torch.utils.tree import flatten_tree, map_tree


def _tensor(v, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the dtype the port keeps: floating
    leaves become float32, integer leaves int32, bool stays bool (the
    masked family's ``coef_mask``) and bfloat16 stays bfloat16 (the
    half-width Adam moments of ``fused_moments_dtype="bfloat16"``; numpy
    has no bfloat16 of its own, so the bits go across as int16)."""
    a = np.array(v)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def members_from_numpy(members: Sequence[tuple[dict, dict]],
                       device="cpu") -> list[tuple[dict, dict]]:
    """[(params, buffers)] of numpy arrays → the port's members (tensors,
    nested params kept nested; plain Python scalars stay static
    buffers)."""
    out = []
    for params, buffers in members:
        arrays, statics = split_buffers(dict(buffers))
        conv = lambda tree: map_tree(lambda v: _tensor(v, device), tree)
        out.append((conv(params), {**conv(arrays), **dict(statics)}))
    return out


def state_from_numpy(*, params: dict, buffers: dict, mu: dict, nu: dict,
                     count, lrs, live=None, step=0, static_buffers=(),
                     sig_name: str = "", device="cpu") -> EnsembleState:
    """A stacked JAX ensemble state (params/buffers/moments keyed alike,
    each [N, ...]; optax's per-member ``count`` [N]; ``lrs`` [N]; ``live``
    [N] bool) → the port's :class:`EnsembleState`, nested params under
    flat keys. Every leaf keeps its kind (see :func:`_tensor`)."""
    conv = lambda tree: {k: _tensor(v, device)
                         for k, v in flatten_tree(tree).items()}
    n = int(np.asarray(lrs).shape[0])
    live_t: Optional[torch.Tensor] = (
        torch.ones((n,), dtype=torch.bool, device=device) if live is None
        else _tensor(live, device).to(torch.bool))
    return EnsembleState(
        params=conv(params), buffers=conv(buffers), mu=conv(mu), nu=conv(nu),
        count=_tensor(count, device).to(torch.int32).reshape(n),
        lrs=_tensor(lrs, device).to(torch.float32),
        step=torch.as_tensor(int(np.asarray(step)), dtype=torch.int32,
                             device=device),
        live=live_t, static_buffers=tuple(static_buffers),
        sig_name=sig_name)


def big_state_from_numpy(*, params: dict, mu: dict, nu: dict, count,
                         c_totals, worst_losses, worst_vectors, step=0,
                         tied: bool = False, device="cpu"):
    """A JAX ``BigSAEState``'s leaves as numpy (params and optax's Adam
    ``mu``/``nu`` keyed alike, the scalar ``count``, the tracking buffers,
    ``step``) → the port's :class:`~sparse_coding_tpu_torch.train.big_sae.BigSAEState`."""
    from sparse_coding_tpu_torch.train.big_sae import BigSAEState

    conv = lambda tree: {k: _tensor(v, device) for k, v in tree.items()}
    scalar = lambda v: torch.as_tensor(int(np.asarray(v)), dtype=torch.int32,
                                       device=device)
    return BigSAEState(
        params=conv(params), count=scalar(count), mu=conv(mu), nu=conv(nu),
        c_totals=_tensor(c_totals, device),
        worst_losses=_tensor(worst_losses, device),
        worst_vectors=_tensor(worst_vectors, device), step=scalar(step),
        tied=bool(tied))
