"""Carry members and whole training states across from numpy — e.g. the
JAX package's ``FunctionalTiedSAE.init`` members or a ``device_get`` of
its ``EnsembleState`` — so the port and the reference start from the same
numbers and compute the same trajectory."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.ensemble import EnsembleState, split_buffers


def _tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v), device=device)


def members_from_numpy(members: Sequence[tuple[dict, dict]],
                       device="cpu") -> list[tuple[dict, dict]]:
    """[(params, buffers)] of numpy arrays → the port's members (tensors;
    plain Python scalars stay static buffers)."""
    out = []
    for params, buffers in members:
        arrays, statics = split_buffers(dict(buffers))
        out.append(({k: _tensor(v, device) for k, v in params.items()},
                    {**{k: _tensor(v, device) for k, v in arrays.items()},
                     **dict(statics)}))
    return out


def state_from_numpy(*, params: dict, buffers: dict, mu: dict, nu: dict,
                     count, lrs, live=None, step=0, static_buffers=(),
                     sig_name: str = "", device="cpu") -> EnsembleState:
    """A stacked JAX ensemble state (params/buffers/moments keyed alike,
    each [N, ...]; optax's per-member ``count`` [N]; ``lrs`` [N]; ``live``
    [N] bool) → the port's :class:`EnsembleState`."""
    conv = lambda tree: {k: _tensor(v, device).to(torch.float32)
                         for k, v in tree.items()}
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
