"""Feature-activation fragment dataset (the JAX package's
``interp/fragments.py``).

One random window of ``fragment_len`` tokens per token row goes through
the LM and the dictionary. Only the per-fragment per-feature maxes
``[N, F]`` stay on the device (the top-k selection input); the per-token
codes are recomputed, one fragment at a time, for just the fragments a
feature's explanation reads (top-k + random, ≈ 20 of N), so device memory
never scales with n_fragments × fragment_len × n_feats.

Everything runs where the LM's params live, under ``torch.no_grad``; the
maxes stay there until a caller reads them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from sparse_coding_tpu_torch.lm.convert import forward_fn
from sparse_coding_tpu_torch.lm.hooks import tap_name
from sparse_coding_tpu_torch.lm.model_config import LMConfig
from sparse_coding_tpu_torch.metrics.intervention import params_device
from sparse_coding_tpu_torch.models.learned_dict import LearnedDict

Tensor = torch.Tensor


def sample_fragments(token_rows: np.ndarray, fragment_len: int,
                     n_fragments: int, seed: int = 0) -> np.ndarray:
    """One random fragment per row: ``min(n_fragments, rows)`` rows in a
    seeded random order, each with a random window start."""
    if token_rows.shape[1] < fragment_len:
        raise ValueError(
            f"token rows have length {token_rows.shape[1]} < fragment_len "
            f"{fragment_len}; harvest with a longer context or lower "
            "cfg.fragment_len")
    rng = np.random.default_rng(seed)
    n = min(n_fragments, token_rows.shape[0])
    rows = rng.permutation(token_rows.shape[0])[:n]
    out = np.zeros((n, fragment_len), token_rows.dtype)
    for i, r in enumerate(rows):
        max_start = token_rows.shape[1] - fragment_len
        s = rng.integers(0, max_start + 1) if max_start > 0 else 0
        out[i] = token_rows[r, s:s + fragment_len]
    return out


@dataclasses.dataclass
class FragmentActivations:
    """Per-feature interpretation inputs: fragments + per-fragment maxes,
    both on the LM's device."""

    fragments: Tensor  # [N, L] token ids
    max_per_fragment: Tensor  # [N, F] max activation of each feature
    n_feats: int = 0

    def top_fragments(self, feature: int, k: int) -> tuple[Tensor, Tensor]:
        """(fragment indices, their max activations) for one feature, the
        largest first; equal maxes keep index order, as ``jax.lax.top_k``
        orders them (a stable descending sort: ``torch.topk`` promises no
        order among ties, and a feature's zero maxes tie)."""
        k = min(k, int(self.fragments.shape[0]))
        vals, idx = torch.sort(self.max_per_fragment[:, feature],
                               descending=True, stable=True)
        return idx[:k], vals[:k]

    def random_fragments(self, k: int, seed: int = 0) -> Tensor:
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.permutation(self.fragments.shape[0])[:k])


class TokenActivationLookup:
    """Lazy per-token activations: recomputes codes for just the requested
    fragments instead of holding [N, L, F] on the device. The host cache
    is LRU-bounded, so interpreting thousands of features over a large
    fragment pool cannot grow without limit."""

    def __init__(self, fragments: Tensor,
                 encode_batch: Callable[[Tensor], Tensor],
                 cache_size: int = 512):
        self._fragments = fragments
        self._encode_batch = encode_batch
        self._codes_for = functools.lru_cache(maxsize=max(1, cache_size))(
            self._compute_codes)

    def _compute_codes(self, fragment_idx: int) -> np.ndarray:
        c = self._encode_batch(self._fragments[fragment_idx][None, :])
        return c[0].cpu().numpy()

    def tokens_activations(self, fragment_idx: int,
                           feature: int) -> np.ndarray:
        return self._codes_for(int(fragment_idx))[:, feature]


def make_fragment_encode_fns(params, lm_cfg: LMConfig, model: LearnedDict,
                             layer: int, layer_loc: str = "residual",
                             forward=None):
    """The fragment program: ``encode_batch`` (tokens [b, s] → per-token
    codes [b, s, n]). The JAX package also returns ``window_maxes``, K
    batches fused into one device program; here successive batches
    already queue on the device with no host read between them, so that
    second program would compute the same thing by the same path."""
    forward = forward if forward is not None else forward_fn(lm_cfg)
    model = model.to(params_device(params))
    tap = tap_name(layer, layer_loc)

    @torch.no_grad()
    def encode_batch(toks: Tensor) -> Tensor:
        _, tapped = forward(params, toks, lm_cfg, taps=(tap,),
                            stop_at_layer=layer + 1)
        acts = tapped[tap]
        b, s, d = acts.shape
        codes = model.encode(model.center(acts.reshape(b * s, d)))
        return codes.reshape(b, s, -1)

    return encode_batch


def build_fragment_activations(
    params, lm_cfg: LMConfig, model: LearnedDict, fragments: np.ndarray,
    layer: int, layer_loc: str = "residual", batch_size: int = 64,
    forward=None, scan_batches: int = 1,
) -> tuple[FragmentActivations, TokenActivationLookup]:
    """Run the LM over ALL fragments (tail batch included), keeping only the
    per-fragment maxes on the device; returns the maxes plus a lazy
    lookup.

    ``scan_batches`` is kept for the JAX signature and has no effect: JAX
    fuses K batches into one device program to save host round trips,
    while here every batch is queued on the device and nothing reads the
    host until a caller reads the maxes, so any K gives the maxes of
    K=1."""
    del scan_batches
    if fragments.shape[0] == 0:
        raise ValueError("no fragments to process")
    encode_batch = make_fragment_encode_fns(params, lm_cfg, model, layer,
                                            layer_loc, forward)
    fragments_dev = torch.as_tensor(fragments).to(
        device=params_device(params), dtype=torch.long)
    max_per_fragment = torch.cat(
        [torch.amax(encode_batch(fragments_dev[lo:lo + batch_size]), dim=1)
         for lo in range(0, fragments.shape[0], batch_size)], dim=0)
    fa = FragmentActivations(fragments=fragments_dev,
                             max_per_fragment=max_per_fragment,
                             n_feats=int(max_per_fragment.shape[-1]))
    return fa, TokenActivationLookup(fragments_dev, encode_batch)
