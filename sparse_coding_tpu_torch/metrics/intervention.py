"""Model-intervention metrics (the JAX package's
``metrics/intervention.py``): perplexity under reconstruction, feature
ablation graphs, activation caching.

Every intervention is an ``edit=(tap, fn)`` handed to the LM forward
(lm/gptneox.py, lm/gpt2.py), which applies ``fn`` to the tapped
activation in flight. Everything runs where the LM's params live, under
``torch.no_grad``; the dicts are moved there. Loops over batches or
features queue their work on the device and keep each result there;
the host reads them once, at the end (a block of features at a time for
the graphs), never once a batch or a feature.
"""

from __future__ import annotations

from itertools import product
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding_tpu_torch.lm.hooks import max_tap_layer, tap_name
from sparse_coding_tpu_torch.lm.model_config import LMConfig
from sparse_coding_tpu_torch.models.learned_dict import LearnedDict
from sparse_coding_tpu_torch.utils.tree import flatten_tree

Tensor = torch.Tensor
Location = Tuple[int, str]  # (layer, layer_loc)
# ablated features whose edge weights come back to the host in one copy
GRAPH_BLOCK = 64


def _loc_tap(location: Location) -> str:
    layer, loc = location
    return tap_name(layer, loc)


def params_device(params) -> torch.device:
    """The device of an LM's params (their first tensor's)."""
    for v in flatten_tree(params).values():
        if isinstance(v, Tensor):
            return v.device
    raise ValueError("no tensor in the params")


def _forward(lm_cfg: LMConfig, forward):
    if forward is None:
        from sparse_coding_tpu_torch.lm.convert import forward_fn
        forward = forward_fn(lm_cfg)
    return forward


def _tokens(tokens, device) -> Tensor:
    return torch.as_tensor(tokens).to(device=device, dtype=torch.long)


def lm_loss(logits: Tensor, tokens: Tensor) -> Tensor:
    """Mean next-token cross-entropy in nats, log_softmax in fp32."""
    logprobs = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    targets = tokens[:, 1:]
    ll = torch.gather(logprobs, -1, targets[..., None])[..., 0]
    return -ll.mean()


def reconstruction_edit(model: LearnedDict) -> Callable[[Tensor], Tensor]:
    """Replace a tapped [b, s, d] activation with the dict's
    reconstruction."""

    def edit(tensor: Tensor) -> Tensor:
        b, s, d = tensor.shape
        return model.predict(tensor.reshape(b * s, d)).reshape(b, s, d)

    return edit


def ablate_feature_edit(model: LearnedDict, feature_idx,
                        position=None) -> Callable[[Tensor], Tensor]:
    """Subtract one feature's contribution from the tapped activation, at
    one position or everywhere. ``feature_idx`` and ``position`` may be
    ints or 0-d device tensors: neither makes a host-device copy."""

    def edit(tensor: Tensor) -> Tensor:
        b, s, d = tensor.shape
        codes = model.encode(tensor.reshape(b * s, d))
        atoms = model.get_learned_dict()
        if isinstance(feature_idx, Tensor):
            idx = feature_idx.reshape(1)
            code, atom = codes.index_select(1, idx), atoms.index_select(0, idx)
        else:
            i = int(feature_idx)
            code, atom = codes[:, i:i + 1], atoms[i:i + 1]
        contribution = (code * atom).reshape(b, s, d)
        if position is None:
            return tensor - contribution
        mask = (torch.arange(s, device=tensor.device) == position
                )[None, :, None]
        return tensor - torch.where(mask, contribution, 0.0)

    return edit


def ablate_feature_set_edit(model: LearnedDict,
                            feature_mask) -> Callable[[Tensor], Tensor]:
    """Subtract a set of features' contributions from the tapped
    activation (``feature_mask`` [n_feats], 1 = ablate). The mask is cast
    to the codes' dtype, so an fp32 mask cannot widen a bf16 stream."""

    def edit(tensor: Tensor) -> Tensor:
        b, s, d = tensor.shape
        codes = model.encode(tensor.reshape(b * s, d))
        mask = torch.as_tensor(feature_mask, device=codes.device).to(
            codes.dtype)
        contribution = ((codes * mask) @ model.get_learned_dict()).reshape(
            b, s, d)
        return tensor - contribution.to(tensor.dtype)

    return edit


@torch.no_grad()
def run_with_model_intervention(params, lm_cfg: LMConfig,
                                model: LearnedDict, location: Location,
                                tokens, forward=None) -> Tensor:
    """Logits of a forward whose tap is replaced by the dict's
    reconstruction."""
    forward = _forward(lm_cfg, forward)
    dev = params_device(params)
    logits, _ = forward(params, _tokens(tokens, dev), lm_cfg,
                        edit=(_loc_tap(location),
                              reconstruction_edit(model.to(dev))))
    return logits


@torch.no_grad()
def perplexity_under_reconstruction(params, lm_cfg: LMConfig,
                                    model: LearnedDict, location: Location,
                                    tokens, forward=None) -> Tensor:
    """Loss (nats) with the tap replaced by the dict's reconstruction."""
    dev = params_device(params)
    logits = run_with_model_intervention(params, lm_cfg, model, location,
                                         tokens, forward=forward)
    return lm_loss(logits, _tokens(tokens, dev))


@torch.no_grad()
def calculate_perplexity(params, lm_cfg: LMConfig,
                         autoencoders: Sequence[tuple[LearnedDict, dict]],
                         layer: int, setting: str, token_rows: np.ndarray,
                         model_batch_size: int = 32,
                         forward=None) -> tuple[float, list[float]]:
    """Original perplexity and each dict's perplexity under
    reconstruction at ``(layer, setting)``: exp of the mean of per-batch
    mean losses over batches of ``model_batch_size`` rows, the short tail
    batch kept. Each batch's loss stays on the device; one read a dict."""
    forward = _forward(lm_cfg, forward)
    dev = params_device(params)
    tap = _loc_tap((layer, setting))
    n_rows = token_rows.shape[0]
    if n_rows == 0:
        raise ValueError("token_rows is empty")
    toks = _tokens(token_rows, dev)
    batches = [toks[lo:lo + model_batch_size]
               for lo in range(0, n_rows, model_batch_size)]

    def mean_batch_loss(edit) -> float:
        kw = {"edit": edit} if edit is not None else {}
        losses = torch.stack([lm_loss(forward(params, b, lm_cfg, **kw)[0], b)
                              for b in batches])
        return float(np.mean(losses.cpu().numpy()))

    original = float(np.exp(mean_batch_loss(None)))
    per_dict = [float(np.exp(mean_batch_loss(
        (tap, reconstruction_edit(model.to(dev))))))
        for model, _hyper in autoencoders]
    return original, per_dict


@torch.no_grad()
def cache_all_activations(params, lm_cfg: LMConfig,
                          models: Dict[Location, LearnedDict], tokens,
                          edit=None, forward=None) -> Dict[Location, Tensor]:
    """Every location's tapped activations encoded by its dict, from one
    forward that stops after the last tapped layer: {location: [b, s,
    n_feats]}."""
    forward = _forward(lm_cfg, forward)
    dev = params_device(params)
    taps = tuple(_loc_tap(loc) for loc in models)
    _, tapped = forward(params, _tokens(tokens, dev), lm_cfg, taps=taps,
                        stop_at_layer=max_tap_layer(taps) + 1, edit=edit)
    out = {}
    for loc, model in models.items():
        t = tapped[_loc_tap(loc)]
        b, s, d = t.shape
        out[loc] = model.to(dev).encode(t.reshape(b * s, d)).reshape(b, s, -1)
    return out


def _ablation_deltas(params, lm_cfg: LMConfig,
                     models: Dict[Location, LearnedDict], location: Location,
                     forward, tokens: Tensor, base: Dict[Location, Tensor],
                     feat_idx, pos, positional: bool) -> Dict[Location, Tensor]:
    """Every location's code shift when one feature at ``location`` is
    ablated: positional, delta[loc][s, f] = ‖u − a‖₂ over the batch;
    else delta[loc][f] = mean over the batch of ‖(u − a)_b‖₂ over
    positions."""
    edit = (_loc_tap(location), ablate_feature_edit(
        models[location], feat_idx, position=pos if positional else None))
    taps = tuple(_loc_tap(loc) for loc in models)
    _, tapped = forward(params, tokens, lm_cfg, taps=taps,
                        stop_at_layer=max_tap_layer(taps) + 1, edit=edit)
    out = {}
    for loc, m in models.items():
        t = tapped[_loc_tap(loc)]
        b, s, d = t.shape
        diff = base[loc] - m.encode(t.reshape(b * s, d)).reshape(b, s, -1)
        norms = torch.linalg.vector_norm(diff, dim=0 if positional else 1)
        out[loc] = norms if positional else norms.mean(dim=0)
    return out


def _graph(params, lm_cfg, models, tokens, features_to_ablate, all_features,
           forward, positional: bool) -> Dict[tuple, float]:
    forward = _forward(lm_cfg, forward)
    dev = params_device(params)
    models = {loc: m.to(dev) for loc, m in models.items()}
    toks = _tokens(tokens, dev)
    base = cache_all_activations(params, lm_cfg, models, toks,
                                 forward=forward)
    graph: Dict[tuple, float] = {}
    for location in models:
        feats = list(features_to_ablate.get(location, ()))
        for lo in range(0, len(feats), GRAPH_BLOCK):
            block = feats[lo:lo + GRAPH_BLOCK]
            deltas = [_ablation_deltas(
                params, lm_cfg, models, location, forward, toks, base,
                f[1] if positional else f, f[0] if positional else None,
                positional) for f in block]
            # one copy to the host for the block's every edge weight
            host = {loc: torch.stack([d[loc] for d in deltas]).cpu().numpy()
                    for loc in models}
            for j, feature in enumerate(block):
                for loc_, feature_ in all_features:
                    if loc_ == location and feature_ == feature:
                        continue
                    w = (host[loc_][j][feature_[0], feature_[1]] if positional
                         else host[loc_][j][feature_])
                    graph[((location, feature), (loc_, feature_))] = float(w)
    return graph


@torch.no_grad()
def build_ablation_graph(
        params, lm_cfg: LMConfig, models: Dict[Location, LearnedDict],
        tokens,
        features_to_ablate: Optional[Dict[Location, List[Tuple[int, int]]]] = None,
        target_features: Optional[Dict[Location, List[Tuple[int, int]]]] = None,
        forward=None) -> Dict[tuple, float]:
    """Positional ablation-impact graph: for each (location, (pos, feat)),
    ablate it at that position and take every other feature's activation
    shift, ‖u − a‖₂ over the batch, as the edge weight. Empty or None
    ``features_to_ablate`` means every (position, feature)."""
    L = int(tokens.shape[1])
    if not features_to_ablate:
        features_to_ablate = {
            loc: list(product(range(L), range(int(m.n_feats))))
            for loc, m in models.items()}
    target_features = target_features or {}
    all_features = [(loc, f) for loc, feats in
                    {**features_to_ablate, **target_features}.items()
                    for f in feats]
    return _graph(params, lm_cfg, models, tokens, features_to_ablate,
                  all_features, forward, positional=True)


@torch.no_grad()
def build_ablation_graph_non_positional(
        params, lm_cfg: LMConfig, models: Dict[Location, LearnedDict],
        tokens,
        features_to_ablate: Optional[Dict[Location, List[int]]] = None,
        target_features: Optional[Dict[Location, List[int]]] = None,
        forward=None) -> Dict[tuple, float]:
    """Ablate each feature at every position; edge weight the mean over
    the batch of the target's shift norm over positions."""
    if not features_to_ablate:
        features_to_ablate = {loc: list(range(int(m.n_feats)))
                              for loc, m in models.items()}
    target_features = target_features or {}
    all_features = [(loc, f) for loc, feats in
                    {**features_to_ablate, **target_features}.items()
                    for f in feats]
    return _graph(params, lm_cfg, models, tokens, features_to_ablate,
                  all_features, forward, positional=False)
