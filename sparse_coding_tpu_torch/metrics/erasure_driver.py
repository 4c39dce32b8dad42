"""Config-driven concept-erasure experiment (the JAX package's
``metrics/erasure_driver.py``): ``ErasureArgs`` in, per-layer
``erasure_scores_layer_{L}.json`` records and tradeoff plots out.

Per layer: the activations at the probe tokens, the feature-erasure
curve of each dict, the LEACE baseline, and optionally the LM's KL under
each edit. Everything runs on the device of the LM's params."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.config import ErasureArgs
from sparse_coding_tpu_torch.lm.hooks import tap_name
from sparse_coding_tpu_torch.metrics.erasure import (
    feature_erasure_curve,
    leace_baseline,
)
from sparse_coding_tpu_torch.metrics.intervention import params_device
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts


@torch.no_grad()
def probe_activations(params, lm_cfg, tokens: np.ndarray, layer: int,
                      layer_loc: str, position: int = -1, forward=None,
                      model_batch_size: int = 64) -> torch.Tensor:
    """Activations at one position of each probe prompt, [n, d], on the
    params' device. Takes [n, s] prompts or [n] bare token ids (the
    gender probe arrays, as one-token prompts); runs the forward up to
    the layer only, in batches of ``model_batch_size``. On the card each
    batch is copied from pinned host memory without blocking, so the
    copy queues behind the forwards already issued instead of waiting
    for them."""
    if forward is None:
        from sparse_coding_tpu_torch.lm.convert import forward_fn
        forward = forward_fn(lm_cfg)
    dev = params_device(params)
    tokens = np.asarray(tokens)
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    host = torch.as_tensor(tokens, dtype=torch.long)
    if dev.type == "cuda":
        host = host.pin_memory()
    tap = tap_name(layer, layer_loc)
    outs = []
    for lo in range(0, host.shape[0], model_batch_size):
        batch = host[lo:lo + model_batch_size].to(dev, non_blocking=True)
        _, tapped = forward(params, batch, lm_cfg, taps=(tap,),
                            stop_at_layer=layer + 1)
        outs.append(tapped[tap][:, position, :])
    return torch.cat(outs, dim=0)


def run_erasure(cfg: ErasureArgs, params, lm_cfg, probe_tokens: np.ndarray,
                labels: np.ndarray, forward=None,
                kl_tokens: Optional[np.ndarray] = None) -> dict[int, dict]:
    """The erasure experiment over ``cfg.layers``: writes
    ``{output_folder}/erasure_scores_layer_{L}.json`` (atomically) and
    its plot; returns the records. ``probe_tokens`` [n, s] are prompts
    whose last position carries the concept, ``labels`` [n] binary."""
    from sparse_coding_tpu_torch.plotting.erasure import plot_erasure_tradeoff

    dicts = load_learned_dicts(cfg.dict_path, device=params_device(params))
    out = Path(cfg.output_folder)
    out.mkdir(parents=True, exist_ok=True)
    grid = [g for g in (1, 2, 4, 8, 16, 32, 64) if g <= cfg.max_edit_feats]

    results: dict[int, dict] = {}
    for layer in cfg.layers:
        acts = probe_activations(params, lm_cfg, probe_tokens, layer,
                                 cfg.layer_loc, forward=forward)
        lm_eval = None
        if kl_tokens is not None:
            lm_eval = {"params": params, "lm_cfg": lm_cfg,
                       "tokens": kl_tokens,
                       "location": (layer, cfg.layer_loc), "forward": forward}
        layer_rec = {"layer": layer, "dicts": [],
                     "leace": leace_baseline(acts, labels)}
        for ld, hyper in dicts:
            curve = feature_erasure_curve(ld, acts, labels,
                                          n_features_grid=grid,
                                          lm_eval=lm_eval)
            layer_rec["dicts"].append({
                "hyperparams": {k: v for k, v in hyper.items()
                                if isinstance(v, (int, float, str, bool))},
                "curve": curve,
            })
        path = out / f"erasure_scores_layer_{layer}.json"
        atomic_write_text(path, json.dumps(layer_rec, indent=2, default=float))
        plot_erasure_tradeoff(layer_rec["dicts"][0]["curve"],
                              leace=layer_rec["leace"],
                              save_path=out / f"erasure_layer_{layer}.png",
                              title=f"erasure tradeoff (layer {layer})")
        results[layer] = layer_rec
    return results
