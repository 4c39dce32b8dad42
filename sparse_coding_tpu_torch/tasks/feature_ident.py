"""Task-feature identification (the JAX package's
``tasks/feature_ident.py``): which dictionary features carry a behavior?

For each feature, ablate it everywhere during the task's forward and
measure the change in the task metric (IOI: the logit difference between
the indirect object and the repeated subject at each prompt's answer
position); rank the features by effect size. The loops over features
and over cumulative masks run on the device of the LM's params, each
metric kept there, and the host reads each loop's metrics once. The
ranking is the host's ``np.argsort(-np.abs(effects))``, as the JAX
package sorts, so ties order the same way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.lm.hooks import tap_name
from sparse_coding_tpu_torch.metrics.intervention import (
    _forward,
    _tokens,
    ablate_feature_edit,
    ablate_feature_set_edit,
    params_device,
)
from sparse_coding_tpu_torch.models.learned_dict import LearnedDict

Tensor = torch.Tensor


def logit_diff_metric(logits: Tensor, lengths: Tensor, target_ids: Tensor,
                      distractor_ids: Tensor) -> Tensor:
    """Mean over prompts of logit[target] − logit[distractor] at the
    position that predicts the answer: ``lengths`` counts the prompt with
    its answer token, and a causal LM's logits at p score token p+1, so
    the name choice is read at lengths − 2."""
    idx = torch.arange(logits.shape[0], device=logits.device)
    pred = logits[idx, lengths - 2]  # [n, vocab]
    return torch.mean(pred[idx, target_ids] - pred[idx, distractor_ids])


class _Task:
    """The task's inputs on the device and its metric under an edit."""

    def __init__(self, params, lm_cfg, forward, tokens, lengths, target_ids,
                 distractor_ids):
        self.params, self.lm_cfg = params, lm_cfg
        self.forward = _forward(lm_cfg, forward)
        self.dev = params_device(params)
        self.tokens = _tokens(tokens, self.dev)
        self.lengths, self.target_ids, self.distractor_ids = (
            _tokens(v, self.dev) for v in (lengths, target_ids,
                                          distractor_ids))

    def metric(self, edit=None) -> Tensor:
        kw = {"edit": edit} if edit is not None else {}
        logits, _ = self.forward(self.params, self.tokens, self.lm_cfg, **kw)
        return logit_diff_metric(logits, self.lengths, self.target_ids,
                                 self.distractor_ids)


@torch.no_grad()
def identify_task_features(
    params, lm_cfg, model: LearnedDict, layer: int, tokens: np.ndarray,
    lengths: np.ndarray, target_ids: np.ndarray, distractor_ids: np.ndarray,
    layer_loc: str = "residual",
    feature_indices: Optional[Sequence[int]] = None,
    top_m: int = 20, forward=None,
) -> dict:
    """Rank features by how much ablating them moves the task metric.

    Returns {"base_metric", "effects" [n_feats], "ranking" (top_m indices
    by |effect|)}; a positive effect means ablating the feature lowers
    the metric (the feature supports the behavior)."""
    task = _Task(params, lm_cfg, forward, tokens, lengths, target_ids,
                 distractor_ids)
    model = model.to(task.dev)
    tap = tap_name(layer, layer_loc)
    feats = (np.asarray(list(feature_indices), np.int32)
             if feature_indices is not None
             else np.arange(int(model.n_feats), dtype=np.int32))
    base_t = task.metric()
    metrics = torch.stack([task.metric((tap, ablate_feature_edit(
        model, int(f)))) for f in feats]) if len(feats) else base_t[:0]
    base = float(base_t)
    feat_effects = base - metrics.cpu().numpy()
    effects = np.zeros(int(model.n_feats), np.float32)
    effects[feats] = feat_effects
    # rank within the evaluated features, then truncate
    order = feats[np.argsort(-np.abs(feat_effects))]
    return {"base_metric": base, "effects": effects,
            "ranking": [int(i) for i in order[:top_m]]}


@torch.no_grad()
def cumulative_ablation_curve(
    params, lm_cfg, model: LearnedDict, layer: int, tokens: np.ndarray,
    lengths: np.ndarray, target_ids: np.ndarray, distractor_ids: np.ndarray,
    ranking: Sequence[int], layer_loc: str = "residual", forward=None,
    base_metric: Optional[float] = None,
) -> dict:
    """The task metric with the top-m ranked features jointly ablated,
    m = 1..len(ranking). Returns {"base_metric", "metrics" [M], "drops"
    [M] (base − metric)}; pass ``base_metric`` when it is known to skip
    the unedited forward."""
    task = _Task(params, lm_cfg, forward, tokens, lengths, target_ids,
                 distractor_ids)
    model = model.to(task.dev)
    tap = tap_name(layer, layer_loc)
    ranking = np.asarray(list(ranking), np.int32)
    # cumulative one-hot prefixes: masks[m] ablates ranking[:m+1]
    masks = np.zeros((len(ranking), int(model.n_feats)), np.float32)
    for m, feat in enumerate(ranking):
        masks[m:, feat] = 1.0
    masks_t = torch.as_tensor(masks, device=task.dev)
    curve = torch.stack([task.metric((tap, ablate_feature_set_edit(
        model, mask))) for mask in masks_t])
    if base_metric is None:
        base_metric = float(task.metric())
    metrics = curve.cpu().numpy()
    return {"base_metric": base_metric, "metrics": metrics,
            "drops": base_metric - metrics}


def run_ioi_feature_ident(params, lm_cfg, model: LearnedDict, layer: int,
                          tokenizer, n_prompts: int = 32,
                          layer_loc: str = "residual", forward=None,
                          family: str = "mixed", seed: int = 0,
                          curve: bool = False, **kwargs) -> dict:
    """IOI feature identification end to end: build the counterfactual
    IOI dataset (``family`` is any ``ioi_counterfact.TEMPLATE_FAMILIES``
    bank; "mixed" is ABBA + BABA) and rank the dict's features by their
    causal effect on the IOI logit difference; ``curve`` adds the
    cumulative ablation curve over the ranking."""
    from sparse_coding_tpu_torch.tasks.ioi_counterfact import (
        gen_ioi_dataset_with_distractors,
    )

    tokens, _, lengths, target_ids, distractor_ids = (
        gen_ioi_dataset_with_distractors(tokenizer, n_prompts,
                                         family=family, seed=seed))
    result = identify_task_features(
        params, lm_cfg, model, layer, tokens, lengths, target_ids,
        distractor_ids, layer_loc=layer_loc, forward=forward, **kwargs)
    if curve:
        result["ablation_curve"] = cumulative_ablation_curve(
            params, lm_cfg, model, layer, tokens, lengths, target_ids,
            distractor_ids, result["ranking"], layer_loc=layer_loc,
            forward=forward, base_metric=result["base_metric"])
    return result
