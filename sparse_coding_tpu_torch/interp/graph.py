"""Config-driven ablation-graph and feature-investigation drivers (the
JAX package's ``interp/graph.py``): the consumers of ``InterpGraphArgs``
and ``InvestigateArgs`` (config.py). They run where the LM's params
live."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from sparse_coding_tpu_torch.config import (
    InterpArgs,
    InterpGraphArgs,
    InvestigateArgs,
)
from sparse_coding_tpu_torch.interp.fragments import sample_fragments
from sparse_coding_tpu_torch.metrics.intervention import (
    build_ablation_graph,
    build_ablation_graph_non_positional,
    params_device,
)
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts


def run_interp_graph(cfg: InterpGraphArgs, params, lm_cfg,
                     token_rows: np.ndarray, forward=None,
                     features_to_ablate=None, target_features=None) -> dict:
    """Build an ablation graph between the dicts named in cfg.dict_paths
    (member 0 of each, one per layer in cfg.layers) over cfg.n_fragments
    sampled fragments, and persist it as ``ablation_graph.json`` (keys
    the ``repr`` of each edge)."""
    if len(cfg.dict_paths) != len(cfg.layers):
        raise ValueError(
            f"need one dict per layer: {len(cfg.dict_paths)} paths for "
            f"{len(cfg.layers)} layers")
    dev = params_device(params)
    models = {}
    for layer, path in zip(cfg.layers, cfg.dict_paths):
        ld, _ = load_learned_dicts(path, device=dev)[0]
        models[(layer, cfg.layer_loc)] = ld

    fragments = sample_fragments(token_rows, cfg.fragment_len, cfg.n_fragments,
                                 seed=cfg.seed)
    build_graph = (build_ablation_graph if cfg.positional
                   else build_ablation_graph_non_positional)
    graph = build_graph(params, lm_cfg, models, fragments,
                    features_to_ablate=features_to_ablate,
                    target_features=target_features, forward=forward)

    out = Path(cfg.output_folder)
    out.mkdir(parents=True, exist_ok=True)
    serializable = {repr(k): v for k, v in graph.items()}
    atomic_write_text(out / "ablation_graph.json",
                      json.dumps(serializable, indent=2))
    return graph


def investigate_features(cfg: InvestigateArgs, params, lm_cfg,
                         token_rows: np.ndarray, decode_token,
                         forward=None) -> list[dict]:
    """Deep-dive specific features of one dict (member 0 of
    cfg.learned_dict_path): interpretation records for exactly
    cfg.feature_indices, offline."""
    from sparse_coding_tpu_torch.interp.run import run

    ld, _ = load_learned_dicts(cfg.learned_dict_path,
                               device=params_device(params))[0]
    interp_cfg = InterpArgs(
        model_name=cfg.model_name, layer=cfg.layer, layer_loc=cfg.layer_loc,
        output_folder=cfg.output_folder, fragment_len=cfg.fragment_len,
        n_fragments=cfg.n_fragments, provider="offline", seed=cfg.seed,
        n_feats_to_explain=len(cfg.feature_indices) or 1)
    return run(ld, interp_cfg, params, lm_cfg, token_rows, decode_token,
               forward=forward,
               feature_indices=cfg.feature_indices or None)
