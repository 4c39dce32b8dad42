"""Auto-interpretation drivers and score persistence (the JAX package's
``interp/run.py``).

Per feature: explain from the top fragments, simulate, score by the
correlation of simulated and true activations. Artifact layout:
``{output}/feature_{i}/explanation.txt`` + ``scores.json`` (the per-feature
completeness marker: a rerun skips every feature that has one) and
``{output}/summary.json``.

Everything on the device runs where the LM's params live; the CLI places
them with ``--device`` (default: the card).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.config import InterpArgs
from sparse_coding_tpu_torch.interp.client import (
    ActivationRecord,
    Explainer,
    get_explainer,
)
from sparse_coding_tpu_torch.interp.fragments import (
    FragmentActivations,
    TokenActivationLookup,
    build_fragment_activations,
    sample_fragments,
)
from sparse_coding_tpu_torch.metrics.intervention import params_device
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts


def correlation_score(true: np.ndarray, predicted: np.ndarray) -> float:
    """Pearson correlation between simulated and true activations."""
    t = np.asarray(true, np.float64).ravel()
    p = np.asarray(predicted, np.float64).ravel()
    if t.std() == 0 or p.std() == 0:
        return 0.0
    return float(np.corrcoef(t, p)[0, 1])


def _records_for(fragment_idx, feature: int, fa: FragmentActivations,
                 lookup: TokenActivationLookup,
                 decode_token) -> list[ActivationRecord]:
    idx = torch.as_tensor(fragment_idx).tolist()
    rows = fa.fragments[torch.as_tensor(idx, dtype=torch.long,
                                        device=fa.fragments.device)]
    records = []
    for fi, toks in zip(idx, rows.cpu().tolist()):
        acts = [float(a) for a in lookup.tokens_activations(fi, feature)]
        records.append(ActivationRecord(
            tokens=[decode_token(int(t)) for t in toks], activations=acts))
    return records


def interpret_feature(feature: int, fa: FragmentActivations,
                      lookup: TokenActivationLookup, explainer: Explainer,
                      decode_token, top_k: int = 10, n_random: int = 10,
                      seed: int = 0) -> dict:
    """Explain one feature from its top fragments; score the explanation on
    top, random, and combined fragments."""
    top_idx, top_vals = fa.top_fragments(feature, top_k)
    top_idx = top_idx.cpu()
    rand_idx = fa.random_fragments(n_random, seed=seed + feature)

    top_records = _records_for(top_idx, feature, fa, lookup, decode_token)
    explanation = explainer.explain(top_records)

    def score(idx):
        true, pred = [], []
        for rec in _records_for(idx, feature, fa, lookup, decode_token):
            true.extend(rec.activations)
            pred.extend(explainer.simulate(explanation, rec.tokens))
        return correlation_score(np.asarray(true), np.asarray(pred))

    return {
        "feature": feature,
        "explanation": explanation,
        "top_score": score(top_idx),
        "random_score": score(rand_idx),
        "top_random_score": score(torch.cat([top_idx, rand_idx])),
        "max_activation": float(top_vals[0]),
    }


def run(learned_dict, cfg: InterpArgs, params, lm_cfg, token_rows: np.ndarray,
        decode_token, forward=None,
        feature_indices: Optional[Sequence[int]] = None) -> list[dict]:
    """Main driver: build the fragment dataset once, interpret the
    requested features (default: the ``n_feats_to_explain`` with the
    largest activation mass), persist per-feature artifacts."""
    out = Path(cfg.output_folder)
    out.mkdir(parents=True, exist_ok=True)
    explainer = get_explainer(cfg.provider,
                              **({} if cfg.provider == "offline" else
                                 {"explainer_model": cfg.explainer_model,
                                  "simulator_model": cfg.simulator_model}))

    fragments = sample_fragments(token_rows, cfg.fragment_len, cfg.n_fragments,
                                 seed=cfg.seed)
    fa, lookup = build_fragment_activations(
        params, lm_cfg, learned_dict, fragments, cfg.layer, cfg.layer_loc,
        batch_size=cfg.batch_size, forward=forward,
        scan_batches=cfg.scan_batches)

    if feature_indices is None:
        # the one host read of the maxes; the mass is summed on the host in
        # float32 and ranked with numpy's default sort, as the JAX package
        # ranks it
        mass = fa.max_per_fragment.cpu().numpy().sum(axis=0)
        feature_indices = list(np.argsort(-mass)[:cfg.n_feats_to_explain])

    results = []
    for feat in feature_indices:
        feat_dir = out / f"feature_{feat}"
        if (feat_dir / "scores.json").exists():  # idempotent re-runs
            results.append(json.loads((feat_dir / "scores.json").read_text()))
            continue
        rec = interpret_feature(int(feat), fa, lookup, explainer, decode_token,
                                top_k=cfg.top_k_fragments,
                                n_random=cfg.n_random_fragments, seed=cfg.seed)
        feat_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_text(feat_dir / "explanation.txt", rec["explanation"])
        # scores.json is the per-feature completeness marker (idempotent
        # re-runs key off it above) — written last, atomically
        atomic_write_text(feat_dir / "scores.json", json.dumps(rec, indent=2))
        results.append(rec)
    atomic_write_text(out / "summary.json", json.dumps(results, indent=2))
    return results


def _dicts(path, params) -> list:
    return load_learned_dicts(path, device=params_device(params))


def run_folder(dict_paths: Sequence[str], cfg: InterpArgs, params, lm_cfg,
               token_rows, decode_token, forward=None) -> dict[str, list]:
    """Interpret every member of every artifact in ``dict_paths``, each
    into ``{output_folder}/{artifact stem}_{member}``."""
    all_results = {}
    for path in dict_paths:
        for i, (ld, hyper) in enumerate(_dicts(path, params)):
            sub_cfg = cfg.replace(output_folder=str(
                Path(cfg.output_folder) / f"{Path(path).stem}_{i}"))
            all_results[f"{path}:{i}"] = run(ld, sub_cfg, params, lm_cfg,
                                             token_rows, decode_token,
                                             forward=forward)
    return all_results


def interpret_across_baselines(baseline_root: str | Path, cfg: InterpArgs,
                               params, lm_cfg, token_rows, decode_token,
                               forward=None) -> dict[str, list]:
    """Interpret every baseline artifact under a baselines output tree.
    Artifacts under ``l{N}_{loc}/`` subfolders (the ``run_all_baselines``
    layout) are interpreted at their layer and location; outputs are
    namespaced by the artifact's relative path, so same-named pkls from
    different layers never collide."""
    baseline_root = Path(baseline_root)
    all_results = {}
    for path in sorted(baseline_root.rglob("*.pkl")):
        rel = path.relative_to(baseline_root)
        m = re.match(r"l(\d+)_(\w+)", rel.parts[0]) if len(rel.parts) > 1 else None
        sub_cfg = cfg
        if m:
            sub_cfg = cfg.replace(layer=int(m.group(1)), layer_loc=m.group(2))
        ns = "_".join(rel.with_suffix("").parts)
        for i, (ld, hyper) in enumerate(_dicts(path, params)):
            member_cfg = sub_cfg.replace(output_folder=str(
                Path(cfg.output_folder) / f"{ns}_{i}"))
            all_results[f"{rel}:{i}"] = run(ld, member_cfg, params, lm_cfg,
                                            token_rows, decode_token,
                                            forward=forward)
    return all_results


def _snapshots(sweep_output: str | Path) -> list[Path]:
    """A sweep's ``_N`` snapshot folders in training order."""
    return sorted(Path(sweep_output).glob("_*"), key=lambda p: int(p.name[1:]))


def interpret_across_big_sweep(sweep_output: str | Path, cfg: InterpArgs,
                               params, lm_cfg, token_rows, decode_token,
                               forward=None) -> dict[str, list]:
    """Interpret the final snapshot's dicts of a sweep."""
    snapshots = _snapshots(sweep_output)
    if not snapshots:
        raise FileNotFoundError(f"no _N snapshots under {sweep_output}")
    paths = sorted(str(p) for p in snapshots[-1].glob("*_learned_dicts.pkl"))
    return run_folder(paths, cfg, params, lm_cfg, token_rows, decode_token,
                      forward=forward)


def interpret_across_chunks(sweep_output: str | Path, cfg: InterpArgs, params,
                            lm_cfg, token_rows, decode_token,
                            forward=None) -> dict[str, list]:
    """Time-series interpretation: the SAME features of the same member at
    each saved training snapshot (``_N/`` folders) of a sweep, pinned at
    the first snapshot."""
    results: dict[str, dict] = {}
    pinned: dict[str, Sequence[int]] = {}
    for snap in _snapshots(sweep_output):
        snap_results = {}
        for artifact in sorted(snap.glob("*_learned_dicts.pkl")):
            for i, (ld, hyper) in enumerate(_dicts(artifact, params)):
                member_key = f"{artifact.name}:{i}"
                sub_cfg = cfg.replace(output_folder=str(
                    Path(cfg.output_folder) / snap.name /
                    f"{artifact.stem}_{i}"))
                recs = run(ld, sub_cfg, params, lm_cfg, token_rows,
                           decode_token, forward=forward,
                           feature_indices=pinned.get(member_key))
                pinned.setdefault(member_key, [r["feature"] for r in recs])
                snap_results[member_key] = recs
        results[snap.name] = snap_results
    return results


def read_scores(output_folder: str | Path) -> dict[int, dict]:
    """Parse per-feature artifacts back: {feature: scores record}."""
    out = {}
    for feat_dir in sorted(Path(output_folder).glob("feature_*")):
        scores_path = feat_dir / "scores.json"
        if scores_path.exists():
            rec = json.loads(scores_path.read_text())
            out[int(rec["feature"])] = rec
    return out


def read_transform_scores(root: str | Path) -> dict[str, list[float]]:
    """Collect top_random scores per transform directory for comparison
    plots."""
    results = {}
    for transform_dir in sorted(Path(root).iterdir()):
        if not transform_dir.is_dir():
            continue
        scores = [rec["top_random_score"]
                  for rec in read_scores(transform_dir).values()]
        if scores:
            results[transform_dir.name] = scores
    return results


def _load_lm(model_name: str, device=None):
    """(params, lm_cfg, decode_token, forward) for the CLI, on ``device``
    (default: the card). ``tiny-gptneox`` / ``tiny-gpt2`` are random-weight
    models from a torch generator seeded with 0 (no network; tokens decode
    to their ids); anything else comes from the local Hugging Face cache
    (``lm/convert.load_model``)."""
    if model_name.startswith("tiny-"):
        arch = model_name.removeprefix("tiny-")
        from sparse_coding_tpu_torch.lm import gpt2, gptneox
        from sparse_coding_tpu_torch.lm.model_config import tiny_test_config

        mod = {"gptneox": gptneox, "gpt2": gpt2}[arch]
        lm_cfg = tiny_test_config(arch)
        params = mod.init_params(torch.Generator().manual_seed(0), lm_cfg,
                                 device=resolve_device(device))
        return params, lm_cfg, str, mod.forward
    from sparse_coding_tpu_torch.lm.convert import forward_fn, load_model

    params, lm_cfg = load_model(model_name, device=device)
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError("the tokenizer needs the transformers package, "
                           "which is not installed") from e
    tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
    return params, lm_cfg, (lambda t: tok.decode([t])), forward_fn(lm_cfg)


def main(argv=None) -> None:
    """``python -m sparse_coding_tpu_torch.interp.run [subcommand] ...``:

      (default)       interpret cfg.learned_dict_path's dict(s)
      read_results    print collected scores for cfg.output_folder
      run_group       interpret every *.pkl under --target
      big_sweep       final-snapshot dicts of a sweep output tree (--target)
      all_baselines   every baseline artifact under --target
      chunks          same features across each training snapshot (--target)

    Token rows come from --tokens (a .npy saved by
    data.tokenize.save_token_dataset); --device places the LM (default:
    the card); every ``InterpArgs`` field is a flag."""
    import argparse
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    sub = "interpret"
    if argv and not argv[0].startswith("-"):
        sub = argv.pop(0)
    known_subs = {"interpret", "read_results", "run_group", "big_sweep",
                  "all_baselines", "chunks"}
    if sub not in known_subs:
        raise SystemExit(f"unknown subcommand {sub!r}; one of {sorted(known_subs)}")

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--tokens", default="", help=".npy token dataset")
    pre.add_argument("--target", default="", help="root folder for the batch "
                     "drivers (run_group/big_sweep/all_baselines/chunks)")
    pre.add_argument("--device", default=None)
    extra, rest = pre.parse_known_args(argv)
    cfg = InterpArgs.from_cli(rest)

    if sub == "read_results":
        print(json.dumps(read_scores(cfg.output_folder), indent=2))
        return

    # all cheap argument validation BEFORE paying for token/LM loading
    if not extra.tokens:
        raise SystemExit("--tokens TOKENS.npy is required for this subcommand")
    if sub != "interpret" and not extra.target:
        raise SystemExit(f"--target ROOT is required for {sub}")
    if sub == "interpret" and not cfg.learned_dict_path:
        raise SystemExit("--learned_dict_path is required")

    from sparse_coding_tpu_torch.data.tokenize import load_token_dataset

    token_rows = load_token_dataset(extra.tokens)
    params, lm_cfg, decode_token, forward = _load_lm(cfg.model_name,
                                                     device=extra.device)
    common = dict(params=params, lm_cfg=lm_cfg, token_rows=token_rows,
                  decode_token=decode_token, forward=forward)

    if sub == "interpret":
        results = run_folder([cfg.learned_dict_path], cfg, **common)
    elif sub == "run_group":
        paths = sorted(str(p) for p in Path(extra.target).rglob("*.pkl"))
        results = run_folder(paths, cfg, **common)
    elif sub == "big_sweep":
        results = interpret_across_big_sweep(extra.target, cfg, **common)
    elif sub == "all_baselines":
        results = interpret_across_baselines(extra.target, cfg, **common)
    else:  # chunks
        results = interpret_across_chunks(extra.target, cfg, **common)
    n = sum(len(v) for v in results.values())
    print(f"interp {sub}: {len(results)} dict(s), {n} feature records -> "
          f"{cfg.output_folder}")


if __name__ == "__main__":
    main()
