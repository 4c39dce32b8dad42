"""Gender-by-name probe dataset preparation (the port's own copy of the
JAX package's ``tasks/gender.py``).

Same capability as the reference's
`test_datasets/preprocess_gender_dataset.py:15-46`: the UCI gender-by-name
CSV (name, gender, count, probability) filtered to names whose " name"
tokenization has an allowed token length, pickled for the erasure/probe
evals. Also provides the probe-batch builder used with
metrics.core.logistic_regression_auroc.
"""

from __future__ import annotations

import csv
import pickle
from pathlib import Path
from typing import Optional

import numpy as np

NAME_FMT = " {name}"  # leading space, as tokenized mid-sentence


def preprocess_gender_dataset(csv_path: str | Path, tokenizer,
                              min_tok_len: int = 1, max_tok_len: int = 1,
                              out_path: Optional[str | Path] = None):
    """Filter the CSV to names with min≤len(tokens)≤max; returns
    (max_tok_len, entries) and optionally pickles it — the reference's
    gender_dataset.pkl contract."""
    entries = []
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        next(reader)  # header
        for entry in reader:
            toks = tokenizer(NAME_FMT.format(name=entry[0]))["input_ids"]
            if min_tok_len <= len(toks) <= max_tok_len:
                entries.append(entry)
    result = (max_tok_len, entries)
    if out_path is not None:
        from sparse_coding_tpu_torch.resilience.atomic import atomic_pickle_dump

        atomic_pickle_dump(out_path, result)
    return result


def load_gender_dataset(pkl_path: str | Path):
    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def gender_probe_arrays(entries: list, tokenizer, n_per_class: Optional[int] = None,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(token_ids [n], labels [n]) with labels 1=female 0=male, class-balanced
    when n_per_class is set — inputs for the AUROC probes
    (metrics/core.py logistic_regression_auroc / ridge_regression_auroc,
    metrics/erasure_driver.py probe_activations)."""
    rng = np.random.default_rng(seed)
    by_class: dict[int, list[int]] = {0: [], 1: []}
    for entry in entries:
        name, gender = entry[0], entry[1]
        label = 1 if gender.upper().startswith("F") else 0
        tok = tokenizer(NAME_FMT.format(name=name))["input_ids"][0]
        by_class[label].append(tok)
    if n_per_class is not None:
        for k in by_class:
            idx = rng.permutation(len(by_class[k]))[:n_per_class]
            by_class[k] = [by_class[k][i] for i in idx]
    tokens = np.asarray(by_class[0] + by_class[1], np.int32)
    labels = np.asarray([0] * len(by_class[0]) + [1] * len(by_class[1]), np.int32)
    return tokens, labels
