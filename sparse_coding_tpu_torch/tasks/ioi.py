"""Indirect-object-identification (IOI) probe dataset (the port's own
copy of the JAX package's ``tasks/ioi.py``: host numpy over a tokenizer
object).

Same capability as the reference's `test_datasets/ioi.py:11-67`: templated
clean/corrupted prompt pairs (ABB→A vs ABA→B), with names/locations/objects
filtered to single tokens under the target tokenizer. Templates and word
lists are this framework's own; the contract (tokenized clean/corrupted
tensors of identical shape) matches the reference.
"""

from __future__ import annotations

import numpy as np

ABB_A_TEMPLATE = ("Afterwards, {name_a} and {name_b} went to the {location}. "
                  "{name_b} handed a {object} to {name_a}")
ABA_B_TEMPLATE = ("Afterwards, {name_a} and {name_b} went to the {location}. "
                  "{name_a} handed a {object} to {name_b}")

CANDIDATE_NAMES = [
    "James", "Mary", "John", "Linda", "Robert", "Susan", "Michael", "Karen",
    "David", "Nancy", "William", "Lisa", "Richard", "Sandra", "Thomas",
    "Sarah", "Charles", "Anna", "Daniel", "Laura", "Matthew", "Emma", "Mark",
    "Helen", "Paul", "Alice", "Steven", "Rachel", "Andrew", "Diane", "Peter",
    "Jack", "Henry", "Frank", "Ruth", "Carol", "Grace", "Alan", "Simon",
    "Kate",
]
CANDIDATE_LOCATIONS = ["park", "store", "school", "office", "beach"]
CANDIDATE_OBJECTS = ["book", "pen", "cup", "ball", "hat", "key"]


def _single_token_filter(tokenizer, words: list[str], label: str,
                         strict: bool) -> list[str]:
    kept = []
    for w in words:
        if len(tokenizer(" " + w)["input_ids"]) == 1:
            kept.append(w)
    if strict and len(kept) < len(words):
        missing = set(words) - set(kept)
        raise ValueError(f"{label} not single tokens: {sorted(missing)}")
    return kept


def generate_ioi_dataset(tokenizer, n_abb_a: int, n_abb_b: int, seed: int = 42
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (clean_tokens, corrupted_tokens), both [n, seq]; names are
    single-token-filtered, locations/objects must all be single tokens
    (mirroring the reference's validation split at ioi.py:21-44)."""
    rng = np.random.default_rng(seed)
    names = _single_token_filter(tokenizer, CANDIDATE_NAMES, "names", strict=False)
    if len(names) < 2:
        raise ValueError("fewer than 2 single-token names under this tokenizer")
    locations = _single_token_filter(tokenizer, CANDIDATE_LOCATIONS,
                                     "locations", strict=True)
    objects = _single_token_filter(tokenizer, CANDIDATE_OBJECTS, "objects",
                                   strict=True)

    clean, corrupted = [], []
    for count, (clean_t, corr_t) in ((n_abb_a, (ABB_A_TEMPLATE, ABA_B_TEMPLATE)),
                                     (n_abb_b, (ABA_B_TEMPLATE, ABB_A_TEMPLATE))):
        for _ in range(count):
            name_a, name_b = rng.choice(names, size=2, replace=False)
            kwargs = dict(name_a=name_a, name_b=name_b,
                          location=rng.choice(locations),
                          object=rng.choice(objects))
            clean.append(clean_t.format(**kwargs))
            corrupted.append(corr_t.format(**kwargs))

    clean_ids = np.asarray(tokenizer(clean)["input_ids"], np.int32)
    corrupted_ids = np.asarray(tokenizer(corrupted)["input_ids"], np.int32)
    return clean_ids, corrupted_ids
