"""Counterfactual IOI dataset with template families and padded batches
(the port's own copy of the JAX package's ``tasks/ioi_counterfact.py``).

Same capability and distributional breadth as the reference's
`test_datasets/ioi_counterfact.py` (Redwood-derived): a multi-family
template bank — short/long BABA narratives, early/late indirect-object
placements, three-name ABC/BAC controls — with place/object/verb slot
substitution, counterfactual pairs swapping the indirect object, and padded
token tensors with per-sequence lengths (`gen_prompt_counterfact`
reference :282-336, `gen_ioi_dataset` :338-373, template banks :133-236).
All template wording here is this framework's own.

Slot conventions: `[A]` = indirect object (the correct completion, always
the final token), `[B]` = subject (the repeated name), `[C]` = bystander
(three-name families only), `[PLACE]`/`[OBJECT]`/`[VERB]` = content slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sparse_coding_tpu_torch.tasks.ioi import CANDIDATE_NAMES, _single_token_filter

PLACES = ["garden", "market", "library", "harbor", "square", "station",
          "bakery", "museum"]
OBJECTS = ["coin", "map", "rose", "kite", "drum", "shell", "ribbon", "bell"]
VERBS = ["offered", "passed", "handed", "carried", "brought"]

# [A]/[B] name slots, [PLACE]/[OBJECT]/[VERB] content slots. BABA ordering:
# the subject [B] is mentioned first.
BABA_TEMPLATES = [
    "Later, [B] and [A] met near the [PLACE], and [B] offered the [OBJECT] to [A]",
    "While [B] and [A] waited at the [PLACE], [B] passed the [OBJECT] to [A]",
    "Once [B] and [A] arrived at the [PLACE], [B] showed the [OBJECT] to [A]",
    "After [B] and [A] left the [PLACE], [B] returned the [OBJECT] to [A]",
    "When [B] and [A] toured the [PLACE], [B] handed the [OBJECT] to [A]",
    "Because [B] and [A] stopped by the [PLACE], [B] brought the [OBJECT] to [A]",
    "Yesterday [B] and [A] walked past the [PLACE], and [B] sold the [OBJECT] to [A]",
    "This morning [B] and [A] opened up the [PLACE], and [B] lent the [OBJECT] to [A]",
    "At noon [B] and [A] reached the [PLACE], where [B] tossed the [OBJECT] to [A]",
    "Before [B] and [A] closed the [PLACE], [B] slid the [OBJECT] to [A]",
    "Whenever [B] and [A] visited the [PLACE], [B] carried the [OBJECT] to [A]",
    "Just as [B] and [A] entered the [PLACE], [B] delivered the [OBJECT] to [A]",
    "Although [B] and [A] disliked the [PLACE], [B] still gave the [OBJECT] to [A]",
    "Since [B] and [A] worked at the [PLACE], [B] mailed the [OBJECT] to [A]",
    "As [B] and [A] crossed the [PLACE], [B] threw the [OBJECT] to [A]",
]

# longer narratives: the same family with a middle clause inserted before
# the second mention of the subject (reference: BABA_LONG_TEMPLATES)
_FILLERS = [
    "after a long day of errands",
    "though the rain had only just stopped",
    "while the evening crowd drifted home",
    "once the last customers had gone",
    "as the streetlights flickered on",
    "despite the noise from the parade",
    "just before the gates were locked",
    "while a band rehearsed nearby",
    "after the morning deliveries were done",
    "though neither had planned to stay",
    "as the fog rolled in from the river",
    "when the bells finished ringing",
    "while the vendors packed their stalls",
    "after waiting out the afternoon heat",
    "once their friends had said goodbye",
]


def _with_filler(template: str, filler: str) -> str:
    """Insert a filler clause at the second-clause boundary (the LAST comma:
    some templates open with a comma-bearing adverbial like 'Later,')."""
    cut = template.rindex(",")
    return template[:cut] + ", " + filler + template[cut:]


BABA_LONG_TEMPLATES = [_with_filler(t, f)
                       for t, f in zip(BABA_TEMPLATES, _FILLERS)]

# indirect object mentioned LATE in the opening clause (reference:
# BABA_LATE_IOS)
BABA_LATE_IOS = [
    "That afternoon [B] lingered at the [PLACE] until [A] arrived, and [B] [VERB] the [OBJECT] to [A]",
    "For an hour [B] paced around the [PLACE] waiting for [A], then [B] [VERB] the [OBJECT] to [A]",
    "All week [B] kept a stall at the [PLACE] hoping to see [A], and [B] [VERB] the [OBJECT] to [A]",
    "By the gate of the [PLACE] [B] finally spotted [A], so [B] [VERB] the [OBJECT] to [A]",
    "Near the steps of the [PLACE] [B] caught up with [A], and [B] [VERB] the [OBJECT] to [A]",
    "Inside the crowded [PLACE] [B] searched until [A] appeared, then [B] [VERB] the [OBJECT] to [A]",
    "From the far end of the [PLACE] [B] waved down [A], and [B] [VERB] the [OBJECT] to [A]",
    "Under the clock at the [PLACE] [B] waited for [A], where [B] [VERB] the [OBJECT] to [A]",
]

# indirect object mentioned FIRST (reference: BABA_EARLY_IOS; the subject
# [B] is still the repeated name)
BABA_EARLY_IOS = [
    "[A] was already at the [PLACE] when [B] walked in, and [B] [VERB] the [OBJECT] to [A]",
    "[A] had been browsing the [PLACE] as [B] arrived, so [B] [VERB] the [OBJECT] to [A]",
    "[A] stood outside the [PLACE] while [B] unlocked it, then [B] [VERB] the [OBJECT] to [A]",
    "[A] called out across the [PLACE] and [B] turned around, and [B] [VERB] the [OBJECT] to [A]",
    "[A] sat by the window of the [PLACE] until [B] showed up, and [B] [VERB] the [OBJECT] to [A]",
    "[A] kept a seat at the [PLACE] for [B] all morning, so [B] [VERB] the [OBJECT] to [A]",
    "[A] left a note at the [PLACE] that [B] found at once, and [B] [VERB] the [OBJECT] to [A]",
    "[A] wandered through the [PLACE] just as [B] closed up, and [B] [VERB] the [OBJECT] to [A]",
]

# three-name controls (reference: ABC_TEMPLATES/BAC_TEMPLATES): [C] is a
# bystander; the completion is still [A]
ABC_TEMPLATES = [
    "Then [A], [B] and [C] shared a bench at the [PLACE], and [B] [VERB] the [OBJECT] to [A]",
    "When [A], [B] and [C] toured the [PLACE] together, [B] [VERB] the [OBJECT] to [A]",
    "After [A], [B] and [C] finished lunch at the [PLACE], [B] [VERB] the [OBJECT] to [A]",
    "While [A], [B] and [C] browsed the [PLACE], [B] [VERB] the [OBJECT] to [A]",
]


def _swap_first_pair(template: str) -> str:
    """ABBA/BAC variant: swap the FIRST occurrences of [A] and [B] (the
    opening-clause mentions), leaving the later subject mention and the
    final completion slot in place. Positional, not comma-based: templates
    may open with comma-bearing adverbials ('Later,'), so cutting at the
    first comma — the reference's approach, ioi_counterfact.py:201-213 —
    would silently no-op on them."""
    ia, ib = template.index("[A]"), template.index("[B]")
    (i1, l1), (i2, l2) = sorted(((ia, "[A]"), (ib, "[B]")))
    return (template[:i1] + l2 + template[i1 + 3:i2] + l1
            + template[i2 + 3:])


ABBA_TEMPLATES = [_swap_first_pair(t) for t in BABA_TEMPLATES]
ABBA_LONG_TEMPLATES = [_swap_first_pair(t) for t in BABA_LONG_TEMPLATES]
ABBA_LATE_IOS = [_swap_first_pair(t) for t in BABA_LATE_IOS]
ABBA_EARLY_IOS = [_swap_first_pair(t) for t in BABA_EARLY_IOS]
BAC_TEMPLATES = [_swap_first_pair(t) for t in ABC_TEMPLATES]

# family name → template bank; "mixed" is the reference gen_ioi_dataset's
# default population (ABBA + BABA, ioi_counterfact.py:345)
TEMPLATE_FAMILIES: dict[str, list[str]] = {
    "baba": BABA_TEMPLATES,
    "abba": ABBA_TEMPLATES,
    "baba_long": BABA_LONG_TEMPLATES,
    "abba_long": ABBA_LONG_TEMPLATES,
    "baba_late": BABA_LATE_IOS,
    "abba_late": ABBA_LATE_IOS,
    "baba_early": BABA_EARLY_IOS,
    "abba_early": ABBA_EARLY_IOS,
    "abc": ABC_TEMPLATES,
    "bac": BAC_TEMPLATES,
    "mixed": ABBA_TEMPLATES + BABA_TEMPLATES,
}


@dataclass
class CounterfactPrompt:
    text: str
    counterfact: str  # same prompt with the recipient swapped
    subject: str  # the repeated (subject) name
    indirect_object: str  # the correct completion name


def fill_template(template: str, name_a: str, name_b: str, place: str,
                  obj: str, name_c: str = "", verb: str = "gave") -> str:
    return (template.replace("[A]", name_a).replace("[B]", name_b)
            .replace("[C]", name_c).replace("[PLACE]", place)
            .replace("[OBJECT]", obj).replace("[VERB]", verb))


def gen_prompt_counterfact(tokenizer, n_prompts: int, family: str = "baba",
                           seed: int = 0) -> list[CounterfactPrompt]:
    """(reference: gen_prompt_counterfact, ioi_counterfact.py:282-336).
    `family` is any key of TEMPLATE_FAMILIES."""
    if family not in TEMPLATE_FAMILIES:
        raise ValueError(f"unknown family {family!r}; one of "
                         f"{sorted(TEMPLATE_FAMILIES)}")
    rng = np.random.default_rng(seed)
    names = _single_token_filter(tokenizer, CANDIDATE_NAMES, "names",
                                 strict=False)
    if len(names) < 4:
        raise ValueError(
            f"fewer than 4 single-token names under this tokenizer "
            f"({len(names)}): counterfact generation draws A/B/bystander/"
            "replacement without replacement")
    templates = TEMPLATE_FAMILIES[family]
    prompts = []
    for _ in range(n_prompts):
        # 4 draws: A (indirect object), B (subject), C (bystander for the
        # three-name families), and the counterfactual replacement for A
        name_a, name_b, name_c, name_cf = rng.choice(names, size=4,
                                                     replace=False)
        t = templates[rng.integers(len(templates))]
        place = PLACES[rng.integers(len(PLACES))]
        obj = OBJECTS[rng.integers(len(OBJECTS))]
        verb = VERBS[rng.integers(len(VERBS))]
        text = fill_template(t, name_a, name_b, place, obj, name_c, verb)
        counterfact = fill_template(t, name_cf, name_b, place, obj, name_c,
                                    verb)
        prompts.append(CounterfactPrompt(text=text, counterfact=counterfact,
                                         subject=name_b,
                                         indirect_object=name_a))
    return prompts


def gen_ioi_dataset(tokenizer, n_prompts: int, family: str = "baba",
                    seed: int = 0, prompts=None):
    """Padded tensors + lengths (reference: gen_ioi_dataset,
    ioi_counterfact.py:338-373). Returns
    (tokens [n, max_len], counterfact_tokens, lengths [n], target_ids [n]).
    Pass precomputed `prompts` to tokenize an existing prompt set."""
    if prompts is None:
        prompts = gen_prompt_counterfact(tokenizer, n_prompts, family, seed)
    tok = [tokenizer(p.text)["input_ids"] for p in prompts]
    ctok = [tokenizer(p.counterfact)["input_ids"] for p in prompts]
    max_len = max(max(map(len, tok)), max(map(len, ctok)))
    pad = getattr(tokenizer, "pad_token_id", None) or 0

    def padded(seqs):
        out = np.full((len(seqs), max_len), pad, np.int32)
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s
        return out

    lengths = np.asarray([len(s) for s in tok], np.int32)
    target_ids = np.asarray(
        [tokenizer(" " + p.indirect_object)["input_ids"][0] for p in prompts],
        np.int32)
    return padded(tok), padded(ctok), lengths, target_ids


def gen_ioi_dataset_with_distractors(tokenizer, n_prompts: int,
                                     family: str = "baba", seed: int = 0):
    """Like gen_ioi_dataset but also returns the subject (repeated-name)
    token ids — the distractor completions the IOI logit-diff metric
    compares against. Prompts are generated ONCE and shared, so the
    distractor ids are aligned by construction."""
    prompts = gen_prompt_counterfact(tokenizer, n_prompts, family, seed)
    tokens, ctokens, lengths, target_ids = gen_ioi_dataset(
        tokenizer, n_prompts, family, seed, prompts=prompts)
    distractor_ids = np.asarray(
        [tokenizer(" " + p.subject)["input_ids"][0] for p in prompts],
        np.int32)
    return tokens, ctokens, lengths, target_ids, distractor_ids
