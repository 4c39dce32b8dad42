"""Provider-neutral explainer/simulator clients (the port's copy of the
JAX package's ``interp/client.py``; numpy only, no torch needed).

- ``Explainer`` protocol: explain(records) -> str and
  simulate(explanation, tokens) -> predicted activations;
- ``OfflineExplainer``: deterministic token-overlap heuristic, so the whole
  interpretation pipeline (scoring included) runs offline;
- ``OpenAIExplainer``: OpenAI's neuron-explainer protocol, lazy and
  opt-in: the ``openai`` package and the credentials are read only when
  one is constructed, never at import.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Protocol, Sequence



@dataclass
class ActivationRecord:
    """One fragment shown to the explainer: decoded tokens + that feature's
    per-token activations."""

    tokens: list[str]
    activations: list[float]


class Explainer(Protocol):
    def explain(self, records: Sequence[ActivationRecord]) -> str: ...

    def simulate(self, explanation: str, tokens: Sequence[str]) -> list[float]: ...


@dataclass
class OfflineExplainer:
    """Deterministic mock protocol: the 'explanation' is the set of tokens
    that most activate the feature; simulation predicts activation
    proportional to token membership. Good enough to exercise scoring
    end-to-end and to regression-test the pipeline without any API."""

    top_n_tokens: int = 5

    _MARKER = "activates on tokens: "

    def explain(self, records: Sequence[ActivationRecord]) -> str:
        weights: dict[str, float] = {}
        for rec in records:
            for tok, act in zip(rec.tokens, rec.activations):
                weights[tok] = weights.get(tok, 0.0) + float(act)
        top = sorted(weights, key=weights.get, reverse=True)[:self.top_n_tokens]
        # JSON-encoded token list: unambiguous even when tokens contain
        # commas/quotes (a plain comma-join mis-parses "','" tokens)
        return self._MARKER + json.dumps(top)

    def simulate(self, explanation: str, tokens: Sequence[str]) -> list[float]:
        listed = explanation.split(self._MARKER, 1)[-1]
        try:
            vocab = set(json.loads(listed))
        except json.JSONDecodeError:
            vocab = set()
        return [1.0 if t in vocab else 0.0 for t in tokens]


def normalize_activations(activations: Sequence[float],
                          max_activation: float) -> list[int]:
    """The neuron-explainer discretization: activations scaled to 0-10
    integers relative to the feature's max over the shown records
    (openai/automated-interpretability
    neuron_explainer/explanations/explanations.py; negative values clamp
    to 0)."""
    if max_activation <= 0:
        return [0] * len(activations)
    return [max(0, min(10, round(10 * float(a) / max_activation)))
            for a in activations]


def _records_block(records: Sequence[ActivationRecord],
                   max_activation: float) -> str:
    """token<tab>activation lines between <start>/<end> markers — the
    TokenActivationPairExplainer activation-record format."""
    parts = []
    for rec in records:
        acts = normalize_activations(rec.activations, max_activation)
        lines = "\n".join(f"{t}\t{a}" for t, a in zip(rec.tokens, acts))
        parts.append(f"<start>\n{lines}\n<end>")
    return "\n".join(parts)


# one-shot calibration example baked into the explainer prompt, mirroring
# the library's few-shot examples (same role structure; a compact original
# example rather than OpenAI's copyrighted ones)
_FEWSHOT_RECORDS = [ActivationRecord(
    tokens=["the", "cat", "sat", "on", "a", "mat"],
    activations=[0.0, 9.1, 0.0, 0.0, 0.0, 8.7])]
_FEWSHOT_EXPLANATION = "nouns referring to physical objects and animals"

EXPLAINER_PREAMBLE = (
    "We're studying neurons in a neural network. Each neuron looks for "
    "some particular thing in a short document. Look at the parts of the "
    "document the neuron activates for and summarize in a single sentence "
    "what the neuron is looking for. Don't list examples of words.\n\n"
    "The activation format is token<tab>activation. Activation values "
    "range from 0 to 10. A neuron finding what it's looking for is "
    "represented by a non-zero activation value. The higher the "
    "activation value, the stronger the match.")

SIMULATOR_PREAMBLE = (
    "We're studying neurons in a neural network. Each neuron looks for "
    "some particular thing in a short document. Look at an explanation of "
    "what the neuron does, and try to predict its activations on each "
    "particular token.\n\n"
    "The activation format is token<tab>activation, and activations range "
    "from 0 to 10. Most activations will be 0.")


def expected_values_from_logprobs(out_tokens: Sequence[str],
                                  top_logprobs: Sequence[dict],
                                  n_tokens: int) -> list[float]:
    """The neuron-explainer calibration: for each re-emitted
    `token<TAB>digit` line, the prediction is the EXPECTED value over the
    0-10 integers in the digit position's top-logprob distribution
    (automated-interpretability
    explanations/simulator.py::compute_expected_value) — not the argmax
    digit. Parsing anchors on the TAB line structure, never on document
    tokens (a fragment token like "2024" must not be mistaken for an
    activation); a line whose activation never parses contributes 0 at its
    slot, so alignment with the true activations is preserved. Missing
    tails pad 0."""
    import math

    def as_int(tok: str):
        tok = tok.strip()
        if tok.isdigit() and 0 <= int(tok) <= 10:
            return int(tok)
        return None

    def ev(dist, fallback: int) -> float:
        if not dist:
            return float(fallback)
        num, den = 0.0, 0.0
        for cand, lp in dist.items():
            v = as_int(cand)
            if v is not None:
                p = math.exp(lp)
                num += v * p
                den += p
        return num / den if den > 0 else float(fallback)

    def continuation(i: int, raw_digits: str):
        """A two-token number split like '1'+'0' (or a fused '\\t1' followed
        by '0'): if the NEXT token is a digit string whose concatenation
        still parses as a 0-10 activation, the number extends across the
        split. Returns the combined value, else None. Without this,
        '...\\t1','0' recorded 1 and dropped the 0 — understating exactly
        the max-activation (10) positions that drive the correlation score.
        Newline boundaries end the number: a current token
        already carrying '\\n' ('1\\n'), or a next token whose digit sits
        AFTER a newline ('\\n0' — the next LINE's document token), must not
        merge."""
        if "\n" in raw_digits or i + 1 >= len(out_tokens):
            return None
        nxt = out_tokens[i + 1].rstrip("\n")  # '0\n' is digit + line end
        if nxt and nxt.isdigit():
            return as_int(raw_digits.strip() + nxt)
        return None

    evs: list[float] = []
    expect_digit = False
    i = 0
    while i < len(out_tokens) and len(evs) < n_tokens:
        tok = out_tokens[i]
        # a truncated logprobs array (e.g. around a stop sequence) degrades
        # to fallback values, it must not crash the scoring call
        dist = top_logprobs[i] if i < len(top_logprobs) else {}
        if expect_digit:
            v = as_int(tok)
            if v is not None:  # the digit token right after the tab
                combined = continuation(i, tok)
                if combined is not None:
                    # multi-token number: no single logprob position holds
                    # the value, so record it literally
                    evs.append(float(combined))
                    i += 1  # consume the continuation token
                else:
                    evs.append(ev(dist, v))
                expect_digit = False
            elif "\n" in tok:  # line ended without a parseable activation
                evs.append(0.0)
                expect_digit = False
            i += 1
            continue
        if "\t" in tok:
            tail = tok.rsplit("\t", 1)[1]
            v = as_int(tail)
            if tail and v is not None:  # tab+digit fused into one token
                combined = continuation(i, tail)
                if combined is not None:
                    evs.append(float(combined))
                    i += 1
                else:
                    evs.append(ev(dist, v))
            else:
                expect_digit = True
        i += 1
    evs += [0.0] * (n_tokens - len(evs))
    return evs


@dataclass
class OpenAIExplainer:
    """OpenAI's neuron-explainer protocol (TokenActivationPairExplainer +
    ExplanationNeuronSimulator/UncalibratedNeuronSimulator), replicated:

    - explainer: chat few-shot in the library's role structure, activation
      records discretized to 0-10 relative to the max shown activation;
    - simulator: "all at once" completion that re-emits each token line
      with a predicted activation, read back as the EXPECTED VALUE over
      the 0-10 digits in each position's logprob distribution — the
      library's calibration trick, which the correlation score then
      consumes (interp/run.py::correlation_score).

    Lazy: importing this module never touches credentials; construction
    requires them explicitly or via env. `_client` is injectable for
    hermetic tests (tests/test_torch_port_interp.py uses a fake)."""

    explainer_model: str = "gpt-4"
    simulator_model: str = "gpt-3.5-turbo-instruct"
    api_key: str | None = None
    max_tokens: int = 256
    _client: object = field(default=None, repr=False)

    def __post_init__(self):
        import os

        if self._client is not None:
            return  # injected (tests)
        key = self.api_key or os.environ.get("OPENAI_API_KEY")
        if not key:
            raise ValueError("OpenAIExplainer needs api_key or OPENAI_API_KEY")
        try:
            import openai

            self._client = openai.OpenAI(api_key=key)
        except ImportError as e:
            raise ImportError("openai package not installed; use "
                              "OfflineExplainer or install openai") from e

    def explainer_messages(self, records: Sequence[ActivationRecord]) -> list[dict]:
        max_act = max((max(r.activations, default=0.0) for r in records),
                      default=0.0)
        few_max = max(_FEWSHOT_RECORDS[0].activations)
        ask = ("\n\nNeuron 2\nActivations:\n"
               + _records_block(records, max_act)
               + "\n\nExplanation of neuron 2 behavior: this neuron "
                 "activates on")
        return [
            {"role": "system", "content": EXPLAINER_PREAMBLE},
            {"role": "user",
             "content": ("\n\nNeuron 1\nActivations:\n"
                         + _records_block(_FEWSHOT_RECORDS, few_max)
                         + "\n\nExplanation of neuron 1 behavior: this "
                           "neuron activates on")},
            {"role": "assistant", "content": " " + _FEWSHOT_EXPLANATION},
            {"role": "user", "content": ask},
        ]

    def explain(self, records: Sequence[ActivationRecord]) -> str:
        resp = self._client.chat.completions.create(
            model=self.explainer_model,
            messages=self.explainer_messages(records),
            max_tokens=self.max_tokens, temperature=1.0)
        return resp.choices[0].message.content.strip()

    def simulator_prompt(self, explanation: str,
                         tokens: Sequence[str]) -> str:
        unknowns = "\n".join(f"{t}\tunknown" for t in tokens)
        return (SIMULATOR_PREAMBLE
                + "\n\nNeuron 2\nExplanation of neuron 2 behavior: this "
                  f"neuron activates on {explanation}\n"
                  "Activations:\n<start>\n" + unknowns + "\n<end>\n\n"
                  "Now write the same list again, replacing each "
                  "\"unknown\" with the predicted activation:\n<start>\n")

    def simulate(self, explanation: str, tokens: Sequence[str]) -> list[float]:
        resp = self._client.completions.create(
            model=self.simulator_model,
            prompt=self.simulator_prompt(explanation, tokens),
            max_tokens=8 * len(tokens) + 16, temperature=0.0,
            logprobs=5, stop=["<end>"])
        lp = resp.choices[0].logprobs
        return expected_values_from_logprobs(
            lp.tokens, lp.top_logprobs, len(tokens))


def get_explainer(provider: str, **kwargs) -> Explainer:
    if provider == "offline":
        return OfflineExplainer()
    if provider == "openai":
        return OpenAIExplainer(**kwargs)
    raise ValueError(f"unknown interpretation provider {provider!r}")
