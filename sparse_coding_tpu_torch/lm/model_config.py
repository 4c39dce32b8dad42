"""LM architecture configs with presets for the reference's model zoo
(pythia-70m/160m/410m/1b/1.4b, gpt2 and gpt2-medium); the port's own
copy of the JAX package's ``lm/model_config.py``, same presets."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LMConfig:
    arch: str  # "gptneox" | "gpt2"
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_mlp: int
    max_seq_len: int = 2048
    rotary_pct: float = 0.25  # gptneox only
    layernorm_eps: float = 1e-5
    parallel_residual: bool = True  # gptneox only
    eos_token_id: int = 0

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def _pythia(d_model: int, n_layers: int, n_heads: int) -> LMConfig:
    return LMConfig(arch="gptneox", vocab_size=50304, d_model=d_model,
                    n_layers=n_layers, n_heads=n_heads, d_mlp=4 * d_model,
                    max_seq_len=2048, rotary_pct=0.25, eos_token_id=0)


PRESETS: dict[str, LMConfig] = {
    # EleutherAI Pythia family (deduped variants share the architecture)
    "EleutherAI/pythia-70m-deduped": _pythia(512, 6, 8),
    "EleutherAI/pythia-70m": _pythia(512, 6, 8),
    "EleutherAI/pythia-160m-deduped": _pythia(768, 12, 12),
    "EleutherAI/pythia-160m": _pythia(768, 12, 12),
    "EleutherAI/pythia-410m-deduped": _pythia(1024, 24, 16),
    "EleutherAI/pythia-410m": _pythia(1024, 24, 16),
    "EleutherAI/pythia-1b-deduped": _pythia(2048, 16, 8),
    "EleutherAI/pythia-1.4b-deduped": _pythia(2048, 24, 16),
    "EleutherAI/pythia-1.4b": _pythia(2048, 24, 16),
    "gpt2": LMConfig(arch="gpt2", vocab_size=50257, d_model=768, n_layers=12,
                     n_heads=12, d_mlp=3072, max_seq_len=1024,
                     eos_token_id=50256),
    "gpt2-medium": LMConfig(arch="gpt2", vocab_size=50257, d_model=1024,
                            n_layers=24, n_heads=16, d_mlp=4096,
                            max_seq_len=1024, eos_token_id=50256),
}


def get_config(model_name: str) -> LMConfig:
    if model_name not in PRESETS:
        raise KeyError(f"no preset for {model_name!r}; known: {sorted(PRESETS)}")
    return PRESETS[model_name]


def tiny_test_config(arch: str = "gptneox") -> LMConfig:
    """A deterministic micro-model for tests (SURVEY.md §4: replace the
    reference's network-bound integration tests with tiny random-weight
    models)."""
    return LMConfig(arch=arch, vocab_size=128, d_model=32, n_layers=3,
                    n_heads=4, d_mlp=128, max_seq_len=64,
                    eos_token_id=0 if arch == "gptneox" else 127)
