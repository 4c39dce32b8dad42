"""Typed config/flag system: the port's copy of the JAX package's
``config.py`` (``BaseArgs``, ``DataArgs``, ``EnsembleArgs``,
``SyntheticEnsembleArgs``, ``BigSAEArgs``, ``ToyArgs``, ``ErasureArgs``,
``InterpArgs``, ``InterpGraphArgs``, ``InvestigateArgs``)
with the same fields and defaults, so a config file or command line
drives either side. Fields the port does not run yet (meshes, trace
capture through ``profile_steps``, wandb) are kept so configs stay
interchangeable; the entry points that would read them raise where they
are set to something the port cannot do, naming the ROADMAP.md item."""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, Optional, Sequence, Type, TypeVar

T = TypeVar("T", bound="BaseArgs")

_PRIMITIVES = (int, float, str, bool)


def _parse_value(raw: str, ftype: Any) -> Any:
    if ftype is bool:
        return raw.lower() in ("1", "true", "t", "yes", "y")
    if ftype in (int, float, str):
        return ftype(raw)
    # lists / optionals / anything else: accept JSON
    return json.loads(raw)


def _field_runtime_type(cls: type, name: str) -> Any:
    """Resolve a dataclass field's runtime type from string annotations."""
    t = typing.get_type_hints(cls).get(name, str)
    if typing.get_origin(t) is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(t) if a is not type(None)]
        t = args[0] if args else str
    return t if t in _PRIMITIVES else list


@dataclass
class BaseArgs:
    """Base config: every subclass gets ``from_cli()`` and ``to_dict()``."""

    @classmethod
    def from_cli(cls: Type[T], argv: Optional[Sequence[str]] = None) -> T:
        parser = argparse.ArgumentParser(description=cls.__name__)
        for f in fields(cls):
            parser.add_argument(f"--{f.name}", type=str, default=None)
        ns, _ = parser.parse_known_args(argv)
        overrides = {}
        for f in fields(cls):
            raw = getattr(ns, f.name)
            if raw is not None:
                overrides[f.name] = _parse_value(
                    raw, _field_runtime_type(cls, f.name))
        return cls(**overrides)

    def to_dict(self) -> dict[str, Any]:
        return {f.name: (str(v) if isinstance(v, Path) else v)
                for f in fields(self) for v in [getattr(self, f.name)]}

    def save(self, path: str | Path) -> None:
        from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(path, json.dumps(self.to_dict(), indent=2,
                                           default=str))

    @classmethod
    def load(cls: Type[T], path: str | Path) -> T:
        data = json.loads(Path(path).read_text())
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def replace(self: T, **kwargs: Any) -> T:
        return dataclasses.replace(self, **kwargs)


LAYER_LOCS = ("residual", "mlp", "attn", "attn_concat", "mlpout")


@dataclass
class DataArgs(BaseArgs):
    """Activation-harvesting / dataset config."""

    model_name: str = "EleutherAI/pythia-70m-deduped"
    dataset_name: str = "NeelNanda/pile-10k"
    dataset_folder: str = "activation_data"
    layers: list[int] = field(default_factory=lambda: [2])
    layer_loc: str = "residual"
    context_len: int = 256
    model_batch_size: int = 4
    chunk_size_gb: float = 2.0
    n_chunks: int = 1
    skip_chunks: int = 0
    center_dataset: bool = False
    activation_dtype: str = "bfloat16"
    max_docs: Optional[int] = None
    seed: int = 0
    scan_batches: int = 1


@dataclass
class EnsembleArgs(BaseArgs):
    """Ensemble sweep config."""

    output_folder: str = "output"
    dataset_folder: str = "activation_data"
    batch_size: int = 1024
    lr: float = 1e-3
    adam_epsilon: float = 1e-8
    use_wandb: bool = False
    wandb_images: bool = False
    dtype: str = "float32"
    layer: int = 2
    layer_loc: str = "residual"
    tied_ae: bool = False
    seed: int = 0
    learned_dict_ratio: float = 4.0
    n_chunks: int = 10
    n_repetitions: int = 1
    center_activations: bool = False
    mesh_data: int = 1
    mesh_model: int = 1
    save_every_chunks: Optional[int] = None
    checkpoint_every_chunks: int = 1
    train_dtype: str = "float32"
    checkpoint_backend: str = "msgpack"
    profile_steps: int = 0
    perf_probe_every: int = 32
    # steps per Ensemble.run_steps window (a Python loop in the port)
    scan_steps: int = 1
    ingest_streams: int = 0
    guardian: bool = True
    guardian_member_fraction: float = 0.5
    guardian_rollback_budget: int = 4
    sentinel: bool = True
    use_fused: str = "auto"
    # pin the kernel path (None = the card's default, train_step_tiled)
    fused_path: Optional[str] = None
    fused_batch_tile: Optional[int] = None
    fused_feat_tile: Optional[int] = None
    fused_interpret: bool = False


@dataclass
class SyntheticEnsembleArgs(EnsembleArgs):
    """A sweep over synthetic data (``train/sweep.py::
    init_synthetic_dataset`` writes it to ``dataset_folder``)."""

    n_ground_truth_features: int = 512
    activation_dim: int = 256
    feature_prob_decay: float = 0.99
    feature_num_nonzero: int = 5
    correlated_components: bool = False
    noise_magnitude_scale: float = 0.0
    dataset_size: int = 200_000


@dataclass
class BigSAEArgs(BaseArgs):
    """Large single-SAE trainer (``train/big_sae.py``): big batch,
    dead-feature resurrection."""

    activation_dim: int = 1024
    n_feats: int = 16384
    l1_alpha: float = 1e-3
    lr: float = 1e-3
    batch_size: int = 65536
    dataset_folder: str = "activation_data"
    output_folder: str = "big_sae_output"
    n_chunks: int = 10
    n_epochs: int = 1
    dead_feature_window: int = 100  # steps with no activation => dead
    resurrect_every: int = 500
    mesh_data: int = 1
    seed: int = 0
    # steps per window (a Python loop in the port); resurrection and
    # logging run at window boundaries, so the effective interval rounds
    # up to a multiple of scan_steps
    scan_steps: int = 1


@dataclass
class ToyArgs(BaseArgs):
    """Toy-model replication (``train/toy_models.py``)."""

    n_ground_truth_features: int = 256
    activation_dim: int = 128
    feature_prob_decay: float = 0.99
    feature_num_nonzero: int = 5
    correlated_components: bool = False
    learned_dict_ratio: float = 1.0
    l1_alpha: float = 1e-3
    lr: float = 1e-3
    batch_size: int = 256
    epochs: int = 1
    dataset_size: int = 100_000
    seed: int = 0


@dataclass
class ErasureArgs(BaseArgs):
    """Concept-erasure eval (``metrics/erasure_driver.py``)."""

    model_name: str = "EleutherAI/pythia-410m-deduped"
    layers: list[int] = field(default_factory=lambda: [4])
    layer_loc: str = "residual"
    dict_path: str = ""
    output_folder: str = "erasure_output"
    max_edit_feats: int = 64
    seed: int = 0


@dataclass
class InterpArgs(BaseArgs):
    """Auto-interpretation config (``interp/run.py``)."""

    model_name: str = "EleutherAI/pythia-70m-deduped"
    layer: int = 2
    layer_loc: str = "residual"
    learned_dict_path: str = ""
    output_folder: str = "interp_output"
    n_feats_to_explain: int = 10
    fragment_len: int = 64
    n_fragments: int = 5000
    top_k_fragments: int = 10
    n_random_fragments: int = 10
    batch_size: int = 20
    provider: str = "offline"  # offline | openai (credentials read lazily)
    explainer_model: str = "gpt-4"
    simulator_model: str = "text-davinci-003"
    seed: int = 0
    # the JAX package's fused fragment batches per device program; kept
    # for its CLI and has no effect here (interp/fragments.py)
    scan_batches: int = 1


@dataclass
class InterpGraphArgs(BaseArgs):
    """Ablation-graph interpretation config (``interp/graph.py``)."""

    model_name: str = "EleutherAI/pythia-70m-deduped"
    layers: list[int] = field(default_factory=lambda: [0, 2])
    layer_loc: str = "residual"
    dict_paths: list[str] = field(default_factory=list)
    output_folder: str = "interp_graph_output"
    n_fragments: int = 64
    fragment_len: int = 32
    positional: bool = False
    seed: int = 0


@dataclass
class InvestigateArgs(BaseArgs):
    """Single-feature investigation config (``interp/graph.py``)."""

    model_name: str = "EleutherAI/pythia-70m-deduped"
    layer: int = 2
    layer_loc: str = "residual"
    learned_dict_path: str = ""
    feature_indices: list[int] = field(default_factory=list)
    n_fragments: int = 1000
    fragment_len: int = 64
    output_folder: str = "investigate_output"
    seed: int = 0
