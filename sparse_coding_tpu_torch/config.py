"""Typed config/flag system: the port's copy of the JAX package's
``config.py`` (``BaseArgs``, ``DataArgs``, ``EnsembleArgs``) with the same
fields and defaults, so a config file or command line drives either side.
Fields the port does not run yet (meshes, orbax, profiling, the guardian)
are kept so configs stay interchangeable; the entry points that would read
them raise where they are set to something the port cannot do."""

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
