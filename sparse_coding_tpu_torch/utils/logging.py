"""Run metrics logging: one JSON object per line in
``<output_folder>/metrics.jsonl``, always; with ``use_wandb`` the same
metrics also go to a wandb run when ``wandb`` imports and its run starts
(the JAX package's contract: without it, or offline, the file alone).
Spans and events go to the obs sink, ``obs/sink.py``."""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Optional

_log = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, output_folder: str | Path, use_wandb: bool = False,
                 run_name: str = "run", config: Optional[dict] = None,
                 flush_every: int = 50):
        self.folder = Path(output_folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.path = self.folder / "metrics.jsonl"
        self.run_name = run_name
        self._fh = open(self.path, "a")
        self._flush_every = max(1, int(flush_every))
        self._since_sync = 0
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(project="sparse_coding_tpu",
                                        name=run_name, config=config or {})
            except Exception as e:  # not installed, or offline
                _log.warning("wandb unavailable (%s); metrics go to %s only",
                             e, self.path)

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"ts": time.time(),
               **({"step": step} if step is not None else {}), **metrics}
        # one write per line, flushed, so a crash never tears a record
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self._since_sync += 1
        if self._since_sync >= self._flush_every:
            os.fsync(self._fh.fileno())
            self._since_sync = 0
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        if self.wandb is not None:
            self.wandb.finish()
            self.wandb = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_hyperparam_name(hyperparams: dict[str, Any]) -> str:
    """A stable stream name from hyperparameters (sorted keys; floats as
    ``%.2e``), the JAX package's naming."""
    return "_".join(f"{k}{v:.2e}" if isinstance(v, float) else f"{k}{v}"
                    for k, v in sorted(hyperparams.items()))
