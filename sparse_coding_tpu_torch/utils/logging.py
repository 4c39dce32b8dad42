"""Run metrics logging: one JSON object per line in
``<output_folder>/metrics.jsonl`` (wandb and the obs event sink are later
work)."""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, output_folder: str | Path, run_name: str = "run",
                 flush_every: int = 50):
        self.folder = Path(output_folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.path = self.folder / "metrics.jsonl"
        self.run_name = run_name
        self._fh = open(self.path, "a")
        self._flush_every = max(1, int(flush_every))
        self._since_sync = 0

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

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
