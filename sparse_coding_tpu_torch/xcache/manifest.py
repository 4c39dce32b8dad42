"""Warmup manifest: the durable record of every program a process
prepared (the port's copy of the JAX package's ``xcache/manifest.py``).

``cached_capture(..., manifest_desc=...)`` records one descriptor per
distinct program — the serve engine records ``(model, op, bucket)`` — so
a restarted process (and an operator reading the cache dir) knows the
FULL program set a deployment needs captured before it admits traffic.
The serve engine's ``warmup_from_manifest()`` walks exactly this set for
its registry.

Descriptors are data, not code: a descriptor cannot be replayed by itself
— the owning subsystem maps it back to a function and captures it anew
(a CUDA graph does not outlive its process). Writes are read-modify-write
through ``resilience.atomic`` and idempotent (a descriptor is its own
key), so concurrent processes can record freely.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Optional


class WarmupManifest:
    """``<cache_dir>/warmup.json``: {descriptor-key: descriptor}."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()

    def _read(self) -> dict:
        try:
            data = json.loads(self.path.read_text())
            if isinstance(data, dict):
                return data
        except (OSError, ValueError):
            pass
        return {}

    def record(self, desc: dict) -> None:
        """Idempotently add one program descriptor (a plain JSON dict)."""
        key = json.dumps(desc, sort_keys=True, default=str)
        with self._lock:
            data = self._read()
            if data.get(key) == desc:
                return
            data[key] = desc
            from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

            self.path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_text(self.path,
                              json.dumps(data, sort_keys=True, default=str))

    def descriptors(self, kind: Optional[str] = None) -> list[dict]:
        data = self._read()
        out = [v for v in data.values() if isinstance(v, dict)]
        if kind is not None:
            out = [d for d in out if d.get("kind") == kind]
        return out

    def __len__(self) -> int:
        return len(self._read())
