"""Lease files with progress heartbeats (the writer side of the JAX
package's ``resilience/lease.py``).

A process that owns a unit of supervised work atomically rewrites
``<lease>.json`` at every real progress point (a chunk flushed, a training
window finished), so a supervisor can tell a crashed owner (pid gone) from
a hung one (pid alive, heartbeat old). Heartbeats come from the work loop
on the main thread, never a side thread, which would beat on through the
very hang the watchdog is for. Hosts call :func:`beat`, a no-op unless
``SPARSE_CODING_LEASE_PATH`` is set; rewrites are throttled to one per
``interval_s``.
"""

from __future__ import annotations

import json
import os
import socket
import time
from pathlib import Path
from typing import Optional

from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

ENV_PATH = "SPARSE_CODING_LEASE_PATH"
ENV_INTERVAL = "SPARSE_CODING_LEASE_INTERVAL_S"
# the supervisor's run correlation ID, stamped into every lease write
ENV_RUN_ID = "SPARSE_CODING_RUN_ID"


class Lease:
    """Writer side: the process's claim on its unit of work."""

    def __init__(self, path: str | Path, step: str = "",
                 interval_s: float = 1.0):
        self.path = Path(path)
        self.step = step
        self.interval_s = float(interval_s)
        self._started = time.time()
        self._last_write = 0.0
        self._seq = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # claim at once: a started but not yet progressing step is live
        self.beat(force=True)

    def beat(self, force: bool = False) -> None:
        """Record progress, at most one atomic rewrite per ``interval_s``."""
        now = time.time()
        if not force and now - self._last_write < self.interval_s:
            return
        self._seq += 1
        atomic_write_text(self.path, json.dumps({
            "pid": os.getpid(), "host": socket.gethostname(),
            "step": self.step, "started_at": self._started,
            "beat_at": now, "seq": self._seq,
            "run": os.environ.get(ENV_RUN_ID, "")}))
        self._last_write = now


_active: Optional[Lease] = None
_env_checked = False


def configure(lease: Optional[Lease]) -> Optional[Lease]:
    """Install (or clear) the process's lease; returns the previous one.
    An explicit configuration wins over the environment."""
    global _active, _env_checked
    prev, _active = _active, lease
    _env_checked = True
    return prev


def configure_from_env(step: str = "") -> Optional[Lease]:
    """The process lease from ``SPARSE_CODING_LEASE_PATH`` (None when the
    variable is unset)."""
    path = os.environ.get(ENV_PATH, "").strip()
    if not path:
        configure(None)
        return None
    lease = Lease(path, step=step,
                  interval_s=float(os.environ.get(ENV_INTERVAL, "1.0")))
    configure(lease)
    return lease


def beat() -> None:
    """Progress heartbeat for work loops; configures itself from the
    environment on the first call, and costs one check without a lease."""
    global _env_checked
    if _active is None:
        if _env_checked:
            return
        _env_checked = True
        if configure_from_env() is None:
            return
    _active.beat()
