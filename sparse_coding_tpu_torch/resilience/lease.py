"""Lease files with progress heartbeats (the port's copy of the JAX
package's ``resilience/lease.py``, in the same file format, so each side
reads the other's leases).

A process that owns a unit of supervised work atomically rewrites
``<lease>.json`` at every real progress point (a chunk flushed, a training
window finished), so a supervisor can tell a crashed owner (pid gone) from
a hung one (pid alive, heartbeat old). Heartbeats come from the work loop
on the main thread, never a side thread, which would beat on through the
very hang the watchdog is for. Hosts call :func:`beat`, a no-op unless
``SPARSE_CODING_LEASE_PATH`` is set; rewrites are throttled to one per
``interval_s``.

The reader side (:func:`read_lease`, :func:`lease_state`) classifies a
lease as ``missing``, ``dead`` (owner pid gone: take over), ``stale``
(owner alive, heartbeat old: kill, then take over) or ``live``. pid
liveness is same-host only: the supervisor and its steps share a machine.
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

ENV_PATH = "SPARSE_CODING_LEASE_PATH"
ENV_INTERVAL = "SPARSE_CODING_LEASE_INTERVAL_S"
# the supervisor's run correlation ID, stamped into every lease write
ENV_RUN_ID = "SPARSE_CODING_RUN_ID"


@dataclass
class LeaseInfo:
    """One parsed lease file."""

    pid: int
    host: str
    step: str
    started_at: float
    beat_at: float
    seq: int


class Lease:
    """Writer side: the process's claim on its unit of work."""

    def __init__(self, path: str | Path, step: str = "",
                 interval_s: float = 1.0, clock=time.time):
        self.path = Path(path)
        self.step = step
        self.interval_s = float(interval_s)
        self._clock = clock
        self._started = clock()
        self._last_write = 0.0
        self._seq = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # claim at once: a started but not yet progressing step is live
        self.beat(force=True)

    def beat(self, force: bool = False) -> None:
        """Record progress, at most one atomic rewrite per ``interval_s``."""
        now = self._clock()
        if not force and now - self._last_write < self.interval_s:
            return
        self._seq += 1
        atomic_write_text(self.path, json.dumps({
            "pid": os.getpid(), "host": socket.gethostname(),
            "step": self.step, "started_at": self._started,
            "beat_at": now, "seq": self._seq,
            "run": os.environ.get(ENV_RUN_ID, "")}))
        self._last_write = now

    def release(self) -> None:
        """Drop the claim (a clean exit: the next owner finds none)."""
        self.path.unlink(missing_ok=True)


def read_lease(path: str | Path) -> Optional[LeaseInfo]:
    """A lease file parsed, or None when it is missing or unreadable
    (atomic writes make torn files impossible, so garbage is debris from
    before a takeover, not a claim)."""
    try:
        raw = json.loads(Path(path).read_text())
        return LeaseInfo(pid=int(raw["pid"]), host=str(raw.get("host", "")),
                         step=str(raw.get("step", "")),
                         started_at=float(raw.get("started_at", 0.0)),
                         beat_at=float(raw["beat_at"]),
                         seq=int(raw.get("seq", 0)))
    except (OSError, ValueError, KeyError, TypeError):
        return None


def pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by another uid
    return True


def lease_state(path: str | Path, stale_after_s: float,
                clock=time.time) -> str:
    """``missing`` | ``dead`` | ``stale`` | ``live``: ``dead`` = owner pid
    gone (a safe takeover), ``stale`` = owner alive but no heartbeat for
    ``stale_after_s`` (hung: kill it first). A ``beat_at`` in the future
    (a clock step) counts as fresh."""
    info = read_lease(path)
    if info is None:
        return "missing"
    if not pid_alive(info.pid):
        return "dead"
    if clock() - info.beat_at > stale_after_s:
        return "stale"
    return "live"


def seed_lease(path: str | Path, pid: int, step: str = "",
               clock=time.time, run: str = "") -> None:
    """Supervisor side: stamp a just-spawned child's claim, so the hang
    window opens at spawn — a child that wedges before its first beat
    (torch's import or the card's first context) never beats, and goes
    stale like any other hang."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    now = clock()
    atomic_write_text(path, json.dumps({
        "pid": int(pid), "host": socket.gethostname(), "step": step,
        "started_at": now, "beat_at": now, "seq": 0,
        "run": run or os.environ.get(ENV_RUN_ID, "")}))


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
