"""Crash-safe JSONL event sink: append-only, one line per event (the port's
copy of the JAX package's ``obs/sink.py``).

A failing event write drops that event, counts ``obs.sink.dropped`` and
returns: telemetry never kills the workload. Each event is written as the
JSON payload, then the newline that commits it, so a SIGKILL between the
two leaves an unterminated tail that :func:`scan_events` skips. Each
process owns its file (``<name>-<pid>.jsonl`` in
``SPARSE_CODING_OBS_DIR``).
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Optional

from sparse_coding_tpu_torch.obs.registry import get_registry
from sparse_coding_tpu_torch.resilience.faults import fault_point

ENV_OBS_DIR = "SPARSE_CODING_OBS_DIR"
FAULT_SITE = "obs.sink.write"


class EventSink:
    """One process's append-only event file. ``emit(dict)`` writes one
    JSON line and returns False (counting the drop) when it could not."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fd: Optional[int] = os.open(
            str(self.path), os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        self._lock = threading.Lock()

    def emit(self, record: dict) -> bool:
        try:
            data = json.dumps(record, default=_json_default).encode()
        except (TypeError, ValueError):
            get_registry().counter("obs.sink.dropped").inc()
            return False
        with self._lock:
            if self._fd is None:
                get_registry().counter("obs.sink.dropped").inc()
                return False
            try:
                data = fault_point(FAULT_SITE, data)
                os.write(self._fd, data)
                os.write(self._fd, b"\n")
                os.fsync(self._fd)  # each committed line is durable
            except OSError:
                get_registry().counter("obs.sink.dropped").inc()
                return False
        return True

    def close(self) -> None:
        with self._lock:
            if self._fd is None:
                return
            try:
                os.fsync(self._fd)
            except OSError:
                pass
            os.close(self._fd)
            self._fd = None


def _json_default(obj):
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


def scan_events(path: str | Path) -> tuple[list[dict], int]:
    """One event file as ``(events, skipped_lines)``: only newline-
    terminated lines that parse as a JSON object are events."""
    path = Path(path)
    if not path.exists():
        return [], 0
    lines = path.read_bytes().split(b"\n")
    skipped = 1 if lines.pop() else 0  # an unterminated (torn) tail
    events: list[dict] = []
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(rec, dict):
            events.append(rec)
        else:
            skipped += 1
    return events, skipped


def read_events(path: str | Path) -> list[dict]:
    return scan_events(path)[0]


_active: Optional[EventSink] = None
_env_checked = False
_lock = threading.Lock()


def configure(sink: Optional[EventSink]) -> Optional[EventSink]:
    """Install (or with None clear) the process sink; returns the previous
    one. An explicit configuration wins over the environment."""
    global _active, _env_checked
    with _lock:
        prev, _active = _active, sink
        _env_checked = True
    return prev


def configure_from_env(name: str = "") -> Optional[EventSink]:
    """The process sink in ``SPARSE_CODING_OBS_DIR`` (None when unset),
    named ``<name>-<pid>.jsonl``."""
    folder = os.environ.get(ENV_OBS_DIR, "").strip()
    if not folder:
        configure(None)
        return None
    label = name or os.environ.get("SPARSE_CODING_OBS_STEP", "") or "proc"
    sink = EventSink(Path(folder) / f"{label}-{os.getpid()}.jsonl")
    configure(sink)
    return sink


def active_sink() -> Optional[EventSink]:
    """The configured sink; configures itself from the environment once."""
    with _lock:
        if _active is not None or _env_checked:
            return _active
    return configure_from_env()


def close() -> None:
    """Close and clear the process sink; the next event configures it
    from the environment again."""
    global _env_checked
    sink = configure(None)
    with _lock:
        _env_checked = False
    if sink is not None:
        sink.close()
