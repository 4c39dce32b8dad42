"""Spans and events with run/step correlation (the port's copy of the JAX
package's ``obs/spans.py``).

A span is one timed region of host work. ``record_span`` (for a region
timed by its caller) and ``span`` (a context manager) feed the registry
histogram ``span.<name>.dur_s`` and emit a ``span.end`` event. Every event
carries the run ID (``SPARSE_CODING_RUN_ID``), the step name
(``SPARSE_CODING_OBS_STEP``), the pid and a per-process sequence number.
Hot paths read the clock through :data:`monotime`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from sparse_coding_tpu_torch.obs import sink as sink_mod
from sparse_coding_tpu_torch.obs.registry import Registry, get_registry

ENV_RUN_ID = "SPARSE_CODING_RUN_ID"
ENV_STEP = "SPARSE_CODING_OBS_STEP"

monotime = time.perf_counter  # the sanctioned monotonic clock read

_seq_lock = threading.Lock()
_seq = 0


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def mint_trace_id(prefix: str = "req") -> str:
    """A process-unique correlation id for one request's critical path
    (minted at gateway admission, carried from the queue to the replica
    dispatch)."""
    return f"{prefix}-{os.getpid()}-{_next_seq()}"


def emit_event(kind: str, *, sink: Optional[sink_mod.EventSink] = None,
               **fields) -> bool:
    """One correlated event to the given (or the process) sink; a no-op
    returning False when no sink is configured."""
    target = sink if sink is not None else sink_mod.active_sink()
    if target is None:
        return False
    rec = {"ts": time.time(), "kind": kind,
           "run": os.environ.get(ENV_RUN_ID, ""),
           "step": os.environ.get(ENV_STEP, ""), "pid": os.getpid(),
           "seq": _next_seq()}
    rec.update(fields)
    return target.emit(rec)


def record_span(name: str, dur_s: float, ok: bool = True, error: str = "",
                sink: Optional[sink_mod.EventSink] = None,
                registry: Optional[Registry] = None, **attrs) -> None:
    """Record a completed span from a duration its caller measured (to
    ``sink``, else the process sink)."""
    reg = registry if registry is not None else get_registry()
    reg.histogram(f"span.{name}.dur_s").observe(dur_s)
    if not ok:
        reg.counter(f"span.{name}.errors").inc()
    emit_event("span.end", sink=sink, span=name, dur_s=round(dur_s, 6),
               ok=ok, **({"error": error} if error else {}), **attrs)


class span:
    """Context-manager form of :func:`record_span`."""

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0

    def __enter__(self) -> "span":
        self._t0 = monotime()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        record_span(self.name, monotime() - self._t0, ok=exc_type is None,
                    error=exc_type.__name__ if exc_type else "",
                    **self.attrs)


def flush_metrics(sink: Optional[sink_mod.EventSink] = None,
                  registry: Optional[Registry] = None) -> bool:
    """Emit the registry snapshot as one ``metrics`` event, at durable
    boundaries, so a killed process still leaves its last counters."""
    reg = registry if registry is not None else get_registry()
    return emit_event("metrics", sink=sink, registry=reg.snapshot())
