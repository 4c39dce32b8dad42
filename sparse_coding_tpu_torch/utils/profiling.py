"""Tracing and throughput instrumentation (the port's copy of the JAX
package's ``utils/profiling.py``):

- ``trace(path)``: capture a profiler trace of any region — the managed
  capture of ``obs/trace.py`` (tmp then atomic finalize, a counted skip
  on error, stopped on every exit path);
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``);
- ``StepTimer``: wall-clock and throughput with warmup skipping.
"""

from __future__ import annotations

import contextlib
from collections import deque
from pathlib import Path
from typing import Iterator, Optional

from sparse_coding_tpu_torch.obs.spans import monotime


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[None]:
    """Capture a trace of the body into ``log_dir`` (``trace.json`` for
    Perfetto or ``chrome://tracing``, ``kernels.json``); the artifact
    appears atomically on close, and a failed capture is a counted skip,
    never an error in the profiled region."""
    from sparse_coding_tpu_torch.obs import trace as obs_trace

    with obs_trace.capture(log_dir):
        yield


def annotate(name: str):
    """A named region inside a trace (torch.profiler.record_function)."""
    import torch.profiler

    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput meter: ``tick(n_items)`` once per step, then read
    ``items_per_sec``. The first ``warmup`` steps are skipped so first-call
    costs do not pollute the rate. Ticks read the host clock without a
    sync: on the card they time dispatch, which the queue's depth ties to
    the device's pace only over many steps. ``snapshot()`` returns the
    measured window and ``publish()`` lands it in the obs registry."""

    WINDOW_KEEP = 4096  # bounds the per-step walls kept on long sweeps

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.reset()

    def reset(self) -> None:
        self._steps = 0
        self._items = 0
        self._t0: Optional[float] = None
        self.last_dt: Optional[float] = None
        self._last_tick: Optional[float] = None
        self._window_s: deque[float] = deque(maxlen=self.WINDOW_KEEP)

    def tick(self, n_items: int = 1) -> None:
        now = monotime()
        self._steps += 1
        if self._steps == self.warmup + 1:
            self._t0 = now
        elif self._steps > self.warmup + 1:
            self._items += n_items
            self.last_dt = now - (self._last_tick or now)
            self._window_s.append(self.last_dt)
        self._last_tick = now

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self._last_tick is None or self._items == 0:
            return 0.0
        dt = self._last_tick - self._t0
        return self._items / dt if dt > 0 else 0.0

    @property
    def measured_steps(self) -> int:
        return max(0, self._steps - self.warmup - 1)

    def snapshot(self) -> dict:
        """``steps``, ``items``, ``items_per_sec``, ``total_wall_s`` and the
        per-step walls after warmup (``window_s``)."""
        total = (0.0 if self._t0 is None or self._last_tick is None
                 else self._last_tick - self._t0)
        return {"steps": self.measured_steps, "items": self._items,
                "items_per_sec": self.items_per_sec,
                "total_wall_s": total, "window_s": tuple(self._window_s)}

    def publish(self, registry=None, prefix: str = "train") -> dict:
        """The snapshot as gauges ``<prefix>.items_per_sec``,
        ``.measured_steps`` and ``.wall_s``; returns it."""
        from sparse_coding_tpu_torch import obs

        reg = registry if registry is not None else obs.get_registry()
        snap = self.snapshot()
        reg.gauge(f"{prefix}.items_per_sec").set(snap["items_per_sec"])
        reg.gauge(f"{prefix}.measured_steps").set(snap["steps"])
        reg.gauge(f"{prefix}.wall_s").set(snap["total_wall_s"])
        return snap
