"""Crash-safe managed capture on PyTorch's Kineto profiler (the port's
counterpart of the JAX package's ``obs/trace.py``, which wraps
``jax.profiler``).

Every capture is:

- **bounded and explicit**: :class:`TraceCapture` is the begin()/end()
  state machine for loop hosts (the sweep opens the window at one step
  boundary and closes it N steps later); :func:`capture` is the
  context-manager form with try/finally semantics;
- **fault-isolated**: the fault site ``obs.trace.capture`` covers begin
  AND finalize; any error is a counted skip (``obs.trace.skipped``) that
  never kills the workload it was profiling;
- **atomic on disk**: the profiler's output is written into a tmp
  sibling of the destination; ``end()`` stops the profiler, writes the
  trace, crosses the ``obs.trace.capture`` crash barrier (tmp durable,
  final name not yet present), then renames tmp into place. A reader sees
  a complete capture or none.

A capture directory holds ``trace.json`` (the Chrome trace:
``chrome://tracing`` or Perfetto; on the card its device events name the
CUDA kernels that ran) and ``kernels.json``, the device kernels by name
with their launch count and device time (``key_averages()``; empty on the
CPU, which has no device events). A finished capture counts
``obs.trace.captured`` and emits a ``trace.captured`` event.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
from pathlib import Path
from typing import Iterator, Optional

from sparse_coding_tpu_torch.obs.registry import get_registry
from sparse_coding_tpu_torch.obs.spans import emit_event, monotime
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)

SITE = "obs.trace.capture"
TRACE_NAME = "trace.json"
KERNELS_NAME = "kernels.json"

register_fault_site(SITE,
                    "managed profiler capture — begin and atomic finalize "
                    "(obs/trace.py); error = counted skip, never fatal")
register_crash_site(SITE,
                    "profiler stopped, trace tmp dir durable, final "
                    "rename not yet performed (obs/trace.py)")


def device_kernels(prof) -> dict[str, dict]:
    """The device kernels of a stopped profile by name: ``{name: {"count",
    "device_ms"}}`` (empty when nothing ran on a device)."""
    out: dict[str, dict] = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        # a device kernel has device time and none on the host
        if dev_us and not getattr(ev, "self_cpu_time_total", 0.0):
            out[ev.key] = {"count": int(ev.count),
                           "device_ms": round(dev_us / 1e3, 6)}
    return dict(sorted(out.items()))


class TraceCapture:
    """One managed capture window into ``out_dir``.

    ``begin()`` returns whether profiling started (False = a counted skip:
    the host should not retry the window); ``end()`` is idempotent and
    safe in a host's finally. A failed or torn capture never raises into
    the host and never leaves a partial artifact under the final name."""

    def __init__(self, out_dir: str | Path):
        self.out_dir = Path(out_dir)
        self._tmp = self.out_dir.parent / \
            f".{self.out_dir.name}.tmp.{os.getpid()}"
        self._prof = None
        self._t0 = 0.0
        self._begin_s = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _skip(self, stage: str) -> None:
        get_registry().counter("obs.trace.skipped").inc()
        emit_event("trace.skipped", dir=str(self.out_dir), stage=stage)
        shutil.rmtree(self._tmp, ignore_errors=True)

    def begin(self) -> bool:
        """Start the profiler (CPU, and CUDA when a card is present).
        Returns False (counted, tmp cleaned) on any error."""
        if self._prof is not None:
            return True
        try:
            import torch
            from torch.autograd import profiler as autograd_profiler

            # debris of a KILLED capture: one capture host per out_dir,
            # so any sibling tmp is an orphan, never a live writer's
            for stale in self.out_dir.parent.glob(
                    f".{self.out_dir.name}.tmp.*"):
                shutil.rmtree(stale, ignore_errors=True)
            self._tmp.mkdir(parents=True, exist_ok=True)
            fault_point(SITE)
            t0 = monotime()
            # the Kineto profiler that torch.profiler.profile wraps: the
            # wrapper's start imports torch._inductor to read one flag,
            # 8.6 s of a step child's start on the H100 host
            prof = autograd_profiler.profile(
                use_device="cuda" if torch.cuda.is_available() else None,
                use_kineto=True)
            prof.__enter__()
        except Exception:  # noqa: BLE001 — counted skip by contract
            self._skip("begin")
            return False
        self._prof = prof
        self._t0 = monotime()
        self._begin_s = self._t0 - t0
        return True

    def end(self) -> Optional[Path]:
        """Stop the profiler and atomically finalize the capture into
        ``out_dir``; returns the final path, or None for a no-op or a
        failed finalize (counted). Idempotent."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        t_end = monotime()
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(self._tmp / TRACE_NAME))
            kernels = device_kernels(prof)
            (self._tmp / KERNELS_NAME).write_text(
                json.dumps(kernels, indent=2, sort_keys=True))
            # the worst instant: the capture whole in tmp, the final name
            # absent — a SIGKILL here costs only the trace
            crash_barrier(SITE)
            fault_point(SITE)
            if self.out_dir.exists():
                # a recapture replaces the old artifact whole
                shutil.rmtree(self.out_dir)
            self._tmp.rename(self.out_dir)
        except Exception:  # noqa: BLE001 — counted skip by contract
            self._skip("finalize")
            return None
        now = monotime()
        get_registry().counter("obs.trace.captured").inc()
        # what the capture cost its host: starting the profiler, and
        # stopping it through the rename
        emit_event("trace.captured", dir=str(self.out_dir),
                   dur_s=round(now - self._t0, 3),
                   begin_s=round(self._begin_s, 3),
                   finalize_s=round(now - t_end, 3),
                   device_kernels=len(kernels))
        return self.out_dir


@contextlib.contextmanager
def capture(out_dir: str | Path) -> Iterator[TraceCapture]:
    """Profile the body into ``out_dir``, stopped and finalized on every
    exit path (the body's exception still propagates)."""
    cap = TraceCapture(out_dir)
    cap.begin()
    try:
        yield cap
    finally:
        cap.end()
