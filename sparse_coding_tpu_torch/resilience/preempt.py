"""Cooperative SIGTERM preemption for long sweeps (the port's copy of the
JAX package's ``resilience/preempt.py``).

Preemptible capacity sends SIGTERM, not SIGKILL: a window to save and
exit. The guard turns the signal into a flag the sweep polls at chunk
boundaries; the sweep then finishes the chunk, writes a checkpoint set and
raises :class:`SweepPreempted`, and ``resume=True`` continues bitwise.
Signal handlers are process-wide and main-thread only: the guard restores
the previous handler on exit and off the main thread is a plain flag
(``request()``).
"""

from __future__ import annotations

import signal
import threading


class SweepPreempted(RuntimeError):
    """Raised by ``train/sweep.py`` after a preemption checkpoint: state
    through ``chunks_done`` chunks is durable and ``resume=True``
    continues exactly. The CLI treats it as a clean exit."""

    def __init__(self, chunks_done: int):
        super().__init__(
            f"sweep preempted: checkpointed after chunk {chunks_done}; "
            f"resume with resume=True")
        self.chunks_done = int(chunks_done)


class PreemptionGuard:
    """Context manager installing a flag handler for SIGTERM (by
    default)."""

    def __init__(self, signals: tuple = (signal.SIGTERM,)):
        self._signals = signals
        self._event = threading.Event()
        self._previous: dict[int, object] = {}
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                prev = signal.signal(sig, self._handle)
                self._previous[sig] = prev
                # nested in another guard: a signal that guard already
                # caught is this guard's too, not lost in the hand-over
                outer = getattr(prev, "__self__", None)
                if isinstance(outer, PreemptionGuard) and outer.requested:
                    self._event.set()
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            self._installed = False

    def _handle(self, signum, frame) -> None:
        self._event.set()

    def request(self) -> None:
        """Cooperative trigger (tests, hosts with their own signal
        plumbing)."""
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()
