"""The elastic plane (the JAX package's ``pipeline/plane.py``). Only its
direction filter, :class:`Hysteresis`, is ported: the serving gateway's
ladder swap holds a candidate through it (serve/gateway.py). The arbiter,
its split journal and the scale rule belong to ROADMAP.md queue 1, item
19, which extends this file."""

from __future__ import annotations


class Hysteresis:
    """Direction filter: emits a move only after ``hold_ticks``
    CONSECUTIVE ticks vote the same direction (the admission
    controller's count-gating idiom, serve/slo.py). A changed or
    neutral vote resets the streak, so one noisy tick can never flip
    the split back and forth."""

    def __init__(self, hold_ticks: int):
        self._hold = max(1, int(hold_ticks))
        self._direction = 0
        self._streak = 0

    def vote(self, direction: int) -> int:
        """Feed one tick's vote (-1 / 0 / +1); returns the confirmed
        move (0 until the streak completes; completing resets it)."""
        direction = (direction > 0) - (direction < 0)
        if direction == 0 or direction != self._direction:
            self._direction = direction
            self._streak = 1 if direction else 0
            confirm = direction != 0 and self._streak >= self._hold
        else:
            self._streak += 1
            confirm = self._streak >= self._hold
        if confirm:
            self._streak = 0
            return direction
        return 0
