"""SLO-driven admission control for the serving gateway (the port's copy
of the JAX package's ``serve/slo.py``).

At front-door scale, overload is a scheduling decision, not an accident:
when demand exceeds capacity SOMETHING will not be served, and the only
question is whether the victim is chosen (scavenger work, with a typed
retry hint) or random (every caller times out together). This module
makes the choice explicit:

- **priority classes** — ``interactive`` (a human is waiting), ``batch``
  (a job is waiting), ``scavenger`` (nobody is waiting). Requests carry
  one; admission sheds scavenger-first.
- **brownout ladder** — admission level 0 admits everything, level 1
  sheds scavenger, level 2 sheds scavenger+batch. Interactive traffic is
  never shed by the ladder — only by hard queue backpressure — which is
  what lets the gateway promise "zero interactive requests lost" through
  a replica failure.
- **closed-loop controller** — the gateway feeds its observed p99 after
  every flush; sustained p99 above ``target_p99_ms`` climbs the ladder
  one rung, sustained p99 below ``narrow_frac * target`` descends.
  Adjustment is count-gated (``adjust_every`` observations between
  moves), so the loop is deterministic under a deterministic load and
  cannot flap on a single slow dispatch.
- **deadline + queue-pressure sheds** — a request whose predicted wait
  (queue depth x recent per-row service rate, from the micro-batcher)
  already exceeds its deadline is refused NOW, not after it times out;
  lower priorities are refused earlier on the queue-depth ramp
  (``scavenger_depth_frac`` / ``batch_depth_frac`` of the hard cap).

Sheds reuse the typed contracts callers already handle:
:class:`~sparse_coding_tpu_torch.serve.batching.QueueFullError` carrying
``retry_after_s`` (the predicted drain time). Everything here is plain
host Python with no clock reads — state advances only on ``observe_p99``
/ ``admit`` calls, so tests drive it exactly.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

from sparse_coding_tpu_torch.serve.batching import QueueFullError

INTERACTIVE = "interactive"
BATCH = "batch"
SCAVENGER = "scavenger"
PRIORITIES = (INTERACTIVE, BATCH, SCAVENGER)


def priority_rank(priority: str) -> int:
    """Scheduling rank (0 = most urgent): the one ordering of the
    gateway's admission ladder and of the fleet's placement
    (pipeline/placement.py). Unknown priorities raise."""
    if priority not in PRIORITIES:
        raise ValueError(f"unknown priority {priority!r} "
                         f"(supported: {PRIORITIES})")
    return PRIORITIES.index(priority)


def windowed_quantile(samples, q: float):
    """Nearest-rank quantile over a RECENT-sample window (the gateway's
    rolling latency deque). The closed loop must read this, never a
    cumulative histogram: all-time quantiles hold an incident's slow
    tail in the p99 for tens of thousands of requests after recovery,
    pinning the brownout ladder up. Returns None on an empty window."""
    if not samples:
        return None
    ordered = sorted(samples)
    idx = min(len(ordered) - 1,
              max(0, math.ceil(q * len(ordered)) - 1))
    return ordered[idx]

# admission level -> priorities the ladder sheds at that level
_LADDER: dict[int, frozenset] = {
    0: frozenset(),
    1: frozenset({SCAVENGER}),
    2: frozenset({SCAVENGER, BATCH}),
}
MAX_LEVEL = max(_LADDER)


@dataclass(frozen=True)
class LoadSignals:
    """One typed load observation — the AUDITED struct an elastic plane
    scales the pod's serve/train split from. The
    gateway assembles it from the controllers that already compute each
    number (micro-batcher queue + service-rate EWMA, admission ladder);
    the plane never reaches into controller internals, so the seam
    between "what serving knows" and "what the arbiter acts on" is this
    one immutable record."""

    queued_rows: int                        # rows waiting right now
    queue_depth_ewma: float                 # LoadTracker's smoothed depth
    service_rate_rows_s: float | None       # batcher EWMA; None pre-traffic
    predicted_wait_s: float | None          # drain estimate for new work
    admission_level: int                    # brownout rung (0 = open)
    ticks: int = 0                          # observations folded so far
    # largest rung of the ACTIVE bucket ladder (0 = unreported): ladder
    # swaps (serve/ladder.py) surface through the same audited
    # struct the arbiter already reads, so plane breadcrumbs and tests
    # see capacity-shape changes without reaching into the gateway
    active_max_rows: int = 0


class LoadTracker:
    """Deterministic EWMA fold over load observations.

    Like everything in this module, NO clock reads — state advances only
    on :meth:`observe` calls, so a scripted observation sequence always
    produces the exact same :class:`LoadSignals` stream and the plane's
    scale decisions replay bit-for-bit in tests."""

    def __init__(self, alpha: float = 0.3):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        self._depth_ewma: float | None = None
        self._ticks = 0
        self._last: LoadSignals | None = None

    def observe(self, queued_rows: int,
                service_rate_rows_s: float | None = None,
                predicted_wait_s: float | None = None,
                admission_level: int = 0,
                active_max_rows: int = 0) -> LoadSignals:
        """Fold one observation; returns the updated snapshot."""
        rows = max(0, int(queued_rows))
        with self._lock:
            if self._depth_ewma is None:
                self._depth_ewma = float(rows)
            else:
                self._depth_ewma += self._alpha * (rows - self._depth_ewma)
            self._ticks += 1
            self._last = LoadSignals(
                queued_rows=rows,
                queue_depth_ewma=self._depth_ewma,
                service_rate_rows_s=service_rate_rows_s,
                predicted_wait_s=predicted_wait_s,
                admission_level=int(admission_level),
                ticks=self._ticks,
                active_max_rows=int(active_max_rows))
            return self._last

    def snapshot(self) -> LoadSignals:
        """Latest signals without advancing state (all-zero pre-traffic)."""
        with self._lock:
            if self._last is None:
                return LoadSignals(queued_rows=0, queue_depth_ewma=0.0,
                                   service_rate_rows_s=None,
                                   predicted_wait_s=None,
                                   admission_level=0, ticks=0)
            return self._last


class AdmissionController:
    """Brownout ladder + closed-loop p99 controller (gateway-owned)."""

    def __init__(self, target_p99_ms: float = 100.0,
                 narrow_frac: float = 0.5,
                 adjust_every: int = 32,
                 scavenger_depth_frac: float = 0.5,
                 batch_depth_frac: float = 0.85):
        if target_p99_ms <= 0:
            raise ValueError("target_p99_ms must be > 0")
        if not (0.0 < narrow_frac < 1.0):
            raise ValueError("narrow_frac must be in (0, 1)")
        if not (0.0 < scavenger_depth_frac <= batch_depth_frac <= 1.0):
            raise ValueError("need 0 < scavenger_depth_frac <= "
                             "batch_depth_frac <= 1")
        self.target_p99_ms = float(target_p99_ms)
        self._narrow_frac = float(narrow_frac)
        self._adjust_every = max(1, int(adjust_every))
        self._depth_frac = {SCAVENGER: float(scavenger_depth_frac),
                            BATCH: float(batch_depth_frac),
                            INTERACTIVE: 1.0}
        self._lock = threading.Lock()
        self._level = 0
        self._since_change = 0
        self._n_widened = 0
        self._n_narrowed = 0

    # -- closed loop ----------------------------------------------------------

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def set_level(self, level: int) -> None:
        """Operator override (drills, tests): pin the ladder rung."""
        if level not in _LADDER:
            raise ValueError(f"admission level must be in "
                             f"{sorted(_LADDER)}, got {level}")
        with self._lock:
            self._level = level
            self._since_change = 0

    def observe_p99(self, p99_ms: float | None) -> int:
        """Feed one p99 observation (the gateway calls this after every
        flush with its latency histogram's current p99); returns the
        possibly-adjusted level. Count-gated: at most one rung move per
        ``adjust_every`` observations."""
        with self._lock:
            if p99_ms is None:
                return self._level
            self._since_change += 1
            if self._since_change < self._adjust_every:
                return self._level
            if p99_ms > self.target_p99_ms and self._level < MAX_LEVEL:
                self._level += 1
                self._n_widened += 1
                self._since_change = 0
            elif (p99_ms < self.target_p99_ms * self._narrow_frac
                    and self._level > 0):
                self._level -= 1
                self._n_narrowed += 1
                self._since_change = 0
            return self._level

    # -- per-request admission ------------------------------------------------

    def admit(self, priority: str, deadline_s: float | None,
              queued_rows: int, max_queue_rows: int,
              predicted_wait_s: float | None) -> None:
        """Admit or raise a typed shed for one request. Shed reasons, in
        check order: brownout ladder (priority shed at the current
        level), queue-depth ramp (lower priorities refused earlier), and
        deadline (predicted wait already exceeds it)."""
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(supported: {PRIORITIES})")
        with self._lock:
            shed_priorities = _LADDER[self._level]
        if priority in shed_priorities:
            raise QueueFullError(queued_rows, max_queue_rows,
                                 predicted_wait_s)
        if queued_rows > self._depth_frac[priority] * max_queue_rows:
            raise QueueFullError(queued_rows, max_queue_rows,
                                 predicted_wait_s)
        if (deadline_s is not None and predicted_wait_s is not None
                and predicted_wait_s > deadline_s):
            raise QueueFullError(queued_rows, max_queue_rows,
                                 predicted_wait_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {"level": self._level,
                    "target_p99_ms": self.target_p99_ms,
                    "sheds_priorities": sorted(_LADDER[self._level]),
                    "widened": self._n_widened,
                    "narrowed": self._n_narrowed}
