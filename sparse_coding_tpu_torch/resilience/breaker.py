"""Circuit breaker for the serving dispatch path (the port's copy of the
JAX package's ``resilience/breaker.py``).

Classic three-state machine, host-side Python only (instrumentation never
touches the device):

- **closed**: all traffic flows; ``failure_threshold`` CONSECUTIVE
  dispatch failures open the circuit.
- **open**: every dispatch (and, via the engine's admission check, every
  submit) fails fast with a typed error instead of queueing work a sick
  backend cannot serve — bounded load shedding, no wedged queue.
- **half_open**: after ``reset_timeout_s`` one probe dispatch is let
  through; success closes the circuit, failure re-opens it (and restarts
  the cooldown). Only one probe is ever in flight.

**Probe tokens.** Dispatches are concurrent, so an outcome recorded
during HALF_OPEN is not necessarily the probe's: a dispatch admitted
while the circuit was still CLOSED can finish *after* the circuit opened
and cooled down, and its stale success must not close the circuit (nor
its stale failure consume the probe). ``allow()`` therefore hands the
caller a token — ``True`` for ordinary closed-state admissions, a unique
:class:`ProbeToken` when it admits THE probe — and the caller passes that
token back to ``record_success``/``record_failure``. While HALF_OPEN,
only the current probe token's outcome transitions the state machine;
token-less (or stale-token) outcomes still update the failure counter but
cannot close the circuit or free the probe slot.

The clock is injectable so tests drive the cooldown deterministically;
``on_transition`` lets the engine mirror every state change into
``serve/metrics.py`` snapshots.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Union

TRANSITION_HISTORY = 256  # bounded: a flapping breaker must not grow RAM

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class ProbeToken:
    """Opaque truthy handle for the single HALF_OPEN probe. Identity is
    the credential: only the outcome reported with the CURRENT token
    moves the state machine out of HALF_OPEN."""

    __slots__ = ()


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self._threshold = int(failure_threshold)
        self._reset_s = float(reset_timeout_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_token: Optional[ProbeToken] = None
        self._transitions: deque[str] = deque(maxlen=TRANSITION_HISTORY)
        self._n_transitions = 0

    def set_on_transition(self,
                          cb: Optional[Callable[[str, str], None]]) -> None:
        """Attach/replace the transition mirror (the serving engine wires
        this to ServingMetrics.record_breaker_transition)."""
        with self._lock:
            self._on_transition = cb

    # -- state machine --------------------------------------------------------

    def _move(self, new: str) -> None:
        # lock held by caller
        old, self._state = self._state, new
        self._transitions.append(f"{old}->{new}")
        self._n_transitions += 1
        if self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self) -> Union[bool, ProbeToken]:
        """May a dispatch proceed right now? Returns a truthy admission
        token: ``True`` in CLOSED, a :class:`ProbeToken` when this call
        admits the single half-open probe (in OPEN past the cooldown this
        moves to HALF_OPEN first), ``False`` otherwise. Pass the returned
        token to ``record_success``/``record_failure`` so a raced
        non-probe outcome can never masquerade as the probe's."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self._reset_s:
                    self._move(HALF_OPEN)
                    self._probe_token = ProbeToken()
                    return self._probe_token
                return False
            # HALF_OPEN: only the single in-flight probe
            if self._probe_token is None:
                self._probe_token = ProbeToken()
                return self._probe_token
            return False

    def admission_allowed(self) -> bool:
        """Non-mutating submit-time check: shed new work only while the
        circuit is OPEN and the cooldown has not elapsed (a probe-eligible
        or half-open circuit still admits, so recovery traffic exists)."""
        with self._lock:
            return not (self._state == OPEN
                        and self._clock() - self._opened_at < self._reset_s)

    def _is_probe(self, token) -> bool:
        # lock held by caller
        return (isinstance(token, ProbeToken)
                and token is self._probe_token)

    def record_success(self, token: Union[bool, ProbeToken, None] = None
                       ) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == CLOSED:
                return
            # OPEN or HALF_OPEN: only the live probe's success heals —
            # a raced dispatch that was admitted before the circuit
            # opened proves nothing about the backend NOW
            if self._state == HALF_OPEN and self._is_probe(token):
                self._probe_token = None
                self._move(CLOSED)

    def record_failure(self, token: Union[bool, ProbeToken, None] = None
                       ) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                if self._is_probe(token):
                    # the probe itself failed: re-open, restart cooldown
                    self._probe_token = None
                    self._opened_at = self._clock()
                    self._move(OPEN)
                # a raced non-probe failure neither consumes the probe
                # slot nor re-opens: the probe's own outcome decides
            elif (self._state == CLOSED
                    and self._consecutive_failures >= self._threshold):
                self._opened_at = self._clock()
                self._move(OPEN)
            elif self._state == OPEN:
                # failures while open (e.g. a raced dispatch) restart the
                # cooldown — a sick backend gets its full quiet period
                self._opened_at = self._clock()

    # -- read side ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def seconds_until_probe(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._reset_s - (self._clock() - self._opened_at))

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "failure_threshold": self._threshold,
                    "reset_timeout_s": self._reset_s,
                    "probe_in_flight": self._probe_token is not None,
                    "n_transitions": self._n_transitions,
                    "transitions": list(self._transitions)}
