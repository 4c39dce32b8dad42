"""Replica health scoring for the serving gateway (the port's copy of the
JAX package's ``serve/health.py``).

Routing a front door needs one number per replica that answers "how
likely is the NEXT dispatch here to come back fast and correct?". The
circuit breaker is a binary answer (sick / not sick) with hysteresis;
this module adds the continuous one: an **EWMA health score** fed by
every dispatch outcome — success/failure and latency — so the gateway
can prefer the fastest healthy replica long before anything trips, and
hedges route to the *next-healthiest* rather than a random peer
("Ensembling Sparse Autoencoders", PAPERS.md, motivates replica pools as
the unit of redundancy; health-weighting is what makes a pool better
than round-robin).

Score formula (deterministic, host-side Python only):

    ok_ewma  <- (1-a) * ok_ewma  + a * (1 if ok else 0)     (starts 1.0)
    lat_ewma <- (1-a) * lat_ewma + a * dur_s                (starts 0.0)
    score = ok_ewma / (1 + lat_ewma / latency_scale_s)

A perfect replica scores 1.0; errors decay the numerator, latency grows
the denominator, and both heal with fresh good outcomes at the same EWMA
rate. ``latency_scale_s`` sets how much latency it takes to halve the
score (default 50 ms, the JAX package's default).
"""

from __future__ import annotations

import threading


class EwmaHealth:
    """Thread-safe EWMA health score over dispatch outcomes."""

    def __init__(self, alpha: float = 0.2, latency_scale_s: float = 0.05):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if latency_scale_s <= 0:
            raise ValueError("latency_scale_s must be > 0")
        self._alpha = float(alpha)
        self._latency_scale_s = float(latency_scale_s)
        self._lock = threading.Lock()
        # optimistic start: a fresh (warm) replica must be routable —
        # a pessimistic 0.0 start would starve it of the traffic that
        # would prove it healthy
        self._ok = 1.0
        self._lat = 0.0
        self._n = 0

    def record(self, dur_s: float, ok: bool) -> None:
        """Fold one dispatch outcome in. Failures count their wall too:
        a replica that fails slowly is worse than one that fails fast."""
        a = self._alpha
        with self._lock:
            self._ok = (1 - a) * self._ok + (a if ok else 0.0)
            self._lat = (1 - a) * self._lat + a * max(0.0, float(dur_s))
            self._n += 1

    @property
    def score(self) -> float:
        """Health in (0, 1]: 1.0 = always succeeding instantly."""
        with self._lock:
            return self._ok / (1.0 + self._lat / self._latency_scale_s)

    @property
    def observations(self) -> int:
        with self._lock:
            return self._n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "score": self._ok / (1.0 + self._lat
                                     / self._latency_scale_s),
                "ok_ewma": self._ok,
                "latency_ewma_s": self._lat,
                "observations": self._n,
            }
