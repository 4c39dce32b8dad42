"""Serving observability: the obs registry behind the serving snapshot
(the port's copy of the JAX package's ``serve/metrics.py``).

Everything here is plain host-side Python — the metrics path never
touches the device, or instrumentation itself would add launches and
syncs to the hot loop. The counters, gauges and histograms live in a
:class:`sparse_coding_tpu_torch.obs.Registry`, while ``snapshot()`` keeps
the JAX package's schema and its exact ring-buffer latency quantiles.

The one invariant the snapshot exists to prove is ``recompiles == 0``
after warmup: in the port a "recompile" is a CUDA-graph capture after
``warmup()`` — a shape escaped the bucket ladder and the engine paid a
capture in a latency-sensitive path.

Instrument names (labels carry the bucket): ``serve.requests``,
``serve.rejected``, ``serve.shed``, ``serve.dispatch_retries``,
``serve.dispatch_failures``, ``serve.recompiles``,
``serve.request_errors{type=..}``, ``serve.breaker_transitions``,
``serve.queue_rows`` (gauge; its high-water mark is the max),
``serve.batches{bucket=..}`` / ``serve.batch_requests`` / ``serve.rows``
/ ``serve.deadline_flushes``, ``serve.latency_s{bucket=..}`` (histogram),
``serve.request_rows`` (row-valued histogram — the rolling request-size
distribution ladder derivation snapshots, serve/ladder.py), and the
continuous-rebatching counters ``serve.rebatch.joined`` /
``serve.rebatch.joined_rows`` / ``serve.rebatch.rejected``.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Optional

from sparse_coding_tpu_torch.obs.registry import Registry
from sparse_coding_tpu_torch.serve.ladder import REQUEST_ROW_BOUNDS


def _quantile_ms(samples: list[float], q: float) -> float | None:
    """Nearest-rank quantile of a list of second-valued latencies, in ms."""
    if not samples:
        return None
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))
    return ordered[idx] * 1e3


class ServingMetrics:
    """Thread-safe counters shared by the engine, the batcher, and the
    offline driver. ``snapshot()`` is the only read surface; ``registry``
    exposes the same numbers as obs instruments.

    Each engine owns a PRIVATE registry by default (two engines in one
    process must not sum their queues); pass ``registry=`` — e.g.
    ``obs.get_registry()`` — to publish into a shared one."""

    def __init__(self, latency_window: int = 4096,
                 registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        self._lock = threading.Lock()
        self._latency_window = latency_window
        self._buckets: set[int] = set()
        self._latencies: dict[int, deque[float]] = {}
        self._recompile_keys: list[tuple] = []
        self._queued_rows = 0
        self._error_types: set[str] = set()
        self._breaker_state = "closed"
        # bounded mirror of the breaker's history: a flapping backend
        # cycling open/half_open for days must not grow the snapshot
        self._breaker_transitions: deque[str] = deque(maxlen=256)
        r = self.registry
        self._submitted = r.counter("serve.requests")
        self._rejected = r.counter("serve.rejected")
        self._shed = r.counter("serve.shed")
        self._retries = r.counter("serve.dispatch_retries")
        self._failures = r.counter("serve.dispatch_failures")
        self._recompiles = r.counter("serve.recompiles")
        self._n_transitions = r.counter("serve.breaker_transitions")
        self._queue_gauge = r.gauge("serve.queue_rows")
        # the rolling request-size distribution (row-valued bounds, not
        # the latency default): ladder derivation's primary input
        self._request_rows = r.histogram("serve.request_rows",
                                         bounds=REQUEST_ROW_BOUNDS)
        self._rebatch_joined = r.counter("serve.rebatch.joined")
        self._rebatch_joined_rows = r.counter("serve.rebatch.joined_rows")
        self._rebatch_rejected = r.counter("serve.rebatch.rejected")

    # -- write side (engine / batcher) --------------------------------------

    def record_enqueue(self, rows: int) -> None:
        self._submitted.inc()
        self._request_rows.observe(rows)
        with self._lock:
            self._queued_rows += rows
            self._queue_gauge.set(self._queued_rows)

    def record_dequeue(self, rows: int) -> None:
        with self._lock:
            self._queued_rows = max(0, self._queued_rows - rows)
            self._queue_gauge.set(self._queued_rows)

    def record_reject(self) -> None:
        self._rejected.inc()

    def record_batch(self, bucket: int, n_requests: int, rows: int,
                     deadline_flush: bool) -> None:
        with self._lock:
            self._buckets.add(bucket)
        r = self.registry
        r.counter("serve.batches", bucket=bucket).inc()
        r.counter("serve.batch_requests", bucket=bucket).inc(n_requests)
        r.counter("serve.rows", bucket=bucket).inc(rows)
        if deadline_flush:
            r.counter("serve.deadline_flushes", bucket=bucket).inc()

    def record_rebatch(self, joined: int, joined_rows: int,
                       rejected: int = 0) -> None:
        """One flush's continuous-rebatching outcome: ``joined``
        late-arriving requests (``joined_rows`` rows of pad they filled)
        merged into the in-flight assembly; ``rejected`` counts a stream
        head that was present but did not fit the remaining rows."""
        if joined:
            self._rebatch_joined.inc(joined)
            self._rebatch_joined_rows.inc(joined_rows)
        if rejected:
            self._rebatch_rejected.inc(rejected)

    def record_latency(self, bucket: int, seconds: float) -> None:
        with self._lock:
            self._buckets.add(bucket)
            q = self._latencies.get(bucket)
            if q is None:
                q = self._latencies[bucket] = deque(
                    maxlen=self._latency_window)
            q.append(seconds)
        self.registry.histogram("serve.latency_s", bucket=bucket).observe(
            seconds)

    def record_recompile(self, key: tuple) -> None:
        self._recompiles.inc()
        with self._lock:
            self._recompile_keys.append(key)

    def record_request_errors(self, n: int, error_type: str) -> None:
        """n requests in one flush failed with the given error type."""
        with self._lock:
            self._error_types.add(error_type)
        self.registry.counter("serve.request_errors", type=error_type).inc(n)

    def record_dispatch_retry(self) -> None:
        self._retries.inc()

    def record_dispatch_failure(self) -> None:
        self._failures.inc()

    def record_shed(self, n: int = 1) -> None:
        """n requests refused without device work (open breaker)."""
        self._shed.inc(n)

    def record_breaker_transition(self, old: str, new: str) -> None:
        self._n_transitions.inc()
        with self._lock:
            self._breaker_state = new
            self._breaker_transitions.append(f"{old}->{new}")

    # -- read side -----------------------------------------------------------

    @property
    def recompiles(self) -> int:
        return self._recompiles.value

    @property
    def queued_rows(self) -> int:
        with self._lock:
            return self._queued_rows

    def snapshot(self) -> dict:
        """One coherent dict of everything: per-bucket request counts, fill
        ratios (rows served / bucket capacity dispatched), latency p50/p99,
        queue-depth high-water mark, rejections, and the recompile counter
        (with the offending (model, op, bucket) keys when nonzero)."""
        r = self.registry
        with self._lock:
            bucket_sizes = sorted(self._buckets)
            latencies = {b: list(q) for b, q in self._latencies.items()}
            recompile_keys = list(self._recompile_keys)
            error_types = set(self._error_types)
            breaker_state = self._breaker_state
            breaker_transitions = list(self._breaker_transitions)
            queued = self._queued_rows
        buckets = {}
        all_lat: list[float] = []
        for size in bucket_sizes:
            lat = latencies.get(size, [])
            all_lat.extend(lat)
            batches = r.counter("serve.batches", bucket=size).value
            rows = r.counter("serve.rows", bucket=size).value
            capacity = batches * size
            buckets[size] = {
                "batches": batches,
                "requests": r.counter("serve.batch_requests",
                                      bucket=size).value,
                "rows": rows,
                "fill_ratio": (rows / capacity) if capacity else 0.0,
                "deadline_flushes": r.counter("serve.deadline_flushes",
                                              bucket=size).value,
                "p50_ms": _quantile_ms(lat, 0.50),
                "p99_ms": _quantile_ms(lat, 0.99),
            }
        return {
            "buckets": buckets,
            "p50_ms": _quantile_ms(all_lat, 0.50),
            "p99_ms": _quantile_ms(all_lat, 0.99),
            "requests": self._submitted.value,
            "rejected": self._rejected.value,
            "queue_depth_rows": queued,
            "max_queue_depth_rows": int(self._queue_gauge.max),
            "recompiles": self._recompiles.value,
            "recompile_keys": recompile_keys,
            "request_errors": {
                t: r.counter("serve.request_errors", type=t).value
                for t in sorted(error_types)},
            "rebatch": {
                "joined": self._rebatch_joined.value,
                "joined_rows": self._rebatch_joined_rows.value,
                "rejected": self._rebatch_rejected.value},
            "dispatch_retries": self._retries.value,
            "dispatch_failures": self._failures.value,
            "shed_requests": self._shed.value,
            "breaker_state": breaker_state,
            "breaker_transitions": breaker_transitions,
            "breaker_n_transitions": self._n_transitions.value,
        }
