"""Dynamic micro-batching queue for the serving engine (the port's copy of
the JAX package's ``serve/batching.py``).

Requests (a few activation rows each) are coalesced per (model, op) stream
into one padded device program per batch: a CUDA-graph replay costs a
copy in, a launch and a copy out whatever the rows, so per-request
dispatch would pay that fixed cost per handful of rows. The whole hot
loop here is host Python over numpy buffers and threading primitives; the
only device entry point is the engine's dispatch callback replaying a
captured graph. Every wait in this module is bounded by a timeout.

Flush policy (per (model, op) stream, oldest stream first):

- **capacity flush**: pending rows reach the largest bucket → dispatch now;
- **deadline flush**: the oldest request has waited ``max_wait_s`` →
  dispatch whatever is pending into the smallest covering bucket;
- **backpressure**: queued rows would exceed ``max_queue_rows`` → the
  submit call fails fast with :class:`QueueFullError` (typed, carries the
  depth) instead of adding unbounded latency.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from sparse_coding_tpu_torch.obs import monotime
from sparse_coding_tpu_torch.serve.metrics import ServingMetrics


class ServeError(RuntimeError):
    """Base class for typed serving failures."""


class QueueFullError(ServeError):
    """Backpressure rejection: admitting the request would push the queue
    past ``max_queue_rows`` (or, at the gateway, past the SLO admission
    ladder). The request was NOT enqueued. ``retry_after_s`` mirrors
    :class:`CircuitOpenError`'s contract — the predicted time for the
    current queue to drain (depth x recent per-row service rate) — so
    shed clients back off intelligently instead of hot-retrying; ``None``
    when no service rate has been observed yet."""

    def __init__(self, queued_rows: int, max_queue_rows: int,
                 retry_after_s: float | None = None):
        hint = ("" if retry_after_s is None
                else f"; retry in ~{retry_after_s:.2f}s")
        super().__init__(
            f"serving queue full: {queued_rows} rows queued "
            f"(max {max_queue_rows}); request rejected{hint}")
        self.queued_rows = queued_rows
        self.max_queue_rows = max_queue_rows
        self.retry_after_s = retry_after_s


class RequestTooLargeError(ServeError):
    """The request exceeds the largest shape bucket; route it through
    :func:`sparse_coding_tpu_torch.serve.offline.score_offline` instead."""

    def __init__(self, rows: int, max_rows: int):
        super().__init__(
            f"request of {rows} rows exceeds the largest bucket "
            f"({max_rows}); use serve.offline.score_offline for bulk "
            f"scoring")
        self.rows = rows
        self.max_rows = max_rows


class DispatchError(ServeError):
    """One flush's dispatch failed after exhausting its retry budget; only
    THAT flush's requests carry this error — the worker thread and every
    other queued request are unaffected. ``cause`` is the underlying
    exception; ``key`` names the (model, op) stream."""

    def __init__(self, key: tuple, cause: BaseException):
        model, op = key
        super().__init__(
            f"dispatch failed for {model!r}/{op}: {cause!r}")
        self.key = key
        self.cause = cause


class CircuitOpenError(ServeError):
    """The dispatch circuit breaker is open: the backend failed repeatedly
    and new work is being shed instead of queued behind a sick device.
    Retry after ``retry_after_s`` (the breaker's remaining cooldown)."""

    def __init__(self, key: tuple, retry_after_s: float):
        model, op = key
        super().__init__(
            f"circuit open for {model!r}/{op}: backend failing; retry in "
            f"~{retry_after_s:.2f}s")
        self.key = key
        self.retry_after_s = retry_after_s


class ServeFuture:
    """Synchronization handle for one in-flight request."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None

    def _set_result(self, result: Any) -> None:
        self._result = result
        self._event.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = 60.0) -> Any:
        """The request's result (or its typed error), waiting at most
        ``timeout`` seconds (None waits without bound)."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving request did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result


@dataclass
class Request:
    """One submitted unit of work: ``x`` is always [rows, width] float;
    ``squeeze`` remembers a 1-D submission so the result matches.
    ``trace_id`` is the critical-path correlation id minted at admission
    (obs.mint_trace_id); ``queue_s`` is stamped by the dispatcher
    when the request leaves the queue, so the completion event can
    decompose latency into queue wait vs dispatch."""

    key: tuple  # (model_name, op)
    x: np.ndarray
    rows: int
    squeeze: bool
    t_submit: float
    future: ServeFuture = field(default_factory=ServeFuture)
    trace_id: str = ""
    queue_s: float = 0.0


class MicroBatcher:
    """Single worker thread draining per-(model, op) request streams into
    the dispatch callback. ``dispatch(key, requests, deadline_flush)`` owns
    bucket selection, padding, the graph replay, and result fan-out; it
    returns the number of rows actually served (None/0 for a shed or
    failed flush — those must not feed the service-rate estimate)."""

    def __init__(self, dispatch: Callable[[tuple, list[Request], bool], None],
                 max_rows_per_batch: int, max_wait_s: float,
                 max_queue_rows: int, metrics: ServingMetrics):
        self._dispatch = dispatch
        self._max_rows = max_rows_per_batch
        self._max_wait_s = max_wait_s
        self._max_queue_rows = max_queue_rows
        self._metrics = metrics
        self._queues: dict[tuple, deque[Request]] = {}
        self._queued_rows = 0
        # recent per-row service rate (rows/s EWMA over dispatch walls):
        # feeds QueueFullError.retry_after_s and the gateway's predicted
        # admission wait; None until the first dispatch completes
        self._rate_rows_s: float | None = None
        self._rate_alpha = 0.2
        self._cond = threading.Condition()
        self._stop = False
        self._paused = False
        self._worker = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._worker.start()

    # -- producer side -------------------------------------------------------

    def submit(self, request: Request) -> ServeFuture:
        with self._cond:
            if self._stop:
                raise ServeError("serving engine is shut down")
            if self._queued_rows + request.rows > self._max_queue_rows:
                self._metrics.record_reject()
                raise QueueFullError(self._queued_rows, self._max_queue_rows,
                                     self._predicted_wait_locked())
            self._queues.setdefault(request.key, deque()).append(request)
            self._queued_rows += request.rows
            self._metrics.record_enqueue(request.rows)
            self._cond.notify_all()
        return request.future

    def _predicted_wait_locked(self, extra_rows: int = 0) -> float | None:
        # _cond held by caller
        if self._rate_rows_s is None or self._rate_rows_s <= 0:
            return None
        return (self._queued_rows + extra_rows) / self._rate_rows_s

    def predicted_wait_s(self, extra_rows: int = 0) -> float | None:
        """Predicted time for the current queue (plus ``extra_rows``) to
        drain at the recent service rate; None before any dispatch has
        been timed. The gateway's SLO admission compares this against a
        request's deadline."""
        with self._cond:
            return self._predicted_wait_locked(extra_rows)

    @property
    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    @property
    def max_rows(self) -> int:
        with self._cond:
            return self._max_rows

    def set_max_rows(self, max_rows: int) -> None:
        """Hot-swap the capacity-flush threshold to a new ladder's
        largest bucket (gateway ladder swap, serve/ladder.py).
        Queued requests are untouched — an already-admitted request
        larger than the new ladder still dispatches (the engine falls
        back to a previously captured rung), so a shrink-swap can never
        strand admitted work."""
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        with self._cond:
            self._max_rows = int(max_rows)
            self._cond.notify_all()

    def take_joiners(self, key: tuple,
                     remaining_rows: int) -> list[Request]:
        """Continuous rebatching: pop queued requests of ``key``'s
        stream — strictly FIFO, never skipping the head (skipping would
        reorder results against submission order and break dispatch
        determinism) — while they fit ``remaining_rows``, so requests
        that arrived after the flush was popped ride the already-chosen
        bucket's pad rows instead of waiting a full cycle. Joining only
        ever ACCELERATES a request, so deadlines and priority ordering
        are respected by construction. A present head that does not fit
        is counted rejected (``serve.rebatch.rejected``)."""
        joined: list[Request] = []
        rows = 0
        with self._cond:
            q = self._queues.get(key)
            while q and remaining_rows - rows >= q[0].rows:
                r = q.popleft()
                joined.append(r)
                rows += r.rows
            rejected = 1 if (q and remaining_rows - rows > 0) else 0
            if rows:
                self._queued_rows -= rows
        if rows:
            self._metrics.record_dequeue(rows)
        self._metrics.record_rebatch(len(joined), rows, rejected)
        return joined

    @property
    def service_rate_rows_s(self) -> float | None:
        """Recent rows/s service-rate EWMA (None before the first timed
        dispatch) — the typed ``LoadSignals`` feed (serve/slo.py): the
        elastic plane reads load through this, never the raw field."""
        with self._cond:
            return self._rate_rows_s

    def _observe_service(self, rows: int, dur_s: float) -> None:
        if rows <= 0 or dur_s <= 0:
            return
        inst = rows / dur_s
        with self._cond:
            if self._rate_rows_s is None:
                self._rate_rows_s = inst
            else:
                a = self._rate_alpha
                self._rate_rows_s = (1 - a) * self._rate_rows_s + a * inst

    def pause(self) -> None:
        """Hold dispatch (drain-style maintenance and deterministic tests);
        submissions still enqueue — and still backpressure."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def shutdown(self, wait: bool = True) -> None:
        with self._cond:
            self._stop = True
            self._paused = False
            self._cond.notify_all()
        if wait:
            self._worker.join(timeout=30)

    # -- worker side ---------------------------------------------------------

    def _pick_stream(self, now: float) -> tuple[tuple | None, float | None]:
        """(key of the stream to flush NOW, or None; earliest deadline among
        pending streams when nothing is flushable). A stream is flushable
        when it reaches bucket capacity or its oldest request's deadline —
        choosing the oldest FLUSHABLE stream (not the globally oldest one)
        avoids head-of-line blocking: a capacity-full stream must not wait
        behind an older sparse stream that is still accumulating."""
        flush_key, flush_t = None, None
        next_deadline = None
        for key, q in self._queues.items():
            if not q:
                continue
            deadline = q[0].t_submit + self._max_wait_s
            if (sum(r.rows for r in q) >= self._max_rows
                    or now >= deadline or self._stop):
                if flush_t is None or q[0].t_submit < flush_t:
                    flush_key, flush_t = key, q[0].t_submit
            elif next_deadline is None or deadline < next_deadline:
                next_deadline = deadline
        return flush_key, next_deadline

    def _pop_batch(self) -> tuple[tuple, list[Request], bool] | None:
        """Block until a stream is flushable (capacity or deadline), then
        pop greedily up to the largest bucket. Returns None on shutdown."""
        with self._cond:
            while True:
                if self._stop and (self._paused
                                   or not any(self._queues.values())):
                    return None
                if self._paused:
                    self._cond.wait(timeout=0.1)
                    continue
                now = monotime()
                key, next_deadline = self._pick_stream(now)
                if key is None:
                    self._cond.wait(
                        timeout=0.1 if next_deadline is None
                        else max(1e-4, next_deadline - now))
                    continue
                q = self._queues[key]
                deadline_hit = now >= q[0].t_submit + self._max_wait_s
                reqs: list[Request] = [q.popleft()]
                rows = reqs[0].rows
                while q and rows + q[0].rows <= self._max_rows:
                    r = q.popleft()
                    reqs.append(r)
                    rows += r.rows
                self._queued_rows -= rows
                self._metrics.record_dequeue(rows)
                return key, reqs, deadline_hit and rows < self._max_rows

    def _loop(self) -> None:
        # worker-survival contract: NO exception from the dispatch callback
        # may escape this loop — it would kill the only drain thread and
        # strand every queued result() waiter until timeout. A failed flush
        # marks exactly its own requests failed (typed) and the worker
        # moves on to the next batch.
        while True:
            popped = self._pop_batch()
            if popped is None:
                return
            key, reqs, deadline_flush = popped
            t0 = monotime()
            try:
                served = self._dispatch(key, reqs, deadline_flush)
                # only rows the backend actually SERVED feed the rate:
                # a shed/failed flush "completes" in microseconds and
                # would inflate the EWMA by orders of magnitude, turning
                # retry_after_s into a hot-retry hint during the exact
                # incidents it exists for (dispatchers return None for
                # flushes that did no device work)
                if isinstance(served, int) and served > 0:
                    self._observe_service(served, monotime() - t0)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                err = e if isinstance(e, ServeError) else DispatchError(key, e)
                n = 0
                for r in reqs:
                    if not r.future.done():
                        r.future._set_error(err)
                        n += 1
                if n:
                    self._metrics.record_request_errors(n, type(err).__name__)
