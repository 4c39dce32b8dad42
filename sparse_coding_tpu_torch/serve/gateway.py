"""Self-healing serving gateway: replica pools, failover, hedging, SLO
(the port of the JAX package's ``serve/gateway.py``).

One :class:`~sparse_coding_tpu_torch.serve.engine.ServingEngine` is a
solid single replica — captured bucket programs, a breaker, typed
backpressure — but a single replica is not a front door: one sick
backend takes the whole service down, and there is no notion of request
priority, per-request deadline, or failover. The gateway makes every
failure mode a handled, observable path:

- **replica pools with health scoring** — the gateway owns N engine
  replicas over one shared :class:`ModelRegistry`. Each replica gets its
  own :class:`~sparse_coding_tpu_torch.resilience.breaker.CircuitBreaker`
  (probe-token API: a raced stale outcome can never fake-heal it) plus
  an EWMA health score (serve/health.py) fed by every dispatch outcome.
  Routing is health-ordered; a failed dispatch **fails over** to the
  next-healthiest replica inside the same flush, so one replica dying
  loses zero admitted requests.
- **warm spares** — a replica whose breaker opens is drained and
  replaced by a spare activated at ZERO captures: the replicas share one
  :class:`~sparse_coding_tpu_torch.serve.engine.ProgramCache`, so the
  spare's manifest-driven warmup (``warmup_from_manifest``) finds every
  program already captured. Activation is fault-injectable
  (``gateway.spare.activate``) and crash-barriered at the worst instant
  (warm set ready, traffic not yet admitted).
- **request hedging** — when a dispatched flush exceeds the bucket's
  observed p95 (the gateway's own dispatch histograms), the same padded
  batch fires at the next-healthiest replica and the first result wins.
  Losers are not cancelled (a replay cannot be) but their cost is
  counted: ``gateway.hedges_fired`` / ``hedges_won`` (hedge returned
  first) / ``hedges_wasted`` (primary won after all). Replicas sharing a
  program table replay one at a time (its replay lock), so a hedge helps
  against a slow or sick replica's host path, not against the card.
- **SLO admission** — requests carry a priority class
  (interactive / batch / scavenger) and an optional deadline; admission
  sheds scavenger-first via the brownout ladder (serve/slo.py), with a
  closed-loop controller widening/narrowing from the observed p99.
  Sheds reuse the typed ``QueueFullError`` (with ``retry_after_s``) /
  ``CircuitOpenError`` contracts.
- **traffic-shaped bucket ladders** (serve/ladder.py) — the bucket
  ladder is a derived, hot-swappable artifact: ``maybe_swap_ladder``
  derives a pad-minimizing candidate from a self-digested traffic
  snapshot (fault site ``gateway.ladder.derive``), holds it through the
  plane's ``Hysteresis`` flap guard, captures its new rungs in a spare,
  and flips atomically behind crash barrier ``gateway.ladder.swap``. The
  dispatch path continuously REBATCHES: late-arriving queued requests
  that fit the chosen bucket's remaining rows join the in-flight
  assembly in strict FIFO order (``serve.rebatch.joined/rejected``).
  Every admission check reads the ACTIVE ladder, so a post-swap
  largest-bucket change can't strand admitted work (engines fall back
  to known captured rungs) and oversize errors always cite the live max.

Every routing/hedge/activation decision point is a named fault site
(``gateway.route``, ``gateway.hedge``, ``gateway.spare.activate``).
``device=None`` means the card (raising without one); pass
``device="cpu"`` to serve on the CPU.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from sparse_coding_tpu_torch import obs, resolve_device
from sparse_coding_tpu_torch.obs import monotime
from sparse_coding_tpu_torch.pipeline.plane import Hysteresis
from sparse_coding_tpu_torch.resilience.breaker import CircuitBreaker
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.serve.batching import (
    CircuitOpenError,
    DispatchError,
    MicroBatcher,
    QueueFullError,
    Request,
    ServeFuture,
)
from sparse_coding_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    DEFAULT_OPS,
    ProgramCache,
    ServingEngine,
    fanout_results,
    op_rows_axis,
    prepare_request,
)
from sparse_coding_tpu_torch.serve.health import EwmaHealth
from sparse_coding_tpu_torch.serve.ladder import (
    derive_ladder,
    ladder_pad_rows,
    parse_snapshot,
    pinned_ladder,
    snapshot_bytes,
)
from sparse_coding_tpu_torch.serve.metrics import ServingMetrics
from sparse_coding_tpu_torch.serve.registry import ModelRegistry
from sparse_coding_tpu_torch.serve.slo import (
    BATCH,
    PRIORITIES,
    AdmissionController,
    LoadSignals,
    LoadTracker,
    windowed_quantile,
)

register_fault_site("gateway.route",
                    "gateway dispatch — transport/decision point "
                    "immediately before one replica attempt")
register_fault_site("gateway.hedge",
                    "gateway hedging — immediately before firing the "
                    "hedge dispatch at the next-healthiest replica")
register_fault_site("gateway.spare.activate",
                    "warm-spare activation — before the manifest-driven "
                    "warm set is prepared")
register_crash_site("gateway.spare.activate",
                    "warm spare's program set ready in the shared table, "
                    "not yet admitted to the routing set")
register_fault_site("gateway.ladder.derive",
                    "ladder derivation — the self-digested traffic "
                    "snapshot bytes feeding derive_ladder (corruptible "
                    "payload); an injected error/corruption is a counted "
                    "skip (gateway.ladder.derive_errors) and the active "
                    "ladder is retained")
register_crash_site("gateway.ladder.swap",
                    "candidate ladder's programs captured in the shared "
                    "table and recorded in the warmup manifest, the "
                    "active ladder NOT yet replaced — a restart serves "
                    "on the old ladder")

ACTIVE = "active"
DRAINING = "draining"
SPARE = "spare"


@dataclass
class GatewayRequest(Request):
    """One admitted front-door request: a :class:`Request` carrying its
    SLO contract (priority class + optional deadline)."""

    priority: str = BATCH
    deadline_s: Optional[float] = None


class Replica:
    """One pool member: an engine plus ITS OWN breaker + health score.

    The engine's internal breaker/batcher are idle here — the gateway
    owns coalescing and dispatches through ``run_padded`` directly, so
    per-replica failure accounting lives at the gateway layer where the
    routing decision is made."""

    def __init__(self, name: str, engine: ServingEngine, state: str,
                 breaker_threshold: int, breaker_reset_s: float,
                 health_alpha: float, health_latency_scale_s: float,
                 clock=None):
        self.name = name
        self.engine = engine
        self.state = state
        self._breaker_kwargs = dict(
            failure_threshold=breaker_threshold,
            reset_timeout_s=breaker_reset_s)
        if clock is not None:
            self._breaker_kwargs["clock"] = clock
        self._health_kwargs = dict(
            alpha=health_alpha, latency_scale_s=health_latency_scale_s)
        self.breaker = CircuitBreaker(**self._breaker_kwargs)
        self.health = EwmaHealth(**self._health_kwargs)

    def reset(self) -> None:
        """Fresh breaker + health (reinstating a drained replica): the
        old instance's history describes the FAILED incarnation."""
        self.breaker = CircuitBreaker(**self._breaker_kwargs)
        self.health = EwmaHealth(**self._health_kwargs)

    def snapshot(self) -> dict:
        return {"state": self.state,
                "breaker": self.breaker.snapshot(),
                "health": self.health.snapshot(),
                "recompiles": self.engine.metrics.recompiles}


class _Attempt:
    """One replica dispatch attempt: the breaker admission token plus
    the ``abandoned`` flag a charged timeout sets — once an attempt has
    been charged as its replica's failure, its eventual late resolution
    must not touch the breaker (a late success would reset the failure
    streak and keep a consistently-past-deadline replica permanently
    routable)."""

    __slots__ = ("rep", "token", "abandoned")

    def __init__(self, rep: Replica, token):
        self.rep = rep
        self.token = token
        self.abandoned = False


class ServingGateway:
    """Front door over a pool of :class:`ServingEngine` replicas.

    ``submit(model, x, op, priority, deadline_s)`` admits through the
    SLO ladder into ONE gateway-owned micro-batching queue; the dispatch
    worker routes each coalesced flush to the healthiest admitting
    replica with failover + hedging. ``warmup()`` captures every ACTIVE
    replica's programs into the pool's shared table (a spare's
    activation then finds them all: zero captures). ``maintain()`` runs the self-healing pass (drain opened
    replicas, activate spares); it also runs automatically after every
    flush."""

    def __init__(self, registry: ModelRegistry,
                 n_replicas: int = 2,
                 n_spares: int = 1,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 ops: Sequence[str] = DEFAULT_OPS,
                 max_wait_ms: float = 2.0,
                 max_queue_rows: int = 8192,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0,
                 health_alpha: float = 0.2,
                 health_latency_scale_s: float = 0.05,
                 hedge_after_s: Optional[float] = None,
                 hedge_min_samples: int = 20,
                 dispatch_timeout_s: float = 60.0,
                 admission: Optional[AdmissionController] = None,
                 admission_window: int = 512,
                 metrics_registry=None,
                 breaker_clock=None,
                 engine_kwargs: Optional[dict] = None,
                 rebatch: bool = True,
                 ladder_max_rungs: int = 4,
                 ladder_hold_ticks: int = 2,
                 ladder_align: int = 8,
                 device=None):
        if n_replicas < 1:
            raise ValueError("need at least one active replica")
        if n_spares < 0:
            raise ValueError("n_spares must be >= 0")
        self._registry = registry
        self._device = resolve_device(device)
        # the ACTIVE bucket ladder: starts at the construction ladder,
        # atomically replaced by swap_ladder (serve/ladder.py) — every
        # admission-time check (prepare_request's oversize rejection, the
        # hedge trigger's bucket lookup) reads THIS, never the
        # construction constant
        self._buckets = tuple(int(b) for b in buckets)
        self._ops = tuple(ops)
        self._max_queue_rows = int(max_queue_rows)
        self._hedge_after_s = hedge_after_s
        self._hedge_min_samples = int(hedge_min_samples)
        if dispatch_timeout_s <= 0:
            raise ValueError("dispatch_timeout_s must be > 0")
        self._dispatch_timeout_s = float(dispatch_timeout_s)
        self._admission = admission if admission is not None \
            else AdmissionController()
        # typed load snapshot for the elastic plane (serve/slo.py):
        # advanced only by load_signals() calls, so the plane's scale
        # decisions are deterministic under a scripted observation stream
        self._load = LoadTracker()
        # the closed loop must see RECENT latency, not all-time history:
        # a cumulative histogram's p99 would hold the brownout ladder up
        # for tens of thousands of requests after an incident ends.
        # Appended only on the dispatch worker thread.
        self._recent_lat: deque = deque(maxlen=max(16,
                                                   int(admission_window)))
        self.metrics = ServingMetrics(registry=metrics_registry)
        self._reg = self.metrics.registry
        ekw = dict(engine_kwargs or {})
        ekw.setdefault("buckets", self._buckets)
        ekw.setdefault("ops", self._ops)
        ekw.setdefault("device", self._device)
        # one program table for the whole pool: replicas of one registry
        # capture identical programs, so N replicas (and the warm spare)
        # share ONE captured graph per (model, op, bucket) — a spare
        # activation is a table lookup, and every replay of the table
        # holds its replay lock
        ekw.setdefault("program_cache", ProgramCache())
        self._np_dtype = None  # set from the first replica below
        self._replicas: dict[str, Replica] = {}
        self._order: list[str] = []  # construction order (stable tiebreak)
        for i in range(n_replicas + n_spares):
            name = (f"replica-{i}" if i < n_replicas
                    else f"spare-{i - n_replicas}")
            engine = ServingEngine(registry, **ekw)
            if self._np_dtype is None:
                self._np_dtype = engine._np_dtype
            self._replicas[name] = Replica(
                name, engine,
                ACTIVE if i < n_replicas else SPARE,
                breaker_threshold, breaker_reset_s,
                health_alpha, health_latency_scale_s,
                clock=breaker_clock)
            self._order.append(name)
        self._pool_lock = threading.Lock()
        # per-flush critical-path scratch (winner replica, hedged flag):
        # written only on the single batcher worker thread (and by
        # _hedged_run, which runs on that same thread)
        self._last_flush: dict = {}
        # sized past 2 because a HUNG dispatch (a wedged backend: blocks,
        # never raises) cannot be cancelled and holds its worker until
        # the backend answers. The dispatch timeout below records such a
        # replica as failing, so its breaker opens and routing stops
        # feeding it — hung workers stay bounded by the failure
        # threshold plus stray hedges, well under this cap.
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * (n_replicas + n_spares)),
            thread_name_prefix="gateway-dispatch")
        self._batcher = MicroBatcher(
            dispatch=self._dispatch,
            max_rows_per_batch=self._buckets[-1],
            max_wait_s=max_wait_ms / 1e3,
            max_queue_rows=self._max_queue_rows,
            metrics=self.metrics)
        # traffic-shaped ladder state: continuous rebatching on the
        # dispatch path, plus the derive→hold→swap loop. The swap's flap
        # guard is the plane's Hysteresis — a candidate must survive
        # ``ladder_hold_ticks`` consecutive derivations before it swaps in
        self._rebatch = bool(rebatch)
        self._ladder_max_rungs = max(1, int(ladder_max_rungs))
        self._ladder_align = max(1, int(ladder_align))
        self._ladder_hyst = Hysteresis(ladder_hold_ticks)
        self._candidate_rungs: Optional[tuple] = None
        self._publish_ladder_gauges()

    # -- lifecycle -----------------------------------------------------------

    def warmup(self, max_workers: int | None = None) -> int:
        """Capture every active replica's full program set into the
        pool's shared table (spares warm on activation from the
        manifest, finding the set captured). Returns the total number of
        programs captured across replicas."""
        total = 0
        with obs.span("gateway.warmup",
                      replicas=len(self._active_replicas())):
            for rep in self._active_replicas():
                total += rep.engine.warmup(max_workers=max_workers)
        return total

    def shutdown(self, wait: bool = True) -> None:
        self._batcher.shutdown(wait=wait)
        self._hedge_pool.shutdown(wait=wait)
        for rep in self._replicas.values():
            rep.engine.shutdown(wait=wait)

    def pause(self) -> None:
        """Hold gateway dispatch (deterministic tests / maintenance);
        submissions still admit, enqueue, and backpressure."""
        self._batcher.pause()

    def resume(self) -> None:
        self._batcher.resume()

    def __enter__(self) -> "ServingGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- pool views ----------------------------------------------------------

    def _active_replicas(self) -> list[Replica]:
        return [self._replicas[n] for n in self._order
                if self._replicas[n].state == ACTIVE]

    def _spare_replicas(self) -> list[Replica]:
        return [self._replicas[n] for n in self._order
                if self._replicas[n].state == SPARE]

    def _routing_order(self) -> list[Replica]:
        """Health-weighted routing: active replicas, healthiest first
        (construction order breaks exact ties, so routing is
        deterministic under deterministic traffic)."""
        actives = self._active_replicas()
        idx = {n: i for i, n in enumerate(self._order)}
        return sorted(actives,
                      key=lambda r: (-r.health.score, idx[r.name]))

    def replica(self, name: str) -> Replica:
        return self._replicas[name]

    def replica_names(self) -> list[str]:
        return list(self._order)

    def active_replica_names(self) -> list[str]:
        """Names currently in the routing set (construction order) —
        the elastic plane's view of how wide the pool actually is."""
        return [r.name for r in self._active_replicas()]

    # -- request path --------------------------------------------------------

    def submit(self, model: str, x, op: str = "encode",
               priority: str = BATCH,
               deadline_s: Optional[float] = None) -> ServeFuture:
        """Admit one request through the SLO ladder and enqueue it.
        Raises typed sheds: :class:`QueueFullError` (brownout ladder,
        deadline, queue pressure — with ``retry_after_s``) or
        :class:`CircuitOpenError` (no replica currently admits)."""
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(supported: {PRIORITIES})")
        entry = self._registry.get(model)
        actives = self._active_replicas()
        admitting = [r for r in actives if r.breaker.admission_allowed()]
        if not admitting:
            self._record_shed(priority)
            cooldown = min((r.breaker.seconds_until_probe()
                            for r in actives), default=0.0)
            raise CircuitOpenError((model, op), cooldown)
        arr, rows, squeeze = prepare_request(entry, op, self._ops,
                                             self._buckets, self._np_dtype,
                                             x)
        try:
            self._admission.admit(
                priority, deadline_s,
                queued_rows=self._batcher.queued_rows,
                max_queue_rows=self._max_queue_rows,
                predicted_wait_s=self._batcher.predicted_wait_s(rows))
        except QueueFullError:
            self._record_shed(priority)
            raise
        # critical-path identity: minted at admission, carried
        # through queue wait → flush assembly → replica dispatch → hedge,
        # and emitted with the per-stage walls on completion so
        # obs.report decomposes p50/p95/p99 request latency by stage
        req = GatewayRequest(key=(model, op), x=arr, rows=rows,
                             squeeze=squeeze, t_submit=monotime(),
                             priority=priority, deadline_s=deadline_s,
                             trace_id=obs.mint_trace_id())
        try:
            return self._batcher.submit(req)
        except QueueFullError:
            # hard backpressure is also a shed, just the last-resort rung
            self._reg.counter("gateway.shed", priority=priority).inc()
            raise

    def query(self, model: str, x, op: str = "encode",
              priority: str = BATCH, deadline_s: Optional[float] = None,
              timeout: float | None = 60.0):
        """Blocking submit+result."""
        return self.submit(model, x, op=op, priority=priority,
                           deadline_s=deadline_s).result(timeout=timeout)

    def _record_shed(self, priority: str) -> None:
        self.metrics.record_shed()
        self._reg.counter("gateway.shed", priority=priority).inc()

    # -- dispatch (gateway batcher worker thread) ----------------------------

    def _run_one(self, attempt: "_Attempt", model: str, op: str, x):
        """One replica attempt: timed, breaker- and health-accounted.
        Success/failure is recorded HERE so hedge losers that finish
        after the winner still update their replica's score — UNLESS the
        attempt was abandoned by a charged timeout: a late success must
        not reset the breaker's failure streak (a replica consistently
        finishing just past the deadline would otherwise never open,
        never drain, and slowly park every pool worker)."""
        rep = attempt.rep
        t0 = monotime()
        try:
            bucket, host = rep.engine.run_padded(model, op, x)
        except BaseException:
            dur = monotime() - t0
            rep.health.record(dur, ok=False)
            if attempt.abandoned:
                self._reg.counter("gateway.late_results",
                                  replica=rep.name).inc()
            else:
                rep.breaker.record_failure(attempt.token)
                self._reg.counter("gateway.replica_errors",
                                  replica=rep.name).inc()
            raise
        dur = monotime() - t0
        # health always learns the TRUE latency (late = slow = low score)
        rep.health.record(dur, ok=True)
        if attempt.abandoned:
            self._reg.counter("gateway.late_results",
                              replica=rep.name).inc()
            return bucket, host
        rep.breaker.record_success(attempt.token)
        self._reg.counter("gateway.routes", replica=rep.name).inc()
        self._reg.histogram("gateway.dispatch_s", bucket=bucket).observe(dur)
        return bucket, host

    def configure_hedging(self, hedge_after_s: Optional[float]) -> None:
        """Operator knob: explicit hedge trigger override in seconds
        (0.0 hedges every flush, a large value effectively disables);
        ``None`` restores the observed-p95 default."""
        self._hedge_after_s = hedge_after_s

    def _hedge_deadline_s(self, rows: int) -> Optional[float]:
        """When to hedge a flush of ``rows`` rows: the explicit override
        if configured, else the observed p95 of its bucket's dispatch
        wall (None — no hedging — until enough samples exist)."""
        if self._hedge_after_s is not None:
            return self._hedge_after_s
        i = bisect.bisect_left(self._buckets, rows)
        if i == len(self._buckets):
            return None
        h = self._reg.histogram("gateway.dispatch_s",
                                bucket=self._buckets[i])
        if h.count < self._hedge_min_samples:
            return None
        return h.quantile(0.95)

    def _timeout_failure(self, attempt: "_Attempt") -> TimeoutError:
        """A dispatch that neither returned nor raised within the budget
        is a failure of ITS replica: a hung backend (a wedged card)
        blocks forever instead of erroring, and without this its breaker
        would never open and routing would keep feeding it. The call
        itself cannot be cancelled — its worker is abandoned (pool is
        sized for that) and the attempt is MARKED abandoned so its
        eventual resolution cannot touch the breaker."""
        attempt.abandoned = True
        attempt.rep.breaker.record_failure(attempt.token)
        attempt.rep.health.record(self._dispatch_timeout_s, ok=False)
        self._reg.counter("gateway.dispatch_timeouts",
                          replica=attempt.rep.name).inc()
        return TimeoutError(
            f"replica {attempt.rep.name} dispatch exceeded "
            f"{self._dispatch_timeout_s}s (hung backend?)")

    def _bounded_result(self, fut, attempt: "_Attempt", t_end: float):
        try:
            return fut.result(timeout=max(0.0, t_end - monotime()))
        except FutureTimeoutError:
            raise self._timeout_failure(attempt) from None

    def _hedged_run(self, attempt: "_Attempt", backups: list[Replica],
                    model: str, op: str, x, rows: int):
        """Primary dispatch with p95-triggered hedging; first success
        wins. Every wait is bounded by ``dispatch_timeout_s``: a hung
        participant is recorded as that replica's failure and the caller
        fails over — a wedged backend degrades the pool, never wedges
        the gateway. Raises only when every participant failed or timed
        out."""
        t_end = monotime() + self._dispatch_timeout_s
        fut = self._hedge_pool.submit(self._run_one, attempt, model, op, x)
        deadline = self._hedge_deadline_s(rows)
        if deadline is None or not backups:
            return self._bounded_result(fut, attempt, t_end)
        try:
            return fut.result(
                timeout=min(deadline, max(0.0, t_end - monotime())))
        except FutureTimeoutError:
            if monotime() >= t_end:
                raise self._timeout_failure(attempt) from None
            # primary is slow, not failed (nor timed out yet): hedge it
        hedge = None
        for rep in backups:
            tok = rep.breaker.allow()
            if tok:
                hedge = _Attempt(rep, tok)
                break
        if hedge is None:
            return self._bounded_result(fut, attempt, t_end)
        try:
            fault_point("gateway.hedge")
            hfut = self._hedge_pool.submit(self._run_one, hedge,
                                           model, op, x)
        except BaseException:  # noqa: BLE001 — hedging is best-effort
            # a failed hedge FIRING must never fail the request: the
            # primary is still running and remains the answer
            self._reg.counter("gateway.hedges_abandoned").inc()
            return self._bounded_result(fut, attempt, t_end)
        self._reg.counter("gateway.hedges_fired").inc()
        self._last_flush["hedged"] = True
        owners = {fut: attempt, hfut: hedge}
        pending = {fut, hfut}
        first_err: Optional[BaseException] = None
        while pending:
            done, pending = futures_wait(pending,
                                         timeout=max(0.0,
                                                     t_end - monotime()),
                                         return_when=FIRST_COMPLETED)
            if not done:
                # overall budget exhausted with participant(s) hung:
                # charge each hung replica, fail over
                err: Optional[BaseException] = first_err
                for f in pending:
                    err = self._timeout_failure(owners[f])
                raise err
            for f in done:
                if f.exception() is None:
                    if f is hfut:
                        self._reg.counter("gateway.hedges_won").inc()
                    else:
                        self._reg.counter("gateway.hedges_wasted").inc()
                    self._last_flush["replica"] = owners[f].rep.name
                    # first-wins cancel semantics: the loser cannot be
                    # cancelled mid-execution; its outcome is recorded
                    # by _run_one when it finishes and then discarded
                    return f.result()
                if first_err is None:
                    first_err = f.exception()
        raise first_err  # both participants failed

    def _dispatch(self, key: tuple, requests: list[Request],
                  deadline_flush: bool) -> int | None:
        """Returns rows served (the batcher's service-rate input), None
        for a shed or failed flush."""
        model, op = key
        # critical-path stage 1, queue wait: stamped per request the
        # moment the flush leaves the queue
        t_flush = monotime()
        queue_hist = self._reg.histogram("serve.stage_s", stage="queue")
        rows = sum(r.rows for r in requests)
        # continuous rebatching: membership is no longer frozen at
        # pop time — queued requests that arrived before dispatch and fit
        # the chosen bucket's remaining rows join the assembly in strict
        # FIFO order, converting pad rows into served rows for free
        if self._rebatch:
            target = self._covering_bucket(rows)
            if target is not None and target > rows:
                joiners = self._batcher.take_joiners(key, target - rows)
                if joiners:
                    requests = requests + joiners
                    rows += sum(r.rows for r in joiners)
        for r in requests:
            # clamp: a joiner can be submitted a hair after t_flush
            r.queue_s = max(0.0, t_flush - r.t_submit)
            queue_hist.observe(r.queue_s)
        if len(requests) == 1:
            x = requests[0].x
        else:
            x = np.concatenate([r.x for r in requests], axis=0)
        self._reg.histogram("serve.stage_s", stage="assemble").observe(
            monotime() - t_flush)
        candidates = self._routing_order()
        last_err: Optional[BaseException] = None
        t_disp = monotime()
        try:
            for i, rep in enumerate(candidates):
                token = rep.breaker.allow()
                if not token:
                    continue
                try:
                    fault_point("gateway.route")
                except BaseException as e:  # noqa: BLE001 — typed below
                    # a routing/transport failure counts against the
                    # replica it was destined for
                    rep.breaker.record_failure(token)
                    rep.health.record(0.0, ok=False)
                    self._reg.counter("gateway.route_errors").inc()
                    last_err = e
                    if i + 1 < len(candidates):
                        self._reg.counter("gateway.failovers").inc()
                    continue
                try:
                    self._last_flush = {"replica": rep.name,
                                        "hedged": False}
                    bucket, host = self._hedged_run(
                        _Attempt(rep, token), candidates[i + 1:], model,
                        op, x, rows)
                except BaseException as e:  # noqa: BLE001 — typed below
                    last_err = e
                    if i + 1 < len(candidates):
                        self._reg.counter("gateway.failovers").inc()
                    continue
                # stage 3, replica dispatch (failovers + hedge included:
                # this is the request's actual critical path)
                self._reg.histogram("serve.stage_s",
                                    stage="dispatch").observe(
                    monotime() - t_disp)
                self._finish_flush(key, requests, rows, bucket, host,
                                   deadline_flush)
                return rows
            # every candidate refused or failed
            self.metrics.record_dispatch_failure()
            if last_err is None:
                self.metrics.record_shed(len(requests))
                err: Exception = CircuitOpenError(
                    key, min((r.breaker.seconds_until_probe()
                              for r in candidates), default=0.0))
            else:
                err = (last_err if isinstance(last_err, DispatchError)
                       else DispatchError(key, last_err))
            self.metrics.record_request_errors(len(requests),
                                               type(err).__name__)
            for r in requests:
                if not r.future.done():
                    r.future._set_error(err)
            return None
        finally:
            self.maintain()

    def _finish_flush(self, key, requests, rows, bucket, host,
                      deadline_flush) -> None:
        model, op = key
        self.metrics.record_batch(bucket, len(requests), rows,
                                  deadline_flush)
        rows_axis = op_rows_axis(self._registry.get(model), op)
        flush = getattr(self, "_last_flush", {})
        t_fan = monotime()

        def on_latency(r, lat):
            self.metrics.record_latency(bucket, lat)
            self._reg.counter("gateway.served",
                              priority=getattr(r, "priority", BATCH)).inc()
            self._lat_hist().observe(lat)
            self._recent_lat.append(lat)
            # the request's whole critical path in ONE correlated event,
            # keyed by the trace id minted at admission — obs.report's
            # request-stage decomposition reads the stage histograms;
            # this event is the per-request drill-down
            obs.emit_event(
                "serve.request", trace=getattr(r, "trace_id", ""),
                model=model, op=op,
                priority=getattr(r, "priority", BATCH), rows=r.rows,
                bucket=bucket, replica=flush.get("replica", ""),
                hedged=flush.get("hedged", False),
                queue_s=round(getattr(r, "queue_s", 0.0), 6),
                total_s=round(lat, 6))

        fanout_results(requests, host, rows_axis, on_latency=on_latency)
        # stage 4, result fan-out back to the waiters
        self._reg.histogram("serve.stage_s", stage="fanout").observe(
            monotime() - t_fan)
        # closed loop: feed the controller the RECENT pool-wide p99 (the
        # all-time histogram would pin the ladder up long after an
        # incident ends) and expose the resulting rung as a gauge
        p99 = windowed_quantile(list(self._recent_lat), 0.99)
        level = self._admission.observe_p99(
            None if p99 is None else p99 * 1e3)
        self._reg.gauge("gateway.admission_level").set(level)

    def _lat_hist(self):
        return self._reg.histogram("gateway.latency_s")

    # -- traffic-shaped bucket ladder (serve/ladder.py) ----------------------

    @property
    def active_buckets(self) -> tuple:
        """The ladder currently admitting and shaping traffic."""
        return self._buckets

    def _covering_bucket(self, rows: int) -> Optional[int]:
        """Smallest ACTIVE rung covering ``rows`` (None when a
        shrink-swap left admitted work above the active max — the engine
        then covers from its known-rung fallback and rebatching simply
        skips the flush)."""
        buckets = self._buckets
        i = bisect.bisect_left(buckets, rows)
        return buckets[i] if i < len(buckets) else None

    def _publish_ladder_gauges(self, old_n_rungs: int = 0) -> None:
        """Active rungs as gauges (``gateway.ladder.rung{idx=..}``) —
        the obs.report "ladder" section reads these; stale indices from
        a longer previous ladder are zeroed so the report never shows a
        ghost rung."""
        buckets = self._buckets
        for i, b in enumerate(buckets):
            self._reg.gauge("gateway.ladder.rung", idx=i).set(b)
        for i in range(len(buckets), max(old_n_rungs, len(buckets))):
            self._reg.gauge("gateway.ladder.rung", idx=i).set(0)
        self._reg.gauge("gateway.ladder.n_rungs").set(len(buckets))
        self._reg.gauge("gateway.ladder.max_rung").set(buckets[-1])

    def maybe_swap_ladder(self) -> Optional[dict]:
        """One derive→hold→swap pass; rides the elastic plane's arbiter
        tick (pipeline/plane.py) and is safe to call from any
        maintenance loop. Never raises: a failed derivation (fault site
        ``gateway.ladder.derive``, including corrupt snapshot bytes —
        the self-digest catches any flip) or a failed swap is a counted
        skip and the ACTIVE ladder is retained. The operator pin
        (``SPARSE_CODING_LADDER_PIN``) overrides derivation AND the flap
        guard. Returns the swap breadcrumb dict, or None when nothing
        swapped."""
        try:
            pin = pinned_ladder()
        except Exception:  # noqa: BLE001 — malformed pin: counted skip
            self._reg.counter("gateway.ladder.derive_errors").inc()
            return None
        if pin is not None:
            if pin == self._buckets:
                return None
            return self._guarded_swap(pin, source="pin")
        try:
            # derivation is seeded from a SNAPSHOT, never live mutable
            # state: the bytes are the corruptible fault payload, and
            # parse_snapshot's digest check turns any corruption into a
            # typed, counted skip
            raw = snapshot_bytes(self._reg)
            raw = fault_point("gateway.ladder.derive", raw)
            snap = parse_snapshot(raw)
            cand = derive_ladder(snap, max_rungs=self._ladder_max_rungs,
                                 align=self._ladder_align,
                                 fallback=self._buckets)
        except Exception:  # noqa: BLE001 — derive failure: counted skip
            self._reg.counter("gateway.ladder.derive_errors").inc()
            return None
        rungs = tuple(int(b) for b in cand["rungs"])
        if rungs == self._buckets:
            self._ladder_hyst.vote(0)
            self._candidate_rungs = None
            return None
        # only swap when the candidate actually saves pad on the
        # snapshot's own traffic (the derived optimum always does unless
        # rounding/fallback interfered — this guards the degenerate
        # cases deterministically)
        if (ladder_pad_rows(snap, rungs)
                >= ladder_pad_rows(snap, self._buckets)):
            self._ladder_hyst.vote(0)
            self._candidate_rungs = None
            return None
        if rungs != self._candidate_rungs:
            # a NEW candidate restarts the hold window: hysteresis
            # confirms persistence of one specific ladder, not churn
            self._ladder_hyst.vote(0)
            self._candidate_rungs = rungs
        if not self._ladder_hyst.vote(1):
            self._reg.counter("gateway.ladder.held").inc()
            return None
        self._candidate_rungs = None
        return self._guarded_swap(
            rungs, source="derived",
            expected_pad_rows=cand.get("expected_pad_rows"))

    def _guarded_swap(self, rungs: tuple, source: str,
                      **detail) -> Optional[dict]:
        try:
            return self.swap_ladder(rungs, source=source, **detail)
        except Exception:  # noqa: BLE001 — swap failure: counted skip,
            # active ladder retained; programs captured so far stay in
            # the shared table, so the retry is cheaper
            self._reg.counter("gateway.ladder.swap_errors").inc()
            return None

    def swap_ladder(self, rungs, source: str = "manual",
                    **detail) -> dict:
        """Atomic ladder swap that captures only the new rungs, before it
        flips. Order is the whole contract: (1) capture every (model, op,
        new-rung) program the shared table lacks through
        ``xcache.cached_capture`` in a warm spare (or the healthiest
        active when the pool has no spare) — the pool's SHARED program
        table makes the flip free for every replica; (2) crash barrier
        ``gateway.ladder.swap`` at the worst instant (candidate captured
        and recorded in the warmup manifest, active ladder untouched — a
        SIGKILL here restarts onto the OLD ladder); (3) under the pool
        lock, atomically replace the active ladder on the gateway, every
        replica engine, and the batcher's capacity threshold."""
        rungs = tuple(int(b) for b in rungs)
        if not rungs or list(rungs) != sorted(set(rungs)):
            raise ValueError(f"rungs must be unique ascending: {rungs}")
        with self._pool_lock:
            warmer = next(iter(self._spare_replicas()), None)
            if warmer is None:
                warmer = self._routing_order()[0]
        with obs.span("gateway.ladder.swap", source=source,
                      rungs=",".join(str(b) for b in rungs)):
            programs = warmer.engine.warm_buckets(rungs)
            # THE swap instant: every candidate program is in the shared
            # table and the warmup manifest; nothing has been replaced.
            # SIGKILL here must cost nothing: a restart serves the old
            # ladder.
            crash_barrier("gateway.ladder.swap")
            with self._pool_lock:
                old = self._buckets
                self._buckets = rungs
                for name in self._order:
                    self._replicas[name].engine.set_buckets(rungs)
                self._batcher.set_max_rows(rungs[-1])
                self._publish_ladder_gauges(old_n_rungs=len(old))
        self._reg.counter("gateway.ladder.swaps").inc()
        obs.emit_event("gateway.ladder.swap", rungs=list(rungs),
                       old=list(old), source=source,
                       programs_warmed=programs, **detail)
        return {"rungs": rungs, "old": old, "source": source,
                "programs_warmed": programs, **detail}

    # -- self-healing --------------------------------------------------------

    def maintain(self) -> list[str]:
        """One self-healing pass: every ACTIVE replica whose breaker is
        OPEN is drained and (when a spare exists) replaced by a warm
        spare activated from the manifest. Runs after every flush and on
        demand; returns the names of replicas drained this pass."""
        drained: list[str] = []
        with self._pool_lock:
            for rep in self._active_replicas():
                if rep.breaker.state != "open":
                    continue
                spare = next(iter(self._spare_replicas()), None)
                if spare is None:
                    self._reg.counter("gateway.spare_exhausted").inc()
                    continue
                if self._activate_spare(spare, replacing=rep):
                    drained.append(rep.name)
        return drained

    def _activate_spare(self, spare: Replica,
                        replacing: Optional[Replica] = None) -> bool:
        """Warm the spare from the warmup manifest (through the pool's
        shared table: zero captures), then swap it
        into the routing set — in place of ``replacing`` (self-healing
        drain) or as an EXTRA active when ``replacing`` is None (elastic
        scale-up: nothing drains, the pool widens). On failure the spare
        stays a spare (retried next maintain pass) and the pool keeps
        serving on the surviving replicas — activation is never on the
        failure path of in-flight traffic."""
        try:
            with obs.span("gateway.spare.activate", spare=spare.name,
                          replacing=replacing.name if replacing else ""):
                fault_point("gateway.spare.activate")
                programs = spare.engine.warmup_from_manifest()
                # worst instant: the spare's full warm set is ready, but
                # the routing swap below has not happened — a SIGKILL here
                # must leave a restart that heals identically
                crash_barrier("gateway.spare.activate")
                spare.state = ACTIVE
                if replacing is not None:
                    replacing.state = DRAINING
        except BaseException:  # noqa: BLE001 — activation is off-path
            self._reg.counter("gateway.spare_activation_errors").inc()
            return False
        self._reg.counter("gateway.spare_activations").inc()
        self._reg.counter("gateway.spare_programs_warmed").inc(programs)
        return True

    # -- elastic pool (an elastic plane drives these) ------------------------

    def scale_up(self, n: int = 1) -> list[str]:
        """Elastic scale-up: activate up to ``n`` warm spares as EXTRA
        actives (no replica drained). Zero captures by construction —
        the spare warms from the warmup manifest through the pool's
        shared program table, exactly the self-healing activation path.
        Returns the names activated (may be shorter when spares ran out
        or an activation failed; the plane retries next tick)."""
        activated: list[str] = []
        with self._pool_lock:
            for spare in self._spare_replicas()[:max(0, int(n))]:
                if self._activate_spare(spare, replacing=None):
                    activated.append(spare.name)
        return activated

    def scale_down(self, n: int = 1) -> list[str]:
        """Elastic scale-down: drain the ``n`` least-healthy actives
        (never below one). A DRAINING replica leaves the routing order
        immediately — in-flight dispatches finish on it, new flushes
        don't start — and ``reinstate()`` returns it to the spare set
        once the plane's drain window passes. Returns the names
        drained."""
        drained: list[str] = []
        with self._pool_lock:
            for rep in reversed(self._routing_order()):
                if len(drained) >= max(0, int(n)):
                    break
                if len(self._active_replicas()) <= 1:
                    break  # the front door never scales to zero
                rep.state = DRAINING
                drained.append(rep.name)
        return drained

    def load_signals(self) -> LoadSignals:
        """Fold one load observation and return the typed snapshot the
        elastic plane scales from (serve/slo.py ``LoadSignals``): queue
        depth + service-rate EWMA from the micro-batcher, brownout rung
        from the admission controller — one audited struct, no
        controller internals."""
        return self._load.observe(
            queued_rows=self._batcher.queued_rows,
            service_rate_rows_s=self._batcher.service_rate_rows_s,
            predicted_wait_s=self._batcher.predicted_wait_s(),
            admission_level=self._admission.level,
            active_max_rows=self._buckets[-1])

    def reinstate(self, name: str) -> None:
        """Ops hook: return a drained (repaired) replica to the pool as
        a warm-spare candidate with a fresh breaker + health score."""
        rep = self._replicas[name]
        if rep.state != DRAINING:
            raise ValueError(f"{name!r} is {rep.state}, not draining")
        rep.reset()
        rep.state = SPARE

    # -- read side -----------------------------------------------------------

    def stats(self) -> dict:
        """One coherent snapshot: the serving-metrics schema (buckets,
        latency quantiles, queue, sheds) plus the gateway section —
        per-replica breaker/health/state, hedge and failover counters,
        admission ladder state."""
        snap = self.metrics.snapshot()
        c = self._reg.counter
        snap["replicas"] = {n: self._replicas[n].snapshot()
                            for n in self._order}
        snap["admission"] = self._admission.snapshot()
        snap["gateway"] = {
            "hedges_fired": c("gateway.hedges_fired").value,
            "hedges_won": c("gateway.hedges_won").value,
            "hedges_wasted": c("gateway.hedges_wasted").value,
            "hedges_abandoned": c("gateway.hedges_abandoned").value,
            "failovers": c("gateway.failovers").value,
            "route_errors": c("gateway.route_errors").value,
            "dispatch_timeouts": {
                n: c("gateway.dispatch_timeouts", replica=n).value
                for n in self._order},
            "replica_errors": {
                n: c("gateway.replica_errors", replica=n).value
                for n in self._order},
            "routes": {n: c("gateway.routes", replica=n).value
                       for n in self._order},
            "spare_activations": c("gateway.spare_activations").value,
            "spare_activation_errors":
                c("gateway.spare_activation_errors").value,
            "spare_exhausted": c("gateway.spare_exhausted").value,
            "shed": {p: c("gateway.shed", priority=p).value
                     for p in PRIORITIES},
            "served": {p: c("gateway.served", priority=p).value
                       for p in PRIORITIES},
            "late_results": {
                n: c("gateway.late_results", replica=n).value
                for n in self._order},
            # the controller is the source of truth (the gauge only
            # refreshes per flush and would lag a set_level override)
            "admission_level": self._admission.level,
            "ladder": {
                "rungs": list(self._buckets),
                "swaps": c("gateway.ladder.swaps").value,
                "held": c("gateway.ladder.held").value,
                "derive_errors": c("gateway.ladder.derive_errors").value,
                "swap_errors": c("gateway.ladder.swap_errors").value,
            },
        }
        return snap
