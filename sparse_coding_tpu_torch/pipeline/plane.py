"""Elastic resource plane: serving and training trade one host's slices
(the port's counterpart of the JAX package's ``pipeline/plane.py``).

The gateway's replica pool (serve/gateway.py) and the fleet scheduler
(pipeline/fleet.py) would otherwise own static splits of the devices.
This module is the ONE arbiter over both: a control loop that reads the
serving front door's typed load snapshot
(:class:`~sparse_coding_tpu_torch.serve.slo.LoadSignals`) and moves whole
replica-sized slice blocks between the two consumers —

- **scale-up** (traffic rising): shrink the fleet's share FIRST —
  scavenger-class tenants are SIGTERM-preempted at their next chunk
  boundary through the scheduler's checkpoint path
  (:meth:`FleetScheduler.reclaim_scavengers`) — then activate warm
  gateway spares at zero captures from the warmup manifest
  (``ServingGateway.scale_up`` → ``warmup_from_manifest``, through the
  pool's shared CUDA-graph table);
- **scale-down** (traffic ebbing): drain the least-healthy actives out
  of the routing order (``ServingGateway.scale_down``), release them to
  the spare set a tick later (the drain window), and hand the freed
  slices back to the fleet, where the preempted sweep resumes from its
  checkpoint bitwise.

Robustness is the design, not a feature:

- every rebalance is a **durable, bitwise-replayable record** in the
  fleet queue journal (``plane.rebalance`` events with ``step=""`` —
  the run-state fold ignores them by construction);
  :func:`replay_split` folds the journal into the current split, and a
  restarted arbiter acts on exactly what the dead one decided;
- the rebalance seam is fault-sited (``plane.rebalance`` before the
  durable append, ``plane.scale`` before each gateway action) and
  crash-barriered (``plane.rebalance``: record durable, NEITHER
  consumer resized yet): a restart reconciles — no slice double-booked,
  no tenant lost;
- **convergent apply**: every tick re-applies the replayed split to
  both consumers (idempotent — a no-op when they already match), so a
  failed or killed action self-heals on the next tick instead of
  needing compensation logic;
- **hysteresis**: a scale move needs ``hold_ticks`` CONSECUTIVE
  same-direction votes (mirroring the admission controller's
  count-gating), so a flapping load signal cannot thrash scavenger
  preemptions. The serving gateway's ladder swap holds its candidate
  through the same :class:`Hysteresis`.

Pure decision logic (:func:`desired_replicas`, :class:`Hysteresis`,
:func:`replay_split`) reads no clocks and does no I/O — tests drive it
exactly. The arbiter shares the fleet scheduler's host process and never
initializes CUDA itself: the replicas and the tenants' children own the
card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.pipeline.fleet_queue import QUEUE_NAME, FleetQueue
from sparse_coding_tpu_torch.resilience import lease as lease_mod
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.serve.slo import LoadSignals

register_fault_site("plane.scale",
                    "elastic plane — fires before applying one gateway "
                    "replica scale action (pipeline/plane.py); an "
                    "injected error leaves the replica set unchanged "
                    "and counted (plane.scale_errors), re-applied next "
                    "tick")
register_fault_site("plane.rebalance",
                    "elastic plane — fires before the durable "
                    "plane.rebalance record append (pipeline/plane.py); "
                    "an injected error leaves the journal untouched and "
                    "counted (plane.rebalance_errors), re-voted next "
                    "tick")
register_crash_site("plane.rebalance",
                    "rebalance record durable in the fleet queue "
                    "journal, NEITHER consumer resized yet "
                    "(pipeline/plane.py) — restart must reconcile to "
                    "the recorded split with no slice double-booked")

# journal event name; ``step`` stays "" so pipeline/fleet_queue.py's
# run-state fold skips these records by its existing unknown-run guard
REBALANCE_EVENT = "plane.rebalance"


@dataclass(frozen=True)
class PlaneConfig:
    """The arbiter's static contract: pod size, replica granularity,
    scale envelope, and the load thresholds + hysteresis window."""

    n_slices: int                  # the whole pod, in mesh slices
    replica_slices: int = 1        # slices one gateway replica occupies
    min_replicas: int = 1          # the front door never scales below
    max_replicas: int = 0          # 0 = whatever the slice budget allows
    # scale votes read the SMOOTHED queue depth (LoadTracker EWMA):
    # above up_queued_rows (or any brownout rung) votes up, below
    # down_queued_rows with the ladder open votes down
    up_queued_rows: float = 64.0
    down_queued_rows: float = 8.0
    hold_ticks: int = 2            # consecutive same-direction votes

    def __post_init__(self):
        if self.n_slices < 1 or self.replica_slices < 1:
            raise ValueError("n_slices and replica_slices must be >= 1")
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 (the front door "
                             "never scales to zero)")
        if self.min_replicas * self.replica_slices > self.n_slices:
            raise ValueError("min_replicas cannot outgrow the pod")
        if not 0 <= self.down_queued_rows <= self.up_queued_rows:
            raise ValueError("need 0 <= down_queued_rows <= "
                             "up_queued_rows")
        if self.hold_ticks < 1:
            raise ValueError("hold_ticks must be >= 1")

    def replica_cap(self) -> int:
        """Most replicas the pod (and max_replicas) allows."""
        by_slices = self.n_slices // self.replica_slices
        if self.max_replicas > 0:
            return min(by_slices, self.max_replicas)
        return by_slices

    def clamp(self, replicas: int) -> int:
        return max(self.min_replicas, min(self.replica_cap(), replicas))


@dataclass(frozen=True)
class PlaneSplit:
    """One durable serve/train division of the pod."""

    serve_slices: int
    fleet_slices: int
    seq: int = 0       # journal seq of the record that set it (0 = base)


def desired_replicas(signals: LoadSignals, current: int,
                     cfg: PlaneConfig) -> int:
    """Pure scale vote for ONE tick: ``current`` ±1, clamped. Reads only
    the typed snapshot — smoothed queue depth against the two
    thresholds, plus the brownout rung (a browning-out gateway is
    starved for capacity whatever the queue says). One step per tick:
    the plane trades whole replica blocks, and hysteresis (not vote
    magnitude) is the flap guard."""
    if (signals.queue_depth_ewma > cfg.up_queued_rows
            or signals.admission_level > 0):
        return cfg.clamp(current + 1)
    if (signals.queue_depth_ewma < cfg.down_queued_rows
            and signals.queued_rows == 0
            and signals.admission_level == 0):
        return cfg.clamp(current - 1)
    return cfg.clamp(current)


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


def replay_split(queue: FleetQueue, cfg: PlaneConfig) -> PlaneSplit:
    """Fold the fleet queue journal into the current split — the ONLY
    way any arbiter (first, restarted, or taken-over) knows the
    division. Pure over the journal bytes: the last durable
    ``plane.rebalance`` record wins; with none, the base split is
    ``min_replicas`` worth of serving and the rest fleet."""
    serve = cfg.min_replicas * cfg.replica_slices
    split = PlaneSplit(serve_slices=serve,
                       fleet_slices=cfg.n_slices - serve, seq=0)
    for rec in queue.journal.records():
        if rec.get("event") != REBALANCE_EVENT:
            continue
        detail = rec.get("detail", {}) or {}
        split = PlaneSplit(
            serve_slices=int(detail.get("serve_slices", serve)),
            fleet_slices=int(detail.get("fleet_slices",
                                        cfg.n_slices - serve)),
            seq=int(rec.get("seq", 0)))
    return split


class ElasticPlane:
    """The arbiter. Owns no slices itself — it reads load, appends
    durable rebalance records, and drives both consumers toward the
    recorded split every tick (convergent apply).

    ``gateway`` / ``fleet`` are duck-typed and each optional (a
    fleet-only arbiter still tracks serving's share). ``signals_fn``
    defaults to ``gateway.load_signals`` and is injectable, so a scripted
    load trace drives the decision path deterministically."""

    def __init__(self, fleet_dir: str | Path, config: PlaneConfig, *,
                 gateway=None, fleet=None,
                 signals_fn: Optional[Callable[[], LoadSignals]] = None,
                 clock=time.time):
        self.fleet_dir = Path(fleet_dir)
        self.cfg = config
        self.gateway = gateway
        self.fleet = fleet
        if fleet is not None:
            self.queue = fleet.queue
        else:
            self.queue = FleetQueue(self.fleet_dir / QUEUE_NAME,
                                    clock=clock)
        if signals_fn is None:
            if gateway is None:
                raise ValueError("need a gateway or an explicit "
                                 "signals_fn to read load from")
            signals_fn = gateway.load_signals
        self._signals_fn = signals_fn
        self._hyst = Hysteresis(config.hold_ticks)
        # replicas drained by the last scale-down, released (DRAINING →
        # SPARE) one tick later: the drain window in which their
        # in-flight dispatches finish
        self._draining: list[str] = []
        self._ticks = 0

    # -- durable state --------------------------------------------------------

    def split(self) -> PlaneSplit:
        return replay_split(self.queue, self.cfg)

    def target_replicas(self, split: Optional[PlaneSplit] = None) -> int:
        split = split if split is not None else self.split()
        return split.serve_slices // self.cfg.replica_slices

    def reconcile(self) -> PlaneSplit:
        """The restart path: fold the journal and drive both consumers
        to the last durable split (idempotent — a no-op on a clean
        handover). An arbiter SIGKILLed between its rebalance record and
        the apply leaves a record; THIS is what makes that record the
        truth instead of a lost update."""
        split = self.split()
        self._apply(split)
        obs.counter("plane.reconciles").inc()
        return split

    # -- the control loop -----------------------------------------------------

    def tick(self) -> dict:
        """One arbiter pass: release drained replicas, read signals,
        vote through hysteresis, maybe append a rebalance record, then
        converge both consumers on the (possibly new) split. Returns a
        breadcrumb dict for operators and tests."""
        self._ticks += 1
        self._release_drained()
        signals = self._signals_fn()
        split = self.split()
        current = self.target_replicas(split)
        vote = desired_replicas(signals, current, self.cfg) - current
        move = self._hyst.vote(vote)
        rebalanced = False
        if move:
            target = self.cfg.clamp(current + move)
            if target != current:
                new_split = self._rebalance(target, signals)
                if new_split is not None:
                    split, rebalanced = new_split, True
        self._apply(split)
        # the ladder swap rides the arbiter tick: one derive→hold→swap
        # pass per tick, duck-typed so fleet-only arbiters (and test
        # doubles without the method) are untouched. maybe_swap_ladder
        # never raises — failures are counted skips inside the gateway.
        ladder_swap = None
        swap_fn = getattr(self.gateway, "maybe_swap_ladder", None)
        if swap_fn is not None:
            ladder_swap = swap_fn()
        if ladder_swap is not None:
            obs.counter("plane.ladder_swaps").inc()
        return {"tick": self._ticks, "signals": signals, "split": split,
                "replicas": self.target_replicas(split), "vote": vote,
                "rebalanced": rebalanced,
                "ladder_swapped": ladder_swap is not None}

    def run(self, *, poll_s: float = 0.25,
            max_wall_s: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None) -> None:
        """Drive ticks until ``stop()`` (or ``max_wall_s``). The arbiter
        is a pipeline work loop: it beats the process lease at its
        progress point so the hang watchdog can tell a slow rebalance
        from a dead one."""
        t0 = obs.monotime()
        while not (stop is not None and stop()):
            self.tick()
            if max_wall_s is not None and obs.monotime() - t0 > max_wall_s:
                break
            lease_mod.beat()
            time.sleep(poll_s)

    # -- the rebalance seam ---------------------------------------------------

    def _rebalance(self, replicas: int,
                   signals: LoadSignals) -> Optional[PlaneSplit]:
        """Make one confirmed scale move durable. Order is the whole
        contract: fault site → journal append → crash barrier → (the
        caller applies). An injected fault leaves the journal untouched
        (the hysteresis-confirmed vote re-forms next ticks); a SIGKILL
        at the barrier leaves a durable record a restarted arbiter
        reconciles to."""
        serve = replicas * self.cfg.replica_slices
        fleet_share = self.cfg.n_slices - serve
        direction = "up" if serve > self.split().serve_slices else "down"
        try:
            fault_point("plane.rebalance")
        except Exception:  # noqa: BLE001 — injected/transient: re-vote next tick
            obs.counter("plane.rebalance_errors").inc()
            return None
        rec = self.queue.append(
            REBALANCE_EVENT,
            serve_slices=serve, fleet_slices=fleet_share,
            replicas=replicas, reason=direction,
            queued_rows=signals.queued_rows,
            queue_depth_ewma=round(signals.queue_depth_ewma, 3),
            admission_level=signals.admission_level)
        # THE rebalance instant: the decision is durable, neither
        # consumer has been resized. A SIGKILL here must cost nothing —
        # reconcile() on restart applies this exact record: no
        # double-booking, no lost tenant.
        crash_barrier("plane.rebalance")
        obs.counter("plane.rebalances").inc()
        obs.counter("plane.scale_ups" if direction == "up"
                    else "plane.scale_downs").inc()
        obs.emit_event("plane.rebalance", serve_slices=serve,
                       fleet_slices=fleet_share, reason=direction)
        return PlaneSplit(serve_slices=serve, fleet_slices=fleet_share,
                          seq=int(rec.get("seq", 0)))

    # -- convergent apply -----------------------------------------------------

    def _apply(self, split: PlaneSplit) -> None:
        """Drive both consumers TO the split (idempotent). Shrink-first
        ordering keeps the pod never over-committed in the ledger: the
        fleet's share is capped (and over-share scavengers preempted
        into their checkpoint path) BEFORE the gateway widens, and the
        gateway narrows by drain before the fleet's share grows —
        freed slices flow through the queue's release records, never a
        double-booking."""
        if self.fleet is not None:
            self.fleet.n_slices = split.fleet_slices
            reclaimed = self.fleet.reclaim_scavengers(split.fleet_slices)
            if reclaimed:
                obs.counter("plane.reclaims").inc(len(reclaimed))
        if self.gateway is not None:
            target = self.target_replicas(split)
            active = len(self.gateway.active_replica_names())
            try:
                if active != target:
                    fault_point("plane.scale")
                if active < target:
                    self.gateway.scale_up(target - active)
                elif active > target:
                    self._draining.extend(
                        self.gateway.scale_down(active - target))
            except Exception:  # noqa: BLE001 — injected/transient: re-applied next tick
                obs.counter("plane.scale_errors").inc()
        obs.gauge("plane.serve_slices").set(split.serve_slices)
        obs.gauge("plane.fleet_slices").set(split.fleet_slices)
        obs.gauge("plane.replicas").set(self.target_replicas(split))

    def _release_drained(self) -> None:
        """The drain window closed (one full tick): return replicas the
        plane drained to the spare set, warm for the next scale-up.
        A replica the self-healing pass re-drained or re-activated in
        the meantime is simply skipped."""
        if not self._draining or self.gateway is None:
            return
        for name in self._draining:
            try:
                self.gateway.reinstate(name)
                obs.counter("plane.replicas_released").inc()
            except (KeyError, ValueError):
                continue
        self._draining = []
