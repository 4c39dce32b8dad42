"""Priority bin-packing of fleet runs onto slices (the port's copy of the
JAX package's ``pipeline/placement.py``).

The fleet scheduler (pipeline/fleet.py) owns its devices carved into
``n_slices`` equal slices — the unit a run requests (a tenant's sweep
asking for 2 slices is asking for 2/n of the devices). This module is the
placement BRAIN and nothing else: a pure function from (run states,
slice count, concurrency cap) to the actions the scheduler should take
this tick. No clocks, no I/O, no randomness — tests drive it exactly,
and a replayed queue always re-derives the same plan.

Rules, in order:

- **priority classes** are ``serve/slo.py``'s ladder — the fleet and the
  serving front door mean the same thing by ``interactive`` >
  ``batch`` > ``scavenger`` (ties broken by enqueue order, so the plan
  is total-ordered and deterministic);
- **first-fit, no backfill**: queued runs are considered strictly in
  that order, and the first run that cannot start BLOCKS every run
  behind it. Backfilling small low-priority runs around a blocked big
  one would starve it forever on a busy pod — a blocked head run
  instead drains the pod until it fits;
- **preemption, scavenger-only victims**: when the blocked head run is
  ``interactive`` or ``batch``, running scavenger runs are SIGTERMed at
  their next chunk boundary (resilience/preempt.py — the checkpoint
  path, never a kill), most-recently-placed first, until the head run
  would fit. Preempted slices free only when the worker actually exits
  (the scheduler re-queues the run), so a preemption tick plans
  victims, and a later tick places the beneficiary;
- ``max_concurrent`` caps simultaneously-running workers below the
  slice count (``max_concurrent=1`` runs one tenant at a time over any
  logical slice count: the same queue and decisions, serialized).
"""

from __future__ import annotations

from dataclasses import dataclass

from sparse_coding_tpu_torch.serve.slo import SCAVENGER, priority_rank

# queue-replay run states (pipeline/fleet.py fold): the planner only
# reads these; every transition is a durable queue record
QUEUED = "queued"
PLACED = "placed"
PREEMPTING = "preempting"
TERMINAL = ("done", "halted", "failed")


@dataclass(frozen=True)
class RunState:
    """One run as the queue replay sees it."""

    name: str
    priority: str
    slices: int
    state: str
    seq: int          # first-enqueue order (the FIFO tiebreak)
    placed_seq: int = 0   # seq of the latest place record (victim order)
    attempts: int = 0     # how many place records the run has consumed
    # crash-requeue count ONLY (release outcome "requeued"): preemptions
    # and scheduler-restart reclaims are scheduling events, not failures,
    # and must never burn the run's crash-retry budget
    requeues: int = 0


@dataclass(frozen=True)
class PlacementPlan:
    """One tick's actions, in execution order."""

    place: tuple[str, ...]
    preempt: tuple[str, ...]
    blocked: tuple[str, ...]  # queued runs that could not start this tick


def plan_placement(runs: list[RunState], n_slices: int,
                   max_concurrent: int = 0) -> PlacementPlan:
    """The one placement decision. ``max_concurrent=0`` means "slice
    count is the only cap". Runs whose request can NEVER fit
    (``slices > n_slices``) are not planned — the scheduler fails them
    at enqueue validation, so here they simply block."""
    n_slices = int(n_slices)
    cap = int(max_concurrent) or n_slices
    active = [r for r in runs if r.state in (PLACED, PREEMPTING)]
    used = sum(r.slices for r in active)
    running = len(active)
    queued = sorted((r for r in runs if r.state == QUEUED),
                    key=lambda r: (priority_rank(r.priority), r.seq))

    place: list[str] = []
    preempt: list[str] = []
    blocked: list[str] = []
    # scavenger victims, most-recently-placed first; PREEMPTING runs are
    # already on their way out and must not be signaled twice
    victims = sorted((r for r in active
                      if r.state == PLACED and r.priority == SCAVENGER),
                     key=lambda r: -r.placed_seq)
    for run in queued:
        if blocked:
            blocked.append(run.name)  # no backfill behind a blocked head
            continue
        if used + run.slices <= n_slices and running < cap:
            place.append(run.name)
            used += run.slices
            running += 1
            continue
        if priority_rank(run.priority) < priority_rank(SCAVENGER):
            # drain scavengers until this head run WOULD fit (capacity
            # and concurrency); placement happens on a later tick, once
            # the preempted workers have checkpointed and exited.
            # Futility guard first: if draining EVERY scavenger still
            # could not fit the head run (capacity- or slot-wise), plan
            # no victims at all — SIGTERMing useful work that frees
            # nothing the head can use is pure loss
            need = used + run.slices - n_slices
            reclaimable = sum(v.slices for v in victims)
            if reclaimable >= need and running - len(victims) < cap:
                freed = 0
                while victims and (freed < need or running >= cap):
                    victim = victims.pop(0)
                    preempt.append(victim.name)
                    freed += victim.slices
                    running -= 1
        blocked.append(run.name)
    return PlacementPlan(place=tuple(place), preempt=tuple(preempt),
                         blocked=tuple(blocked))
