"""Durable fleet run queue: the scheduler's only memory (the port's copy
of the JAX package's ``pipeline/fleet_queue.py``, the same file format:
each package replays the other's queue).

One append-only ``fleet_queue.jsonl`` per fleet dir, carried by the same
atomic-append :class:`~sparse_coding_tpu_torch.pipeline.journal.RunJournal`
machinery the per-run supervisor journal uses and the same
bitwise-replay discipline as ``data/ledger.py``: every run transition is
appended BEFORE the scheduler acts on it, records carry no wall-clock-
derived identity, and :func:`FleetQueue.replay` folds the file into the
exact same :class:`~sparse_coding_tpu_torch.pipeline.placement.RunState` map
however many scheduler processes died along the way: a scheduler
SIGKILLed between a ``run.place`` record and the worker spawn (crash
barrier ``fleet.place``) loses no run and places none twice.

Queue events (``step`` carries the run name):

=================  ========================================================
``run.enqueue``    a new run + its spec (priority, slices, kind, config);
                   re-enqueueing a known name is an idempotent no-op
``run.place``      the scheduler decided to spawn this run's worker; the
                   record is durable BEFORE the spawn (``fleet.place``
                   crash barrier sits between the two)
``run.preempt``    a SIGTERM is on its way to the run's worker (chunk-
                   boundary checkpoint path, resilience/preempt.py)
``run.release``    the placement ended: ``outcome`` ∈ done | halted |
                   failed (terminal) or preempted | reclaimed | requeued
                   (back to the queue)
``scheduler.*``    scheduler lifecycle breadcrumbs (start, takeover,
                   stale_kill, done) — ignored by the replay fold
=================  ========================================================

Spec schema (the ``run.enqueue`` record's ``spec``): ``priority``
(serve/slo.py class), ``slices`` (slice request), ``kind``
(``flat`` | ``sharded`` | ``group`` — pipeline/supervisor.py builders
over ``config`` — or ``command``: a single resumable step from ``argv`` +
``done_path``, the cheap-child form the fleet unit tests drive), ``env``
(per-tenant step environment, e.g. a drill's fault plan), and
``max_attempts`` for the per-run worker's supervisor.

The import chain is host-only (journal + placement + serve/slo
constants): ``obs.report``'s fleet section replays the queue on a host
whose card is wedged.
"""

from __future__ import annotations

import fcntl
import time
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from pathlib import Path

from sparse_coding_tpu_torch.pipeline.journal import RunJournal
from sparse_coding_tpu_torch.pipeline.placement import (
    PLACED,
    PREEMPTING,
    QUEUED,
    TERMINAL,
    RunState,
)
from sparse_coding_tpu_torch.resilience.faults import fault_point, register_fault_site
from sparse_coding_tpu_torch.serve.slo import BATCH, priority_rank

QUEUE_NAME = "fleet_queue.jsonl"
RUN_KINDS = ("flat", "sharded", "group", "command")

register_fault_site("fleet.enqueue",
                    "fleet queue admission — the durable run.enqueue "
                    "append (pipeline/fleet_queue.py); an injected error "
                    "propagates to the caller with the queue untouched, "
                    "so a retried enqueue is byte-identical to a "
                    "never-failed one")


@dataclass
class FleetState:
    """One replayed queue: placement-facing run states + the specs the
    per-run workers build their pipelines from."""

    runs: dict[str, RunState] = field(default_factory=dict)
    specs: dict[str, dict] = field(default_factory=dict)
    # torn/corrupt queue lines skipped by the replay fold (scan_records
    # contract) — nonzero after a crash mid-append; fsck reports the tail
    skipped_lines: int = 0

    def terminal(self) -> bool:
        return all(r.state in TERMINAL for r in self.runs.values())

    def summary(self) -> dict[str, str]:
        return {name: r.state for name, r in sorted(self.runs.items())}


def validate_spec(name: str, spec: dict, n_slices: int) -> dict:
    """Front-door validation (everything downstream trusts the queue):
    returns the normalized spec or raises ``ValueError``."""
    if not name or not all(c.isalnum() or c in "._-" for c in name):
        raise ValueError(f"run name {name!r} must be non-empty and use "
                         "only [A-Za-z0-9._-] (it names files)")
    spec = dict(spec)
    priority_rank(spec.setdefault("priority", BATCH))  # raises on unknown
    slices = int(spec.setdefault("slices", 1))
    if not 1 <= slices <= int(n_slices):
        raise ValueError(f"run {name!r} requests {slices} slice(s); this "
                         f"fleet has {n_slices} — it could never place")
    kind = spec.setdefault("kind", "flat")
    if kind not in RUN_KINDS:
        raise ValueError(f"unknown run kind {kind!r} "
                         f"(supported: {RUN_KINDS})")
    if kind == "command":
        if not spec.get("argv") or not spec.get("done_path"):
            raise ValueError("kind='command' runs need argv and done_path")
    elif not isinstance(spec.get("config"), dict):
        raise ValueError(f"kind={kind!r} runs need a config dict "
                         "(pipeline/steps.py schema)")
    spec.setdefault("env", {})
    spec.setdefault("max_attempts", 2)
    # the worker Supervisor's hang window (pipeline/fleet.py run_worker)
    spec["heartbeat_stale_s"] = float(
        spec.setdefault("heartbeat_stale_s", 120.0))
    return spec


class FleetQueue:
    """Writer+reader for one fleet dir's queue file."""

    def __init__(self, path: str | Path, clock=time.time):
        self.journal = RunJournal(path, clock=clock)
        self.path = Path(path)

    @contextmanager
    def _locked(self):
        """Same-host append serialization: the journal's atomic append is
        read+rewrite, and the queue — unlike a per-run journal — has TWO
        legitimate writers (the live scheduler, and an operator enqueueing
        into a running fleet). An flock sidecar makes concurrent appends
        lose nothing; readers need no lock (the rewrite is atomic)."""
        lock_path = self.path.with_suffix(self.path.suffix + ".lock")
        with open(lock_path, "w") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    def append(self, event: str, run: str = "", **detail) -> dict:
        with self._locked():
            return self.journal.append(event, run, **detail)

    def enqueue(self, name: str, spec: dict, n_slices: int) -> bool:
        """Admit one run; idempotent (a known name is left untouched, so
        an enqueue-then-crash caller can blindly re-enqueue). Fault site
        ``fleet.enqueue`` fires BEFORE the durable append."""
        spec = validate_spec(name, spec, n_slices)
        fault_point("fleet.enqueue")
        with self._locked():
            if name in self.replay().runs:
                return False
            self.journal.append("run.enqueue", name, spec=spec)
        return True

    def replay(self) -> FleetState:
        """Fold the queue file into the current state — the ONLY way any
        scheduler (first, restarted, or taken-over) knows the fleet.
        Torn-tail safe: a crash mid-append can leave an unterminated final
        line that still PARSES as JSON (a truncated ``{"seq": 12}`` reads
        as ``{"seq": 1}``), so the fold uses the strict newline-terminated
        reader and counts what it skipped instead of folding it."""
        recs, skipped = self.journal.scan_records()
        st = FleetState(skipped_lines=skipped)
        for rec in recs:
            event = rec.get("event", "")
            name = rec.get("step", "")
            detail = rec.get("detail", {}) or {}
            if event == "run.enqueue":
                if name in st.runs:
                    continue  # idempotent re-enqueue
                spec = detail.get("spec", {})
                st.specs[name] = spec
                st.runs[name] = RunState(
                    name=name, priority=spec.get("priority", BATCH),
                    slices=int(spec.get("slices", 1)), state=QUEUED,
                    seq=int(rec.get("seq", 0)))
            elif name not in st.runs:
                continue  # scheduler.* breadcrumbs and operator edits
            elif event == "run.place":
                st.runs[name] = replace(
                    st.runs[name], state=PLACED,
                    placed_seq=int(rec.get("seq", 0)),
                    attempts=st.runs[name].attempts + 1)
            elif event == "run.preempt":
                if st.runs[name].state == PLACED:
                    st.runs[name] = replace(st.runs[name], state=PREEMPTING)
            elif event == "run.release":
                outcome = str(detail.get("outcome", "failed"))
                new = outcome if outcome in TERMINAL else QUEUED
                st.runs[name] = replace(
                    st.runs[name], state=new,
                    requeues=st.runs[name].requeues
                    + (1 if outcome == "requeued" else 0))
        return st
