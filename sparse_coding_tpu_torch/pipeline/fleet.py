"""Fleet scheduler: many tenants' runs bin-packed onto one host's cards
(the port's counterpart of the JAX package's ``pipeline/fleet.py``).

The crash-only supervisor (pipeline/supervisor.py) runs ONE
harvest→sweep→eval chain; production is many tenants' sweeps, scrubs
and evals sharing the hardware. This module is the successor of the
reference's ``cluster_runs.py`` ``dispatch_job_on_chunk``
one-GPU-per-job loop, built on the same reliability substrate:

- a **durable run queue** (:mod:`pipeline.fleet_queue` — atomic appends,
  bitwise replay) is the scheduler's ONLY memory: a restarted or
  taken-over scheduler folds the queue file and continues exactly;
- **placement** is :mod:`pipeline.placement`'s pure priority bin-packing
  over ``serve/slo.py``'s interactive/batch/scavenger classes; scavenger
  runs are preempted for higher classes via SIGTERM at chunk boundaries
  (resilience/preempt.py — a checkpoint, never a kill);
- each placed run gets a **per-run worker** subprocess (``python -m
  sparse_coding_tpu_torch.pipeline.fleet worker``): a plain Supervisor
  over the run's OWN dir (``runs/<name>/`` — own journal, leases, obs
  stream, guardian ledger), so every per-run reliability contract keeps
  holding per tenant;
- **containment** is the headline: a tenant whose guardian halts
  (rollback ladder exhausted on poisoned data) exits typed
  (``STEP_EXIT_HALTED``), the scheduler marks the run ``halted``,
  re-packs the freed slice, and every other tenant's work — and the
  serving pool — never notices;
- **warm tenants**: the JAX package's tenants share one executable cache
  (``<fleet_dir>/xcache``). The port has no executable store (a CUDA
  graph cannot outlive its process, ``xcache/__init__.py``), so its
  contract is two rules: a tenant runs no nvcc build (every kernel
  library loads from ``ops/_build/``, built once, ``ops/_build.py``
  ``NVCC_RUNS``), and it captures no CUDA graph outside a warmup. The
  scheduler still points every tenant's capture cache at
  ``<fleet_dir>/xcache``, so their warmup manifests land in one place;
- scheduler-level failure is itself in the harness: fault sites
  ``fleet.enqueue`` / ``fleet.place`` / ``fleet.preempt`` and the crash
  barrier ``fleet.place`` between queue durability and the worker spawn
  (SIGKILL there → the restart replays the queue bitwise, no run lost or
  double-placed).

Each scheduler keeps its own obs registry (as each Supervisor does): the
host process's counters are not the fleet's, and a fleet dir that sees
several schedulers must not sum one process's counters twice. The
scheduler itself never initializes CUDA; its workers' step children own
the card. A worker is a Python process that imports torch (the package
root does), so each costs an interpreter start plus ``import torch``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.pipeline.fleet_queue import (
    QUEUE_NAME,
    FleetQueue,
    FleetState,
)
from sparse_coding_tpu_torch.pipeline.placement import (
    PLACED,
    PREEMPTING,
    QUEUED,
    plan_placement,
)
from sparse_coding_tpu_torch.pipeline.supervisor import (
    REPO_ROOT,
    STEP_EXIT_HALTED,
    STEP_EXIT_PREEMPTED,
    ConcurrentSupervisorError,
    StepHalted,
    StepPreempted,
    Supervisor,
    _kill_pid,
    build_pipeline,
    build_sharded_pipeline,
)
from sparse_coding_tpu_torch.resilience import lease as lease_mod
from sparse_coding_tpu_torch.resilience.crash import crash_barrier, register_crash_site
from sparse_coding_tpu_torch.resilience.faults import fault_point, register_fault_site
from sparse_coding_tpu_torch.resilience.lease import (
    Lease,
    lease_state,
    read_lease,
    seed_lease,
)
from sparse_coding_tpu_torch.resilience.preempt import PreemptionGuard
from sparse_coding_tpu_torch.serve.slo import SCAVENGER

register_fault_site("fleet.place",
                    "fleet placement decision — fires before the durable "
                    "run.place append (pipeline/fleet.py); an injected "
                    "error leaves the run queued and counted "
                    "(fleet.place_errors), re-planned next tick")
register_fault_site("fleet.preempt",
                    "fleet preemption — fires before the run.preempt "
                    "append + SIGTERM (pipeline/fleet.py); an injected "
                    "error leaves the victim running and counted "
                    "(fleet.preempt_errors), re-planned next tick")
register_crash_site("fleet.place",
                    "run.place queue record durable, the worker not yet "
                    "spawned (pipeline/fleet.py) — the no-run-lost/"
                    "none-double-placed instant")

# worker exit codes mirror the step codes (the worker's supervisor maps
# child exits onto typed errors; the worker maps those back to its own
# exit status for the scheduler)
WORKER_EXIT_PREEMPTED = STEP_EXIT_PREEMPTED
WORKER_EXIT_HALTED = STEP_EXIT_HALTED

SCHEDULER_LEASE = "fleet.json"


def worker_lease_path(fleet_dir: str | Path, name: str) -> Path:
    return Path(fleet_dir) / "leases" / f"run-{name}.json"


def run_dir_for(fleet_dir: str | Path, name: str) -> Path:
    return Path(fleet_dir) / "runs" / name


class FleetScheduler:
    """Run the fleet dir's queue to completion. Construction is cheap and
    disk-stateless; ``run()`` on a fresh instance over an old fleet dir
    IS the restart path (crash-only, like the supervisor it spawns)."""

    def __init__(self, fleet_dir: str | Path, *, n_slices: int = 1,
                 max_concurrent: int = 1, max_run_attempts: int = 2,
                 heartbeat_stale_s: float = 120.0, poll_s: float = 0.25,
                 max_wall_s: Optional[float] = None, clock=time.time):
        self.fleet_dir = Path(fleet_dir)
        self.n_slices = int(n_slices)
        self.max_concurrent = int(max_concurrent)
        self.max_run_attempts = int(max_run_attempts)
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        self.poll_s = float(poll_s)
        self.max_wall_s = max_wall_s
        self._clock = clock
        self.queue = FleetQueue(self.fleet_dir / QUEUE_NAME, clock=clock)
        self._workers: dict[str, subprocess.Popen] = {}
        # this scheduler's counters (placements, preemptions, halts...),
        # flushed into its own event file under <fleet_dir>/obs
        self.registry = obs.Registry()
        self._sink: Optional[obs.EventSink] = None
        self._lease: Optional[Lease] = None
        for sub in ("leases", "logs", "runs", "obs"):
            (self.fleet_dir / sub).mkdir(parents=True, exist_ok=True)

    # -- queue front door -----------------------------------------------------

    def enqueue(self, name: str, config: Optional[dict] = None, *,
                priority: str = "batch", slices: int = 1,
                kind: str = "flat", env: Optional[dict] = None,
                max_attempts: int = 2, argv: Optional[list] = None,
                done_path: Optional[str | Path] = None,
                heartbeat_stale_s: Optional[float] = None) -> bool:
        """Admit one tenant run (idempotent on a known name). ``env``
        rides into every step of the run's pipeline — a tenant-scoped
        fault plan in a drill, a tenant's credentials in production.
        ``heartbeat_stale_s`` sets the worker Supervisor's hang window
        for this run's step children; it defaults to THIS scheduler's
        window so the two watchdog layers stay aligned."""
        spec = {"priority": priority, "slices": int(slices), "kind": kind,
                "env": dict(env or {}), "max_attempts": int(max_attempts),
                "heartbeat_stale_s": float(
                    heartbeat_stale_s if heartbeat_stale_s is not None
                    else self.heartbeat_stale_s)}
        if config is not None:
            spec["config"] = config
        if argv is not None:
            spec["argv"] = [str(a) for a in argv]
        if done_path is not None:
            spec["done_path"] = str(done_path)
        return self.queue.enqueue(name, spec, self.n_slices)

    # -- cold-state audit ------------------------------------------------------

    def fsck_sweep(self, repair: bool = False):
        """Audit the whole fleet tree — queue, scheduler leases, every
        tenant's ``runs/<name>/`` dir and its artifact roots — with fsck
        and leave a queue breadcrumb. Meant
        for a COLD fleet (no live scheduler lease); per-tenant rot then
        also halts at that tenant's own resume preflight, but the sweep
        sees cross-tenant state (orphan run dirs, queue⇔dir drift) no
        single worker can."""
        from sparse_coding_tpu_torch.fsck.core import run_fsck

        report = run_fsck(self.fleet_dir, repair=repair)
        self.queue.append(
            "scheduler.fsck", findings=len(report.findings),
            fatal=[f.path for f in report.fatal],
            repaired=len(report.repaired))
        return report

    # -- scheduler lease (contention + takeover) ------------------------------

    @property
    def lease_path(self) -> Path:
        return self.fleet_dir / "leases" / SCHEDULER_LEASE

    def _acquire_lease(self) -> None:
        state = lease_state(self.lease_path, self.heartbeat_stale_s,
                            clock=self._clock)
        info = read_lease(self.lease_path)
        pid = info.pid if info is not None else -1
        if state == "live":
            raise ConcurrentSupervisorError(
                f"fleet dir {self.fleet_dir} has a live heartbeating "
                f"scheduler lease (pid {pid}); refusing to "
                "double-run the fleet")
        if state == "stale":
            self.queue.append("scheduler.stale_kill", pid=pid)
            _kill_pid(pid)
        elif state == "dead":
            self.queue.append("scheduler.takeover", pid=pid)
        self._lease = Lease(self.lease_path, step="fleet",
                            clock=self._clock)

    # -- the scheduling loop --------------------------------------------------

    def run(self) -> dict[str, str]:
        """Drive every queued run to a terminal state; returns
        ``{run: done|halted|failed}``. Crash-only: raising (or dying) at
        any instant leaves a queue a fresh ``run()`` resumes exactly."""
        self._acquire_lease()
        self._sink = obs.EventSink(
            self.fleet_dir / "obs" / f"fleet-{os.getpid()}.jsonl")
        self.queue.append("scheduler.start",
                          n_slices=self.n_slices,
                          max_concurrent=self.max_concurrent)
        t0 = obs.monotime()
        try:
            self._reclaim_orphans(self.queue.replay())
            while True:
                st = self.queue.replay()
                plan = plan_placement(list(st.runs.values()), self.n_slices,
                                      self.max_concurrent)
                for name in plan.preempt:
                    self._preempt(name)
                for name in plan.place:
                    self._place(name)
                self._poll_workers()
                st = self.queue.replay()
                if st.terminal() and not self._workers:
                    break
                if self.max_wall_s is not None and \
                        obs.monotime() - t0 > self.max_wall_s:
                    raise TimeoutError(
                        f"fleet did not drain within {self.max_wall_s}s "
                        f"(states: {st.summary()})")
                # the scheduler's own heartbeat: a second scheduler (or a
                # takeover probe) reads liveness off this lease
                self._lease.beat()
                time.sleep(self.poll_s)
            summary = st.summary()
            self.queue.append("scheduler.done", summary=summary)
            obs.record_span("fleet.run", obs.monotime() - t0,
                            sink=self._sink, registry=self.registry,
                            summary=dict(summary))
            return summary
        finally:
            # abnormal exits (max_wall_s timeout, KeyboardInterrupt, a
            # queue I/O error) leave live worker groups behind — and THIS
            # process survives, so no future takeover would reclaim them
            # before, e.g., an orphaned step child keeps holding the card
            # against the caller's next run. Crash-only makes the kill
            # free: SIGKILL the groups and release the placements so the
            # queue stays accurate for the next scheduler.
            self._shutdown_workers()
            obs.flush_metrics(sink=self._sink, registry=self.registry)
            self._sink.close()
            self._sink = None
            if self._lease is not None:
                self._lease.release()
                self._lease = None

    def _shutdown_workers(self) -> None:
        for name, proc in list(self._workers.items()):
            if proc.poll() is None:
                self._signal_group(name, signal.SIGKILL)
                _kill_pid(proc.pid)
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            del self._workers[name]
            self.queue.append("run.release", name, outcome="reclaimed",
                              note="scheduler shutdown")
            worker_lease_path(self.fleet_dir, name).unlink(missing_ok=True)
            self.registry.counter("fleet.reclaims").inc()

    # -- actions --------------------------------------------------------------

    def _place(self, name: str) -> None:
        assert name not in self._workers, f"double-place of {name!r}"
        try:
            fault_point("fleet.place")
        except Exception:  # noqa: BLE001 — injected/transient: re-plan next tick
            self.registry.counter("fleet.place_errors").inc()
            return
        st = self.queue.replay()
        attempt = st.runs[name].attempts + 1
        self.queue.append("run.place", name, attempt=attempt)
        # THE placement instant: the queue knows the run is placed, the
        # worker does not exist yet. A SIGKILL here must cost nothing —
        # the restarted scheduler reclaims the orphan placement and
        # re-places: no run lost, none placed twice.
        crash_barrier("fleet.place")
        log_path = self.fleet_dir / "logs" / f"{name}.{attempt}.log"
        env = dict(os.environ)
        env[lease_mod.ENV_PATH] = str(worker_lease_path(self.fleet_dir,
                                                        name))
        # one capture-cache dir for every tenant: their warmup manifests
        # land together (the port has no executable store; a tenant starts
        # warm by loading the kernel libraries in ops/_build/ with no nvcc
        # run). setdefault: an operator-pinned dir wins.
        from sparse_coding_tpu_torch.xcache import ENV_DIR as XCACHE_ENV_DIR

        env.setdefault(XCACHE_ENV_DIR, str(self.fleet_dir / "xcache"))
        from sparse_coding_tpu_torch.obs.ledger import ENV_LEDGER, LEDGER_NAME

        env.setdefault(ENV_LEDGER, str(self.fleet_dir / LEDGER_NAME))
        argv = [sys.executable, "-m", "sparse_coding_tpu_torch.pipeline.fleet",
                "worker", "--fleet-dir", str(self.fleet_dir),
                "--run", name]
        with open(log_path, "ab") as log_fh:
            # own session/process group: a preemption SIGTERMs the GROUP,
            # so the worker's step children get the graceful checkpoint
            # signal directly (resilience/preempt.py)
            proc = subprocess.Popen(argv, cwd=str(REPO_ROOT), env=env,
                                    stdout=log_fh,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        seed_lease(worker_lease_path(self.fleet_dir, name), proc.pid,
                   step=f"run-{name}", clock=self._clock)
        self._workers[name] = proc
        self.registry.counter("fleet.placements").inc()
        obs.emit_event("fleet.place", sink=self._sink, run_name=name,
                       attempt=attempt, pid=proc.pid)

    def _preempt(self, name: str) -> bool:
        try:
            fault_point("fleet.preempt")
        except Exception:  # noqa: BLE001 — injected/transient: re-plan next tick
            self.registry.counter("fleet.preempt_errors").inc()
            return False
        self.queue.append("run.preempt", name)
        self._signal_group(name, signal.SIGTERM)
        self.registry.counter("fleet.preemptions").inc()
        obs.emit_event("fleet.preempt", sink=self._sink, run_name=name)
        return True

    def reclaim_scavengers(self, max_slices: int) -> list[str]:
        """Elastic-plane reclaim (pipeline/plane.py): when the arbiter
        shrinks the fleet's share of the pod, SIGTERM-preempt
        most-recently-placed scavenger runs until the slices held by
        live scavengers fit ``max_slices``. Rides the exact ``_preempt``
        path (durable ``run.preempt`` + group SIGTERM at a chunk
        boundary), so a reclaimed sweep checkpoints and later resumes
        bitwise. Only scavengers are plane-reclaimable — higher classes
        keep their slices until they finish. Returns the names
        signaled."""
        st = self.queue.replay()
        # PREEMPTING runs are already on their way to freeing their
        # slices — counting them toward usage would cascade one extra
        # SIGTERM per tick onto still-useful sweeps while the first
        # victim drains (the futile-preemption class the placement
        # planner also guards against)
        victims = sorted((r for r in st.runs.values()
                          if r.state == PLACED
                          and r.priority == SCAVENGER),
                         key=lambda r: -r.placed_seq)
        usage = sum(r.slices for r in victims)
        signaled: list[str] = []
        for victim in victims:
            if usage <= max(0, int(max_slices)):
                break
            if self._preempt(victim.name):
                usage -= victim.slices
                signaled.append(victim.name)
        return signaled

    def _signal_group(self, name: str, sig: int) -> None:
        proc = self._workers.get(name)
        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError, OSError):
            _kill_pid(proc.pid)

    # -- worker lifecycle -----------------------------------------------------

    def _poll_workers(self) -> None:
        st = None
        for name, proc in list(self._workers.items()):
            if proc.poll() is None:
                st = st or self.queue.replay()
                self._watch_live_worker(name, proc, st)
                continue
            del self._workers[name]
            st = st or self.queue.replay()
            run = st.runs.get(name)
            rc = proc.returncode
            outcome = self._classify_exit(rc, run)
            self.queue.append("run.release", name, outcome=outcome, rc=rc)
            worker_lease_path(self.fleet_dir, name).unlink(missing_ok=True)
            self.registry.counter("fleet.releases", outcome=outcome).inc()
            if outcome == "halted":
                self.registry.counter("fleet.halts").inc()
            obs.emit_event("fleet.release", sink=self._sink, run_name=name,
                           outcome=outcome, rc=rc)
            st = None  # release changed the state: re-fold next use

    def _classify_exit(self, rc: int, run) -> str:
        preempting = run is not None and run.state == PREEMPTING
        if rc == 0:
            # a preempted worker that still finished cleanly is done —
            # the SIGTERM raced completion; done beats re-queue
            return "done"
        if rc == WORKER_EXIT_HALTED:
            # contained: this tenant's guardian halted ITS run; the slice
            # frees and the queue re-packs — nobody else notices
            return "halted"
        if rc == WORKER_EXIT_PREEMPTED or preempting:
            return "preempted"
        # the crash budget counts CRASHES (prior "requeued" releases plus
        # this one), never place records: a preempted or reclaimed run has
        # consumed placements without failing, and must keep its retries
        crashes = (run.requeues if run is not None
                   else self.max_run_attempts) + 1
        if crashes >= self.max_run_attempts:
            return "failed"
        return "requeued"  # crash: the run is resumable by contract

    def _watch_live_worker(self, name: str, proc, st: FleetState) -> None:
        """A live worker owes heartbeats (its supervisor beats while
        babysitting a child); a stale one is hung — SIGKILL the group and
        let the exit path re-queue (crash-only: the run resumes). A
        PREEMPTING worker is re-signaled each tick: a step child spawned
        in the instant between the group SIGTERM and the worker noticing
        would otherwise never see the preemption."""
        run = st.runs.get(name)
        if run is not None and run.state == PREEMPTING:
            self._signal_group(name, signal.SIGTERM)
        path = worker_lease_path(self.fleet_dir, name)
        if lease_state(path, self.heartbeat_stale_s,
                       clock=self._clock) == "stale":
            self.queue.append("run.hung", name, pid=proc.pid)
            self.registry.counter("fleet.worker_hangs").inc()
            self._signal_group(name, signal.SIGKILL)
            _kill_pid(proc.pid)

    def _reclaim_orphans(self, st: FleetState) -> None:
        """Startup pass: runs the queue believes are placed but no worker
        of OURS exists. A dead/stale owner is reclaimed (re-queued — the
        run's done-markers make a re-run converge, so reclaim can never
        double-apply work); a live-heartbeating owner whose scheduler
        died is SIGKILLed first — two schedulers' workers must never
        share one run dir, and crash-only makes the kill free."""
        for name, run in st.runs.items():
            if run.state not in (PLACED, PREEMPTING) or \
                    name in self._workers:
                continue
            path = worker_lease_path(self.fleet_dir, name)
            state = lease_state(path, self.heartbeat_stale_s,
                                clock=self._clock)
            info = read_lease(path)
            if state in ("live", "stale") and info is not None:
                self.queue.append("run.orphan_kill", name, pid=info.pid,
                                  lease=state)
                try:
                    os.killpg(info.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    _kill_pid(info.pid)
            self.queue.append("run.release", name, outcome="reclaimed")
            path.unlink(missing_ok=True)
            self.registry.counter("fleet.reclaims").inc()


# -- the per-run worker -------------------------------------------------------


def build_run_steps(run_dir: Path, spec: dict) -> list:
    """The run's step DAG from its queue spec: the flat, sharded, or
    group-tenant builders over ``spec['config']``, or the single
    resumable command step the cheap-child tests drive. Tenant env rides
    every step. ``kind="group"`` is one Group-SAE tenant: the
    sweep → eval (→ catalog) tail over its pooled store view, no harvest
    edge — ``groups.json`` was durable before enqueue."""
    from sparse_coding_tpu_torch.pipeline.supervisor import (
        Step,
        build_group_tenant_pipeline,
    )

    kind = spec.get("kind", "flat")
    if kind == "command":
        done = Path(spec["done_path"])
        steps = [Step("main", [str(a) for a in spec["argv"]],
                      done=done.exists)]
    else:
        builder = (build_sharded_pipeline if kind == "sharded"
                   else build_group_tenant_pipeline if kind == "group"
                   else build_pipeline)
        steps = builder(run_dir, spec["config"])
    for step in steps:
        merged = dict(spec.get("env") or {})
        merged.update(step.env)
        step.env = merged
    return steps


def run_worker(fleet_dir: str | Path, name: str,
               guard: Optional[PreemptionGuard] = None) -> int:
    """One placed run, driven by a plain Supervisor over the run's own
    dir. Exit status is the scheduler's contract: 0 done,
    ``WORKER_EXIT_PREEMPTED`` checkpointed-and-resumable,
    ``WORKER_EXIT_HALTED`` guardian-contained, anything else a crash the
    queue re-judges. SIGTERM is trapped as a FLAG (resilience/preempt.py)
    — the worker must outlive its step child's graceful checkpoint exit,
    not die first and orphan it. (The CLI installs the guard at interpreter
    entry; a SIGTERM landing even earlier — mid-import — kills the worker,
    which the scheduler re-judges as a crash: re-queued, resumable.)"""
    fleet_dir = Path(fleet_dir)
    queue = FleetQueue(fleet_dir / QUEUE_NAME)
    spec = queue.replay().specs.get(name)
    if spec is None:
        print(f"fleet worker: unknown run {name!r}", file=sys.stderr)
        return 2
    lease_mod.configure_from_env(step=f"run-{name}")
    run_dir = run_dir_for(fleet_dir, name)
    guard = guard if guard is not None else PreemptionGuard()
    with guard:
        sup = Supervisor(
            run_dir, build_run_steps(run_dir, spec),
            max_attempts=int(spec.get("max_attempts", 2)),
            heartbeat_stale_s=float(spec.get("heartbeat_stale_s", 120.0)),
            preempt_flag=lambda: guard.requested)
        try:
            sup.run()
            return 0
        except StepPreempted:
            return WORKER_EXIT_PREEMPTED
        except StepHalted:
            return WORKER_EXIT_HALTED
        except Exception as e:  # noqa: BLE001 — typed for the log, coded for the queue
            if guard.requested:
                # the SIGTERM landed mid-step on a child without the
                # graceful path (or the retry raced the flag): the run is
                # still resumable — report preempted, not crashed
                print(f"fleet worker: preempted during {e!r}",
                      file=sys.stderr)
                return WORKER_EXIT_PREEMPTED
            print(f"fleet worker: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1


# -- CLI ----------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    # WORKER ONLY: trap SIGTERM before anything else — a preemption
    # arriving during argument parsing or queue replay must flag, not
    # kill (the guard is handed to run_worker so the flag survives into
    # the supervisor). The scheduler keeps default SIGTERM: an operator
    # stopping the fleet is not a preemption.
    raw = list(sys.argv[1:] if argv is None else argv)
    entry_guard = PreemptionGuard() if "worker" in raw[:1] else None
    if entry_guard is not None:
        entry_guard.__enter__()

    parser = argparse.ArgumentParser(
        prog="python -m sparse_coding_tpu_torch.pipeline.fleet",
        description="fleet scheduler: drive a fleet dir's run queue")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sched = sub.add_parser("schedule", help="drive the fleet queue")
    sched.add_argument("--fleet-dir", required=True)
    sched.add_argument("--slices", type=int, default=1)
    sched.add_argument("--max-concurrent", type=int, default=1)
    sched.add_argument("--poll-s", type=float, default=0.25)
    sched.add_argument("--stale-s", type=float, default=120.0)
    sched.add_argument("--max-wall-s", type=float, default=None)
    worker = sub.add_parser("worker", help="run one placed run")
    worker.add_argument("--fleet-dir", required=True)
    worker.add_argument("--run", required=True)
    fsck = sub.add_parser("fsck", help="audit (and optionally repair) the "
                                       "whole fleet tree's durable state")
    fsck.add_argument("--fleet-dir", required=True)
    fsck.add_argument("--repair", action="store_true")
    args = parser.parse_args(argv)
    if args.cmd == "worker":
        return run_worker(args.fleet_dir, args.run, guard=entry_guard)
    if args.cmd == "fsck":
        report = FleetScheduler(args.fleet_dir).fsck_sweep(
            repair=args.repair)
        print(json.dumps({"findings": len(report.findings),
                          "fatal": len(report.fatal),
                          "repaired": len(report.repaired),
                          "clean": report.clean}, sort_keys=True))
        return 2 if report.fatal else (0 if report.clean else 1)
    summary = FleetScheduler(
        args.fleet_dir, n_slices=args.slices,
        max_concurrent=args.max_concurrent, poll_s=args.poll_s,
        heartbeat_stale_s=args.stale_s, max_wall_s=args.max_wall_s).run()
    print(" ".join(f"{k}={v}" for k, v in sorted(summary.items())))
    return 0 if all(v == "done" for v in summary.values()) else 3


if __name__ == "__main__":
    sys.exit(main())
