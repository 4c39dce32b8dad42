"""Crash-only pipeline supervisor: the journaled harvest → sweep → eval →
catalog DAG (the port's counterpart of the JAX package's
``pipeline/supervisor.py``).

The paper's workflow is a long unattended chain — harvest activations,
train SAE ensembles, evaluate and catalog the dictionaries — and that
chain must survive whole-process death and a wedged card, not only the
in-process I/O faults. The design is **crash-only**: there is no
graceful shutdown path that recovery depends on — recovery IS the normal
start path.

- every step runs as a **child process** (the unit that dies); the
  supervisor holds no state it cannot rebuild from the journal and the
  artifacts, so the supervisor may die too;
- each step owns a **lease file** with progress heartbeats
  (:mod:`resilience.lease`): a restarted supervisor tells "crashed"
  (owner pid dead → take over) from "hung" (owner alive, heartbeat stale
  → kill) from "still running" (refuse);
- a **watchdog** polls the live child's lease; when the heartbeat goes
  stale it probes the card from a process of its own
  (:mod:`resilience.watchdog`) and decides retry / degrade-to-CPU / halt;
- steps are **resumable by contract**, so "retry" is always "respawn the
  same command", and a finished run's artifacts are bitwise the
  uninterrupted run's.

**The device.** Children run on the card by default: every entry point
they call resolves ``device=None`` to ``cuda`` and raises without one.
``cpu_only=True`` and a degraded respawn (the watchdog's journaled
``step.hung`` → ``step.spawn degraded=true``) set
``SPARSE_CODING_DEVICE=cpu`` (``pipeline/steps.py`` passes it to every
entry point) and hide the card (``CUDA_VISIBLE_DEVICES=""``); nothing
else moves a step off the card. The supervisor never initializes CUDA.

Execution is serial (topological order), as in the JAX package: the
DAG's edges are data dependencies, and the steps share one card.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Sequence

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.pipeline.journal import RunJournal
from sparse_coding_tpu_torch.pipeline.steps import ENV_DEVICE
from sparse_coding_tpu_torch.resilience import lease as lease_mod
from sparse_coding_tpu_torch.resilience import watchdog as watchdog_mod
from sparse_coding_tpu_torch.resilience.errors import ResilienceError
from sparse_coding_tpu_torch.resilience.lease import (
    lease_state,
    read_lease,
    seed_lease,
)
from sparse_coding_tpu_torch.resilience.watchdog import (
    DEGRADE_CPU,
    HALT,
    classify_hang,
    format_diagnosis,
)

REPO_ROOT = Path(__file__).resolve().parents[2]

# Typed step-child exit codes (pipeline/steps.py maps the two structured
# shutdown classes onto these; everything else is a plain failure). 75 =
# EX_TEMPFAIL: a SIGTERM-preempted step checkpointed at its chunk boundary
# and will resume bitwise (resilience/preempt.py) — retrying in place
# would undo the preemption, so the supervisor surfaces it typed instead.
# 78 = a guardian divergence halt (train/guardian.py DivergenceHaltError):
# deterministic, so a retry would replay the same sweep into the same
# halt; the supervisor must not burn attempts on it.
STEP_EXIT_PREEMPTED = 75
STEP_EXIT_HALTED = 78

# set to "0" to skip the resume preflight audit (fsck) — the escape hatch
# for trees too large to re-digest on every restart
PREFLIGHT_ENV = "SPARSE_CODING_FSCK_PREFLIGHT"


def load_or_create_run_id(run_dir: str | Path) -> str:
    """The run's correlation ID: minted once per run dir and persisted to
    ``<run_dir>/obs/run_id``, so a restarted supervisor — crash-only:
    restart IS the normal path — joins the same run instead of forking a
    new identity. Every event, journal record and child-step env carries
    it."""
    import binascii

    run_dir = Path(run_dir)
    marker = run_dir / "obs" / "run_id"
    try:
        existing = marker.read_text().strip()
        if existing:
            return existing
    except OSError:
        pass
    from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

    rid = f"{run_dir.name}-{binascii.hexlify(os.urandom(4)).decode()}"
    marker.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(marker, rid + "\n")
    return rid


class PipelineError(ResilienceError):
    """Base for typed supervisor failures."""


class StepFailed(PipelineError):
    """A step exhausted its attempt budget (crash, kill, or nonzero exit).
    The run journal holds the per-attempt record; re-running the
    supervisor resumes from the durable prefix."""

    def __init__(self, step: str, attempts: int, reason: str):
        super().__init__(f"step {step!r} failed after {attempts} "
                         f"attempt(s): {reason}")
        self.step = step
        self.attempts = attempts
        self.reason = reason


class StepHung(PipelineError):
    """The watchdog declared a step hung and the diagnosis said halting is
    the only safe move (the card answers a fresh process, so the step
    itself is stuck and a respawn would replay the hang)."""

    def __init__(self, step: str, diagnosis: dict):
        super().__init__(f"step {step!r} hung; {format_diagnosis(diagnosis)}")
        self.step = step
        self.diagnosis = diagnosis


class StepPreempted(PipelineError):
    """A step child exited with ``STEP_EXIT_PREEMPTED``: a SIGTERM landed
    and it checkpointed at its chunk boundary (resilience/preempt.py).
    The run is resumable, not failed; the supervisor surfaces it typed so
    the operator (or a scheduler) decides."""

    def __init__(self, step: str):
        super().__init__(f"step {step!r} preempted (checkpointed at its "
                         "chunk boundary; re-run to resume)")
        self.step = step


class StepHalted(PipelineError):
    """A step child exited with ``STEP_EXIT_HALTED``: the training
    guardian raised its typed divergence halt. The halt is deterministic —
    the guardian ledger already records it, a respawn replays the same
    sweep into the same halt — so the supervisor raises immediately
    instead of burning its attempt budget."""

    def __init__(self, step: str):
        super().__init__(
            f"step {step!r} halted by the training guardian "
            "(DivergenceHaltError; the incident is in guardian.json)")
        self.step = step


class ConcurrentSupervisorError(PipelineError):
    """A live, heartbeating lease for a step this supervisor wants to run:
    another supervisor (or a still-running orphan) owns the run. Refusing
    is the safe default — two writers on one run dir is undefined."""


class PreflightAuditError(PipelineError):
    """The resume preflight audit (fsck) found durable state that
    contradicts itself — e.g. a completion artifact that exists but no
    longer verifies, chunk bytes not matching their recorded digests, or
    both checkpoint sets damaged. Resuming over it could silently
    diverge, so the supervisor halts typed, naming the rotted artifacts;
    the operator triages with ``python -m sparse_coding_tpu_torch.fsck
    <run_dir>`` (and ``--repair`` for the provably-safe subset)."""

    def __init__(self, run_dir, findings):
        named = "; ".join(f"{f.path} ({f.kind}: {f.detail})"
                          for f in findings[:4])
        more = f" (+{len(findings) - 4} more)" if len(findings) > 4 else ""
        super().__init__(
            f"preflight audit of {run_dir} found {len(findings)} fatal "
            f"finding(s): {named}{more} — refusing to resume; triage "
            f"with `python -m sparse_coding_tpu_torch.fsck {run_dir}`")
        self.run_dir = Path(run_dir)
        self.findings = list(findings)


@dataclass
class Step:
    """One journaled pipeline step.

    ``argv`` must be re-runnable from scratch at any instant (the crash-
    only contract); ``done()`` checks the completion artifact on disk —
    it, not the journal, is the truth a restarted supervisor trusts.
    After the watchdog decides degrade-to-CPU the same ``argv`` is
    respawned: the degraded environment moves it to the CPU."""

    name: str
    argv: list[str]
    done: Callable[[], bool]
    deps: tuple[str, ...] = ()
    env: dict = field(default_factory=dict)


def _toposort(steps: Sequence[Step]) -> list[Step]:
    by_name = {s.name: s for s in steps}
    if len(by_name) != len(steps):
        raise ValueError("duplicate step names")
    for s in steps:
        for d in s.deps:
            if d not in by_name:
                raise ValueError(f"step {s.name!r} depends on unknown "
                                 f"step {d!r}")
    order: list[Step] = []
    state: dict[str, int] = {}  # 0 visiting, 1 done

    def visit(s: Step):
        if state.get(s.name) == 1:
            return
        if state.get(s.name) == 0:
            raise ValueError(f"dependency cycle through {s.name!r}")
        state[s.name] = 0
        for d in s.deps:
            visit(by_name[d])
        state[s.name] = 1
        order.append(s)

    for s in steps:
        visit(s)
    return order


def stripped_cpu_env(env: dict) -> dict:
    """The CPU child environment (``cpu_only``, and a degraded respawn):
    every entry point gets ``device="cpu"`` (``SPARSE_CODING_DEVICE``) and
    the card is hidden, so the child can never touch a card diagnosed
    wedged."""
    env = dict(env)
    env[ENV_DEVICE] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


class Supervisor:
    """Run a step DAG with journaling, leases, kill-recovery and a hang
    watchdog. Construction is cheap and stateless on disk; ``run()`` may
    be called on a fresh instance over an old run dir — that IS the
    restart path."""

    def __init__(self, run_dir: str | Path, steps: Sequence[Step], *,
                 max_attempts: int = 2, heartbeat_stale_s: float = 120.0,
                 poll_s: float = 0.25, cpu_only: bool = False,
                 prober=None, clock=time.time,
                 preempt_flag: Optional[Callable[[], bool]] = None):
        self.run_dir = Path(run_dir)
        self.steps = _toposort(steps)
        self.max_attempts = int(max_attempts)
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        self.poll_s = float(poll_s)
        self.cpu_only = bool(cpu_only)
        # a fleet worker's cooperative preemption hook (pipeline/fleet.py,
        # resilience/preempt.py): checked between steps and between
        # attempts, so a SIGTERM that lands while NO child is running
        # still stops the run typed instead of spawning fresh work
        self._preempt_flag = preempt_flag
        # prober(env) -> probe report: the card as the hung child saw it
        self._prober = prober or watchdog_mod.probe_card
        self._clock = clock
        # the run's correlation identity: journal records carry it, child
        # steps inherit it (with the shared event dir) through the env, so
        # every process's events join up in obs.report
        self.run_id = load_or_create_run_id(self.run_dir)
        self.obs_dir = self.run_dir / "obs"
        # a PER-INSTANCE sink and registry (not the module-global ones,
        # which tests and a hosting process own: its counters are not this
        # run's): the sink is opened for the duration of run() and closed
        # in its finally, so idle/dead supervisors hold no fd
        self._sink: Optional[obs.EventSink] = None
        self._registry = obs.Registry()
        self.journal = RunJournal(self.run_dir / "journal.jsonl", clock=clock,
                                  run_id=self.run_id)
        (self.run_dir / "logs").mkdir(parents=True, exist_ok=True)
        (self.run_dir / "leases").mkdir(parents=True, exist_ok=True)

    def _record_span(self, name: str, dur_s: float, ok: bool = True,
                     error: str = "", **attrs) -> None:
        """The single home of the supervisor-side emit plumbing: every
        span goes to this instance's sink stamped with this run's ID —
        never to the module-global sink, which would lose both."""
        obs.record_span(name, dur_s, ok=ok, error=error, sink=self._sink,
                        registry=self._registry, run=self.run_id, **attrs)

    # -- paths ---------------------------------------------------------------

    def lease_path(self, step: Step) -> Path:
        return self.run_dir / "leases" / f"{step.name}.json"

    def _log_path(self, step: Step, attempt: int) -> Path:
        return self.run_dir / "logs" / f"{step.name}.{attempt}.log"

    # -- run -----------------------------------------------------------------

    def run(self) -> dict[str, str]:
        """Execute every step not already complete; returns
        ``{step: "done" | "skipped"}``. Raises typed errors on failure —
        after which calling ``run()`` again (same or new process) resumes."""
        # the sink opens first, so the preflight audit's span is recorded
        self._sink = obs.EventSink(
            self.obs_dir / f"supervisor-{os.getpid()}.jsonl")
        t_run = obs.monotime()
        summary: dict[str, str] = {}
        try:
            # BEFORE the first journal append: append normalizes an
            # unterminated tail by terminating it, which would commit a
            # torn (possibly still-parsing) line the audit should see raw
            self._preflight_audit()
            self.journal.append("run.start",
                                detail_steps=[s.name for s in self.steps])
            for step in self.steps:
                if step.done():
                    # artifact present: complete, whether or not a journal
                    # record survived (artifacts beat the journal)
                    if step.name not in self.journal.done_steps():
                        self.journal.append("step.done", step.name,
                                            note="artifact present at startup")
                    summary[step.name] = "skipped"
                    continue
                self._check_preempted(step.name)
                self._takeover_lease(step)
                self._run_step(step)
                summary[step.name] = "done"
        except BaseException as e:
            self._record_span("pipeline.run", obs.monotime() - t_run,
                              ok=False, error=type(e).__name__)
            raise
        else:
            self.journal.append("run.done")
            self._record_span("pipeline.run", obs.monotime() - t_run,
                              summary=dict(summary))
            self._append_perf_ledger()
            return summary
        finally:
            obs.flush_metrics(sink=self._sink, registry=self._registry)
            self._sink.close()
            self._sink = None

    def _preflight_audit(self) -> None:
        """Resume preflight: a run dir that already holds journal records
        is a RESUME over cold durable state, and the supervisor's own
        ``done()`` probes only check existence — so before admitting any
        work, fsck the run's whole durable footprint. Fatal findings (INCONSISTENT state a resume
        could silently diverge over) halt typed via
        :class:`PreflightAuditError` — never silently. Scan-only:
        repair stays an explicit operator action.
        ``SPARSE_CODING_FSCK_PREFLIGHT=0`` disables (perf escape hatch
        for trees too large to re-digest every restart)."""
        if os.environ.get(PREFLIGHT_ENV, "1") == "0":
            return
        jpath = self.run_dir / "journal.jsonl"
        try:
            if not jpath.exists() or jpath.stat().st_size == 0:
                return  # fresh run: nothing durable to audit yet
        except OSError:
            return
        from sparse_coding_tpu_torch.fsck.core import run_fsck

        t0 = obs.monotime()
        report = run_fsck(self.run_dir, repair=False)
        self.journal.append(
            "run.fsck", findings=len(report.findings),
            fatal=[f.path for f in report.fatal])
        self._record_span("pipeline.preflight_fsck",
                          obs.monotime() - t0,
                          ok=not report.fatal,
                          findings=len(report.findings))
        if report.fatal:
            raise PreflightAuditError(self.run_dir, report.fatal)

    def _append_perf_ledger(self) -> None:
        """One durable perf summary row per completed run: the run's MFU
        gauges, kernel-path mix and step walls distilled from its own
        merged report — the row obs.report --diff compares run over run.
        Bookkeeping: a failure here is counted, never fatal to the run
        that just succeeded."""
        from sparse_coding_tpu_torch.obs import ledger as ledger_mod
        from sparse_coding_tpu_torch.obs.report import build_report

        try:
            row = ledger_mod.run_summary_row(build_report(self.run_dir),
                                             run_id=self.run_id)
            row["run_dir"] = str(self.run_dir)
            ledger_mod.append_row(
                row, ledger_mod.ledger_path(self.run_dir))
        except Exception:  # noqa: BLE001 — bookkeeping is never fatal
            self._registry.counter("obs.ledger.dropped").inc()

    # -- lease takeover ------------------------------------------------------

    def _takeover_lease(self, step: Step) -> None:
        path = self.lease_path(step)
        state = lease_state(path, self.heartbeat_stale_s, clock=self._clock)
        if state == "missing":
            return
        info = read_lease(path)
        if state == "live":
            raise ConcurrentSupervisorError(
                f"step {step.name!r} has a live heartbeating lease "
                f"(pid {info.pid}); refusing to double-run the pipeline")
        if state == "stale":
            # owner alive but not progressing: a hung orphan from a dead
            # supervisor. SIGKILL it (crash-only: it is resumable) so two
            # processes never write one step's artifacts.
            self.journal.append("lease.stale_kill", step.name, pid=info.pid,
                                beat_age_s=round(self._clock() - info.beat_at,
                                                 3))
            _kill_pid(info.pid)
        else:  # dead
            self.journal.append("lease.takeover", step.name, pid=info.pid)
        path.unlink(missing_ok=True)

    # -- one step ------------------------------------------------------------

    def _child_env(self, step: Step, degraded: bool) -> dict:
        env = dict(os.environ)
        for key, val in step.env.items():
            if val is None:  # None = delete the variable
                env.pop(key, None)
            else:
                env[key] = val
        env[lease_mod.ENV_PATH] = str(self.lease_path(step))
        # correlation: the child's spans/events/metrics land in the run's
        # shared obs dir, stamped with this run's ID and its step name —
        # obs.report joins them with the supervisor's own
        env[obs.ENV_RUN_ID] = self.run_id
        env[obs.ENV_OBS_DIR] = str(self.obs_dir)
        env[obs.ENV_STEP] = step.name
        # every child of this run (each respawn of a step too) shares one
        # capture-cache dir, so its warmup manifest covers the whole run.
        # setdefault: an operator- or step-level dir wins
        from sparse_coding_tpu_torch.xcache import ENV_DIR as XCACHE_ENV_DIR

        env.setdefault(XCACHE_ENV_DIR, str(self.run_dir / "xcache"))
        # every child of this run appends its summary rows to one durable
        # per-run perf ledger, which obs.report --diff reads across runs
        from sparse_coding_tpu_torch.obs.ledger import ENV_LEDGER, LEDGER_NAME

        env.setdefault(ENV_LEDGER, str(self.run_dir / LEDGER_NAME))
        if self.cpu_only or degraded:
            env = stripped_cpu_env(env)
        return env

    def _check_preempted(self, step_name: str) -> None:
        if self._preempt_flag is not None and self._preempt_flag():
            self.journal.append("step.preempted", step_name,
                                note="flag checked before spawn")
            raise StepPreempted(step_name)

    def _run_step(self, step: Step) -> None:
        degraded = False
        last_reason = "never spawned"
        for attempt in range(1, self.max_attempts + 1):
            if attempt > 1:
                self._check_preempted(step.name)
            log_path = self._log_path(step, attempt)
            env = self._child_env(step, degraded)
            spawn_argv = list(step.argv)
            self.journal.append("step.spawn", step.name, attempt=attempt,
                                argv=shlex.join(spawn_argv),
                                degraded=degraded)
            t_attempt = obs.monotime()
            with open(log_path, "ab") as log_fh:
                proc = subprocess.Popen(spawn_argv, cwd=str(REPO_ROOT),
                                        env=env, stdout=log_fh,
                                        stderr=subprocess.STDOUT)
            seed_lease(self.lease_path(step), proc.pid, step=step.name,
                       clock=self._clock, run=self.run_id)
            verdict = self._watch(step, proc, env)

            def _span(outcome: str, ok: bool) -> None:
                # one span per attempt: the supervisor-side wall clock of
                # the child, labeled with how the attempt ended
                self._record_span("pipeline.step",
                                  obs.monotime() - t_attempt, ok=ok,
                                  error="" if ok else outcome,
                                  step=step.name, attempt=attempt,
                                  outcome=outcome, degraded=degraded)

            if verdict is None:  # exited on its own
                rc = proc.returncode
                if rc == 0 and step.done():
                    self.journal.append("step.done", step.name,
                                        attempt=attempt)
                    self.lease_path(step).unlink(missing_ok=True)
                    _span("done", ok=True)
                    return
                if rc == 0:
                    last_reason = ("exit 0 but completion artifact missing "
                                   "(crash between artifact and marker?)")
                    self.journal.append("step.failed", step.name,
                                        attempt=attempt, rc=0,
                                        reason=last_reason)
                    _span("failed", ok=False)
                elif rc == STEP_EXIT_PREEMPTED:
                    # graceful SIGTERM shutdown: checkpointed, resumable —
                    # typed out instead of burning the attempt budget
                    self.journal.append("step.preempted", step.name,
                                        attempt=attempt)
                    self.lease_path(step).unlink(missing_ok=True)
                    _span("preempted", ok=False)
                    raise StepPreempted(step.name)
                elif rc == STEP_EXIT_HALTED:
                    # guardian divergence halt: deterministic, a respawn
                    # replays into the same halt — never retried
                    self.journal.append("step.halted", step.name,
                                        attempt=attempt, log=str(log_path))
                    self.lease_path(step).unlink(missing_ok=True)
                    _span("halted", ok=False)
                    raise StepHalted(step.name)
                elif rc < 0:
                    last_reason = f"killed by signal {-rc}"
                    self.journal.append("step.killed", step.name,
                                        attempt=attempt, signal=-rc,
                                        log=str(log_path))
                    _span("killed", ok=False)
                else:
                    last_reason = f"exit code {rc}"
                    self.journal.append("step.failed", step.name,
                                        attempt=attempt, rc=rc,
                                        log=str(log_path))
                    _span("failed", ok=False)
            else:  # watchdog declared it hung and killed it
                action = verdict["action"]
                last_reason = f"hung ({action})"
                _span("hung", ok=False)
                if action == HALT:
                    raise StepHung(step.name, verdict)
                if action == DEGRADE_CPU:
                    degraded = True
        raise StepFailed(step.name, self.max_attempts, last_reason)

    def _watch(self, step: Step, proc: subprocess.Popen,
               env: dict) -> Optional[dict]:
        """Poll child + lease. Returns None when the child exited by
        itself, or the hang diagnosis dict after killing a hung child.
        The lease the CHILD rewrites is the progress signal; the seed
        lease stamped at spawn opens the staleness window immediately, so
        a child wedged before its first beat (in torch's import, or in
        its first CUDA context) is caught too. The probe sees the card as
        the child's ``env`` did: a CPU child's hang is never the card's."""
        path = self.lease_path(step)
        while True:
            if proc.poll() is not None:
                return None
            # the supervisor's OWN heartbeat: when this supervisor is a
            # fleet per-run worker (pipeline/fleet.py), the scheduler
            # watches a worker lease exported through the env — babysitting
            # a live child IS progress; a no-op outside a fleet
            lease_mod.beat()
            state = lease_state(path, self.heartbeat_stale_s,
                                clock=self._clock)
            if state == "stale" or state == "missing":
                # the child is still alive here: the probe runs beside
                # it, in a process of its own, bounded by its timeout
                probe = self._prober(env)
                diag = {"probe": probe, "action": classify_hang(probe),
                        "runbook": watchdog_mod.RUNBOOK}
                self.journal.append("step.hung", step.name, **diag)
                _kill_pid(proc.pid)
                proc.wait()
                path.unlink(missing_ok=True)
                return diag
            time.sleep(self.poll_s)


def _kill_pid(pid: int) -> None:
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    except PermissionError:
        pass


# -- canonical pipelines -----------------------------------------------------

# what the builder not ported yet waits for
BENCH_ITEM = "ROADMAP.md queue 1, item 1 (the port has no bench entry yet)"


def step_argv(step_name: str, config_path: str | Path) -> list[str]:
    """Child command for a built-in step (pipeline/steps.py entry point)."""
    return [sys.executable, "-m", "sparse_coding_tpu_torch.pipeline.steps",
            step_name, "--config", str(config_path)]


def build_pipeline(run_dir: str | Path, config: dict,
                   only: Optional[Sequence[str]] = None) -> list[Step]:
    """The harvest → sweep → eval (→ catalog) DAG over a single config
    dict (see pipeline/steps.py for the per-step keys). The config is
    persisted into the run dir so a restarted supervisor — or an operator
    — can rebuild the exact same pipeline from disk.

    ``only`` prunes the DAG to a subset (deps on pruned steps are
    dropped): an operator re-running just the eval over finished sweep
    artifacts names the steps it wants."""
    cfg_path, anchor = _persist_pipeline_config(run_dir, config)
    dataset = anchor(config["harvest"]["dataset_folder"])
    steps = [
        Step("harvest", step_argv("harvest", cfg_path),
             done=lambda: (dataset / "meta.json").exists()),
    ] + _sweep_eval_steps(cfg_path, config, anchor, sweep_dep="harvest")
    return _prune(steps, only)


def _persist_pipeline_config(run_dir: str | Path, config: dict):
    """Shared builder preamble: persist the config into the run dir and
    return ``(cfg_path, anchor)``."""
    import json

    from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg_path = run_dir / "pipeline.json"
    atomic_write_text(cfg_path, json.dumps(config, indent=2))

    def anchor(p) -> Path:
        # children run with cwd=REPO_ROOT, so the supervisor-side done()
        # probes must resolve relative config paths against the same root
        # — not against wherever the operator launched the supervisor
        p = Path(p)
        return p if p.is_absolute() else REPO_ROOT / p

    return cfg_path, anchor


def _sweep_eval_steps(cfg_path: Path, config: dict, anchor,
                      sweep_dep: Optional[str]) -> list[Step]:
    """The sweep → eval (→ catalog) DAG tail, shared by the builders so
    the step argv, dependency shape and done() markers cannot drift
    between the flat, sharded and group data planes. ``sweep_dep=None``
    drops the harvest edge entirely — the group-tenant case: the pooled
    store the tenant trains on is durable before enqueue."""
    sweep_out = anchor(config["sweep"]["ensemble"]["output_folder"])
    eval_out = anchor(config["eval"]["output_folder"])
    name = config["sweep"].get("experiment", "dense_l1_range")
    steps = [
        Step("sweep", step_argv("sweep", cfg_path),
             deps=(sweep_dep,) if sweep_dep is not None else (),
             done=lambda: (sweep_out / "final"
                           / f"{name}_learned_dicts.pkl").exists()),
        Step("eval", step_argv("eval", cfg_path), deps=("sweep",),
             done=lambda: (eval_out / "eval.json").exists()),
    ]
    if "catalog" in config:
        # opt-in DAG tail: configs without a "catalog" section keep the
        # sweep → eval shape
        cat_out = anchor(config["catalog"]["output_folder"])
        steps.append(
            Step("catalog", step_argv("catalog", cfg_path), deps=("eval",),
                 done=lambda: (cat_out / "index.json").exists()))
    return steps


def _prune(steps: list[Step], only: Optional[Sequence[str]]) -> list[Step]:
    if only is None:
        return steps
    keep = set(only)
    unknown = keep - {s.name for s in steps}
    if unknown:
        raise ValueError(f"unknown pipeline steps in only=: {sorted(unknown)}")
    pruned = []
    for s in steps:
        if s.name in keep:
            s.deps = tuple(d for d in s.deps if d in keep)
            pruned.append(s)
    return pruned


def _manifest_matches(dataset: Path, n_shards: int) -> bool:
    from sparse_coding_tpu_torch.data.shard_store import read_store_manifest

    m = read_store_manifest(dataset)
    return m is not None and int(m.get("n_shards", -1)) == n_shards


def build_sharded_pipeline(run_dir: str | Path, config: dict,
                           only: Optional[Sequence[str]] = None) -> list[Step]:
    """The sharded data-plane DAG:

        harvest-<i> (one writer child per shard, no edges between them)
          → manifest (aggregate sealed shards)
          → scrub (digest re-verify + quarantine/repair)
          → sweep → eval (→ catalog)

    ``config["harvest"]["n_shards"]`` sets the writer count. Each writer
    is the flat harvest's crash-only contract scoped to its shard. The
    supervisor runs them one after another. ``done()`` for a writer is its
    shard's seal (digest after meta), for the manifest the store-level
    ``manifest.json`` at this shard count, for the scrub the run-scoped
    ``<run_dir>/scrub.done.json`` (a store-resident marker would make
    every later run over the same store skip its scrub)."""
    from sparse_coding_tpu_torch.data.shard_store import (
        SHARD_DIGEST_NAME,
        shard_name,
    )
    from sparse_coding_tpu_torch.pipeline.steps import SCRUB_MARKER_NAME

    cfg_path, anchor = _persist_pipeline_config(run_dir, config)
    dataset = anchor(config["harvest"]["dataset_folder"])
    scrub_done = Path(run_dir) / SCRUB_MARKER_NAME
    n_shards = int(config["harvest"]["n_shards"])

    def sealed(i: int) -> Callable[[], bool]:
        d = dataset / shard_name(i)
        return lambda: ((d / "meta.json").exists()
                        and (d / SHARD_DIGEST_NAME).exists())

    writers = [Step(f"harvest-{i}",
                    step_argv("shard_harvest", cfg_path)
                    + ["--shard", str(i)],
                    done=sealed(i))
               for i in range(n_shards)]
    steps = writers + [
        Step("manifest", step_argv("manifest", cfg_path),
             deps=tuple(w.name for w in writers),
             # a manifest from a run with another n_shards lists a stale
             # shard subset: the step rebuilds it
             done=lambda: _manifest_matches(dataset, n_shards)),
        Step("scrub", step_argv("scrub", cfg_path), deps=("manifest",),
             done=scrub_done.exists),
    ] + _sweep_eval_steps(cfg_path, config, anchor, sweep_dep="scrub")
    return _prune(steps, only)


def build_group_pipeline(run_dir: str | Path, config: dict,
                         only: Optional[Sequence[str]] = None) -> list[Step]:
    """The Group-SAE data-plane DAG:

        harvest-<i> (one multi-tap writer child per layer — taps are
                     shards, no edges between the writers)
          → manifest (aggregate sealed shards)
          → scrub (digest re-verify + quarantine/repair)
          → group (similarity + greedy assignment → ``groups.json``, host
                   numpy only; done() = the digest-sound marker)
          [→ sweep → eval (→ catalog) — opt-in: a config with a "sweep"
             section trains one pooled-store sweep inline; the usual
             shape instead enqueues one fleet tenant per group after the
             ``group`` step finalizes (groups/tenants.py)]

    ``config["harvest"]["layers"]`` sets the writer count: writer ``i``
    harvests layer ``layers[i]`` into ``shard-<i>/``, replaying the same
    producer stream as every other writer so rows stay aligned across
    layers (the similarity pass's contract). Everything below the
    writers reuses the sharded plane: the same manifest and scrub steps,
    the same done() markers."""
    from sparse_coding_tpu_torch.data.shard_store import (
        SHARD_DIGEST_NAME,
        shard_name,
    )
    from sparse_coding_tpu_torch.groups.assign import GROUPS_NAME
    from sparse_coding_tpu_torch.pipeline.steps import (
        SCRUB_MARKER_NAME,
        _resolve_layers,
    )

    cfg_path, anchor = _persist_pipeline_config(run_dir, config)
    dataset = anchor(config["harvest"]["dataset_folder"])
    scrub_done = Path(run_dir) / SCRUB_MARKER_NAME
    n_layers = len(_resolve_layers(config["harvest"]))

    def sealed(i: int) -> Callable[[], bool]:
        d = dataset / shard_name(i)
        return lambda: ((d / "meta.json").exists()
                        and (d / SHARD_DIGEST_NAME).exists())

    writers = [Step(f"harvest-{i}",
                    step_argv("group_harvest", cfg_path)
                    + ["--shard", str(i)],
                    done=sealed(i))
               for i in range(n_layers)]
    steps = writers + [
        Step("manifest", step_argv("manifest", cfg_path),
             deps=tuple(w.name for w in writers),
             done=lambda: _manifest_matches(dataset, n_layers)),
        Step("scrub", step_argv("scrub", cfg_path), deps=("manifest",),
             done=scrub_done.exists),
        Step("group", step_argv("group", cfg_path), deps=("scrub",),
             done=lambda: (dataset / GROUPS_NAME).exists()),
    ]
    if "sweep" in config:
        steps += _sweep_eval_steps(cfg_path, config, anchor,
                                   sweep_dep="group")
    return _prune(steps, only)


def build_group_tenant_pipeline(run_dir: str | Path, config: dict,
                                only: Optional[Sequence[str]] = None,
                                ) -> list[Step]:
    """One group tenant's DAG (fleet ``kind="group"``): just the sweep →
    eval (→ catalog) tail over the group's pooled store view — no harvest
    edge, because ``groups.json`` (and every pooled manifest under it)
    was durable before the tenant could be enqueued (groups/tenants.py
    reads the finalized assignment). Guardian halts stay contained to
    this tenant's run dir exactly as for flat tenants."""
    cfg_path, anchor = _persist_pipeline_config(run_dir, config)
    return _prune(_sweep_eval_steps(cfg_path, config, anchor,
                                    sweep_dep=None), only)


def supervise_bench(run_dir: str | Path, *, max_attempts: int = 2,
                    heartbeat_stale_s: Optional[float] = None) -> Path:
    """bench.py's supervised mode: waits for the port's bench entry."""
    raise NotImplementedError(f"supervise_bench is not ported yet "
                              f"({BENCH_ITEM})")
