"""The port's fleet scheduler (sparse_coding_tpu_torch/pipeline/fleet.py,
fleet_queue.py, placement.py) against the JAX package's, on the CPU.

- ``plan_placement`` gives the JAX plan on seeded random run sets: the
  priority order with FIFO ties, no backfill behind a blocked head,
  scavenger preemption (most recently placed first, never futile, never
  twice) and the concurrency cap;
- ``validate_spec`` normalizes and refuses the same specs;
- ``FleetQueue``: the same appends give the same bytes, and
  ``replay`` folds the same files to the same state, torn tail included;
- real worker subprocesses (cheap ``kind="command"`` runs): two tenants
  side by side; a crashed worker requeued, then out of attempts; a
  second scheduler refused while the first heartbeats, and a dead one's
  successor taking over without running any work twice; a scheduler
  SIGKILLed at the ``fleet.place`` barrier, restarted: no run lost, none
  placed twice. The last three run the JAX package's scheduler on the
  same tenants in a sibling dir too: the two queue journals agree event
  for event (event, run, outcome, attempt, exit code).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sparse_coding_tpu.pipeline import fleet as jfleet
from sparse_coding_tpu.pipeline import fleet_queue as jqueue
from sparse_coding_tpu.pipeline import placement as jplace
from sparse_coding_tpu.pipeline import supervisor as jsup
from sparse_coding_tpu.resilience import lease as jlease
from sparse_coding_tpu_torch.pipeline import fleet as tfleet
from sparse_coding_tpu_torch.pipeline import fleet_queue as tqueue
from sparse_coding_tpu_torch.pipeline import placement as tplace
from sparse_coding_tpu_torch.pipeline import supervisor as tsup
from sparse_coding_tpu_torch.resilience import crash as tcrash
from sparse_coding_tpu_torch.resilience import lease as tlease

REPO = Path(__file__).resolve().parents[1]
POLL_S, WALL_S = 0.05, 120.0
DEAD_PID = 2 ** 22 + 4242
PRIORITIES = ("interactive", "batch", "scavenger")
STATES = ("queued", "placed", "preempting", "done", "halted", "failed")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for var in (tcrash.ENV_VAR, "SPARSE_CODING_FAULT_PLAN", tlease.ENV_PATH,
                "SPARSE_CODING_XCACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    tlease.configure(None)
    jlease.configure(None)


# -- placement (pure) ---------------------------------------------------------


def _run_sets(seed: int):
    """Random run sets, the same for both packages' RunState classes."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 9))
        rows = [dict(name=f"r{i}",
                     priority=PRIORITIES[int(rng.integers(3))],
                     slices=int(rng.integers(1, 4)),
                     state=STATES[int(rng.choice(6, p=[.45, .25, .1,
                                                       .1, .05, .05]))],
                     seq=int(rng.integers(0, 5)) * 10 + i,
                     placed_seq=int(rng.integers(0, 50)))
                for i in range(n)]
        yield rows, int(rng.integers(1, 7)), int(rng.integers(0, 4))


@pytest.mark.parametrize("seed", range(6))
def test_plan_placement_matches_jax(seed):
    plans = set()
    for rows, n_slices, cap in _run_sets(seed):
        got = tplace.plan_placement([tplace.RunState(**r) for r in rows],
                                    n_slices, cap)
        want = jplace.plan_placement([jplace.RunState(**r) for r in rows],
                                     n_slices, cap)
        assert (got.place, got.preempt, got.blocked) == (
            want.place, want.preempt, want.blocked), (rows, n_slices, cap)
        plans.add((bool(got.place), bool(got.preempt), bool(got.blocked)))
    assert len(plans) >= 4  # the sets reach placing, preempting, blocking


def test_plan_placement_rules():
    """The rules the random sets mix, one each: FIFO inside a class, no
    backfill behind a blocked head, newest scavenger preempted first and
    never twice, and the cap preempting a scavenger for a slot."""
    rs = lambda n, p, st="queued", sl=1, seq=0, ps=0: tplace.RunState(
        name=n, priority=p, slices=sl, state=st, seq=seq, placed_seq=ps)
    plan = tplace.plan_placement([rs("b2", "batch", seq=2),
                                  rs("i", "interactive", seq=3),
                                  rs("b1", "batch", seq=1)], 2)
    assert plan.place == ("i", "b1") and plan.blocked == ("b2",)
    plan = tplace.plan_placement([rs("big", "batch", sl=2, seq=1),
                                  rs("small", "scavenger", seq=2),
                                  rs("x", "batch", "placed", ps=1)], 2)
    assert plan.place == () and plan.blocked == ("big", "small")
    plan = tplace.plan_placement([
        rs("s1", "scavenger", "placed", ps=1),
        rs("s2", "scavenger", "placed", ps=5),
        rs("s3", "scavenger", "preempting", ps=9),
        rs("hi", "interactive", seq=7)], 3)
    assert plan.preempt == ("s2",) and plan.blocked == ("hi",)
    plan = tplace.plan_placement([rs("s", "scavenger", "placed", ps=1),
                                  rs("b", "batch", seq=2)], 4,
                                 max_concurrent=1)
    assert plan.preempt == ("s",)


# -- the queue ----------------------------------------------------------------


def test_validate_spec_matches_jax():
    good = {"priority": "scavenger", "slices": 2, "kind": "group",
            "config": {"a": 1}}
    assert tqueue.validate_spec("g-1", good, 2) == \
        jqueue.validate_spec("g-1", good, 2)
    for name, spec in (("bad name", {"config": {}}),
                       ("x", {"priority": "urgent", "config": {}}),
                       ("x", {"slices": 3, "config": {}}),
                       ("x", {"kind": "pod", "config": {}}),
                       ("x", {"kind": "command"}),
                       ("x", {"kind": "flat"})):
        with pytest.raises(ValueError) as t:
            tqueue.validate_spec(name, spec, 2)
        with pytest.raises(ValueError) as j:
            jqueue.validate_spec(name, spec, 2)
        assert str(t.value) == str(j.value)


def _fold(state) -> tuple:
    return ({n: (r.name, r.priority, r.slices, r.state, r.seq,
                 r.placed_seq, r.attempts, r.requeues)
             for n, r in state.runs.items()}, state.specs,
            state.skipped_lines, state.summary(), state.terminal())


def test_queue_bytes_and_replay_match_jax(tmp_path):
    """The same appends give byte-equal queue files (one clock), and both
    replays fold them — and a torn tail — to the same state."""
    paths = {}
    for side, mod in (("jax", jqueue), ("port", tqueue)):
        t = iter(range(100))
        q = mod.FleetQueue(tmp_path / side / "fleet_queue.jsonl",
                           clock=lambda: float(next(t)))
        assert q.enqueue("a", {"config": {"x": 1}}, 2)
        assert q.enqueue("b", {"priority": "scavenger", "kind": "command",
                               "argv": ["true"], "done_path": "d"}, 2)
        assert not q.enqueue("a", {"config": {"x": 2}}, 2)  # idempotent
        q.append("scheduler.start", n_slices=2)
        q.append("run.place", "a", attempt=1)
        q.append("run.place", "b", attempt=1)
        q.append("run.preempt", "b")
        q.append("run.release", "b", outcome="preempted")
        q.append("run.release", "a", outcome="requeued", rc=1)
        q.append("run.place", "a", attempt=2)
        q.append("plane.rebalance", serve_slices=1, fleet_slices=1)
        paths[side] = q.path
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    want = _fold(jqueue.FleetQueue(paths["jax"]).replay())
    assert _fold(tqueue.FleetQueue(paths["port"]).replay()) == want
    assert want[0]["a"][3:] == ("placed", 1, 9, 2, 1)
    for p in paths.values():  # a torn tail that still parses as JSON
        p.write_bytes(p.read_bytes()
                      + b'{"seq": 1, "event": "run.release", "step": "a"}')
    got = _fold(tqueue.FleetQueue(paths["port"]).replay())
    assert got == _fold(jqueue.FleetQueue(paths["jax"]).replay())
    assert got[2] == 1 and got[0]["a"][3] == "placed"


# -- real workers -------------------------------------------------------------


def _sched(root: Path, fleet=tfleet, **kw):
    kw.setdefault("poll_s", POLL_S)
    kw.setdefault("max_wall_s", WALL_S)
    return fleet.FleetScheduler(root / "fleet", **kw)


def _touch_run(sched, name, out: Path, log: Path = None, **kw):
    body = (f"open({str(log)!r}, 'a').write('ran\\n'); " if log else "") \
        + f"open({str(out)!r}, 'w').write('done-{name}')"
    return sched.enqueue(name, kind="command",
                         argv=[sys.executable, "-c", body], done_path=out,
                         **kw)


def _releases(sched) -> list:
    return [(r["step"], r["detail"]["outcome"])
            for r in sched.queue.journal.records()
            if r["event"] == "run.release"]


def _journal(sched) -> list:
    """The queue journal event for event: clocks, pids, paths and specs
    dropped."""
    return [(r["event"], r["step"]) + tuple(
        r["detail"].get(k) for k in ("outcome", "attempt", "rc"))
        for r in sched.queue.journal.records()]


def _on_both(tmp_path, case) -> dict:
    """``case(root, fleet, lease, supervisor)`` on the port and on the JAX
    package in sibling dirs; the port's result is checked by the caller,
    and its queue journal must be the JAX scheduler's event for event."""
    out = {}
    for side, mods in (("port", (tfleet, tlease, tsup)),
                       ("jax", (jfleet, jlease, jsup))):
        (tmp_path / side).mkdir()
        out[side] = case(tmp_path / side, *mods)
    assert _journal(out["port"]) == _journal(out["jax"])
    return out


def test_two_tenants_through_real_workers(tmp_path):
    sched = _sched(tmp_path, n_slices=2, max_concurrent=2)
    outs = {n: tmp_path / f"{n}.out" for n in ("a", "b")}
    for n, out in outs.items():
        _touch_run(sched, n, out)
    assert sched.run() == {"a": "done", "b": "done"}
    assert {n: o.read_text() for n, o in outs.items()} == {
        "a": "done-a", "b": "done-b"}
    for n in outs:
        assert not tfleet.worker_lease_path(sched.fleet_dir, n).exists()
        run = tfleet.run_dir_for(sched.fleet_dir, n)
        assert json.loads((run / "journal.jsonl").read_text().splitlines()
                          [-1])["event"] == "run.done"
    counters = sched.registry.snapshot()["counters"]
    assert counters["fleet.placements"] == 2
    assert sorted(_releases(sched)) == [("a", "done"), ("b", "done")]
    events = [json.loads(line) for f in (sched.fleet_dir / "obs").glob(
        "fleet-*.jsonl") for line in f.read_text().splitlines()]
    assert any(e.get("span") == "fleet.run" for e in events)
    assert not sched.lease_path.exists()  # released on the way out


def test_crashed_worker_requeued_then_out_of_attempts(tmp_path):
    def case(root, fleet, lease, sup):
        sched = _sched(root, fleet, n_slices=1, max_run_attempts=2)
        sched.enqueue("doomed", kind="command",
                      argv=[sys.executable, "-c", "raise SystemExit(9)"],
                      done_path=root / "never.out", max_attempts=1)
        assert sched.run() == {"doomed": "failed"}
        return sched

    sched = _on_both(tmp_path, case)["port"]
    assert _releases(sched) == [("doomed", "requeued"),
                                ("doomed", "failed")]
    st = sched.queue.replay().runs["doomed"]
    assert (st.attempts, st.requeues) == (2, 1)
    assert "StepFailed" in (sched.fleet_dir / "logs"
                            / "doomed.1.log").read_text()


def test_second_scheduler_refused_and_dead_one_taken_over(tmp_path):
    def case(root, fleet, lease, sup):
        sched = _sched(root, fleet, n_slices=1)
        out, log = root / "a.out", root / "a.log"
        _touch_run(sched, "a", out, log)
        lease.seed_lease(sched.lease_path, pid=os.getpid(), step="fleet")
        with pytest.raises(sup.ConcurrentSupervisorError,
                           match="live heartbeating"):
            _sched(root, fleet, n_slices=1).run()
        assert not out.exists()  # refused before placing anything
        # the dead scheduler's debris: its lease and an orphan placement
        sched.queue.append("run.place", "a", attempt=1)
        lease.seed_lease(fleet.worker_lease_path(sched.fleet_dir, "a"),
                         pid=DEAD_PID, step="run-a")
        lease.seed_lease(sched.lease_path, pid=DEAD_PID, step="fleet")
        fresh = _sched(root, fleet, n_slices=1)
        assert fresh.run() == {"a": "done"}
        assert log.read_text() == "ran\n"  # the work ran once
        return fresh

    fresh = _on_both(tmp_path, case)["port"]
    events = [r["event"] for r in fresh.queue.journal.records()]
    assert "scheduler.takeover" in events
    assert _releases(fresh) == [("a", "reclaimed"), ("a", "done")]


def test_kill_at_place_then_restart_loses_nothing(tmp_path):
    """A scheduler SIGKILLed at ``fleet.place`` (the run.place record
    durable, no worker spawned); a fresh scheduler reclaims the orphan
    placement and runs it: each run's work ran exactly once, and no run
    was ever placed twice without a release between."""
    def case(root, fleet, lease, sup):
        sched = _sched(root, fleet, n_slices=1)
        logs = {}
        for n in ("a", "b"):
            logs[n] = root / f"{n}.log"
            _touch_run(sched, n, root / f"{n}.out", logs[n])
        code = (f"import sys; from {fleet.__name__} "
                "import FleetScheduler; FleetScheduler(sys.argv[1], "
                "poll_s=0.05, max_wall_s=60).run()")
        out = subprocess.run(
            [sys.executable, "-c", code, str(sched.fleet_dir)], cwd=REPO,
            env={**os.environ, tcrash.ENV_VAR: "fleet.place:nth=1",
                 "PYTHONPATH": str(REPO)}, capture_output=True,
            timeout=120)
        assert out.returncode == -9, out.stderr[-2000:]
        st = sched.queue.replay()
        assert st.summary() == {"a": "placed", "b": "queued"}
        assert not logs["a"].exists()
        fresh = _sched(root, fleet, n_slices=1)
        assert fresh.run() == {"a": "done", "b": "done"}
        assert {n: p.read_text() for n, p in logs.items()} == {
            "a": "ran\n", "b": "ran\n"}
        return fresh

    fresh = _on_both(tmp_path, case)["port"]
    records = fresh.queue.journal.records()
    for n in ("a", "b"):
        seq = [r["event"] for r in records if r.get("step") == n
               and r["event"] in ("run.place", "run.release")]
        assert all(pair != ("run.place", "run.place")
                   for pair in zip(seq, seq[1:])), seq
    assert _releases(fresh)[0] == ("a", "reclaimed")
