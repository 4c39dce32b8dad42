"""The port's crash-only pipeline (sparse_coding_tpu_torch/pipeline/,
resilience/lease.py and watchdog.py) against the JAX package's, on the
CPU.

- The journal: byte-equal files for the same appends, clock and run id;
  the same records from the same torn files.
- Leases: the same file format, so each side reads the other's, with the
  same ``lease_state``.
- ``classify_hang``: the same verdict on every probe dict; the card probe
  with injected devices and probe children.
- The supervisor: the port's and the JAX package's ``Supervisor`` over
  the same cheap ``python -c`` step DAGs give the same summaries, the
  same typed errors and the same journal event sequences (done and
  resume, bad DAGs, typed failure and exit codes, dead/live/stale owners,
  the three hang verdicts with injected probes).
- The builders: the same names, deps and ``done()`` answers.
- The steps: ``eval`` over a JAX-written store and dicts within rtol 1e-5
  (fvu, l0: float32 sums over 96 rows in another order); ``sweep`` with
  the JAX experiment's inits carried across within the full sweep's rtol
  2e-4 (tests/test_torch_port_full_sweep.py).
- The whole slice (``cpu_only=True``): a tiny supervised run SIGKILLed at
  ``sweep.chunk`` and resumed by a fresh supervisor is bitwise the same
  steps run uninterrupted, and every step span says it ran on the CPU.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding_tpu.pipeline import journal as jjournal
from sparse_coding_tpu.pipeline import steps as jsteps
from sparse_coding_tpu.pipeline import supervisor as jsup
from sparse_coding_tpu.resilience import lease as jlease
from sparse_coding_tpu.resilience import watchdog as jwatch
from sparse_coding_tpu_torch.pipeline import journal as tjournal
from sparse_coding_tpu_torch.pipeline import steps as tsteps
from sparse_coding_tpu_torch.pipeline import supervisor as tsup
from sparse_coding_tpu_torch.resilience import crash as tcrash
from sparse_coding_tpu_torch.resilience import lease as tlease
from sparse_coding_tpu_torch.resilience import watchdog as twatch

REPO = Path(__file__).resolve().parents[1]
DEAD_PID = 4999999  # beyond kernel.pid_max defaults: never a live process
EVAL_RTOL = 1e-5
DICT_TOL = dict(rtol=2e-4, atol=1e-6)

SIDES = {"jax": (jsup, jlease), "port": (tsup, tlease)}


@pytest.fixture(autouse=True)
def _no_env_plans(monkeypatch):
    for var in (tcrash.ENV_VAR, "SPARSE_CODING_FAULT_PLAN",
                tlease.ENV_PATH, tsteps.ENV_DEVICE,
                "SPARSE_CODING_FSCK_PREFLIGHT"):
        monkeypatch.delenv(var, raising=False)
    yield
    tlease.configure(None)
    jlease.configure(None)


# -- journal ------------------------------------------------------------------


def test_journal_files_are_byte_equal(tmp_path):
    """The same appends with one clock and run id give the same bytes,
    seq numbering and done set, and a torn tail reads the same."""
    paths = {}
    for side, mod in (("jax", jjournal), ("port", tjournal)):
        t = iter(range(100))
        j = mod.RunJournal(tmp_path / side / "journal.jsonl",
                           clock=lambda: float(next(t)), run_id="run-x")
        j.append("run.start", detail_steps=["a", "b"])
        j.append("step.spawn", "a", attempt=1, argv="x y", degraded=False)
        j.append("step.done", "a", attempt=1)
        j.append("step.hung", "b", probe={"configured": True}, action="halt")
        paths[side] = j.path
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    for raw in (b'{"seq": 9, "event": "step.done", "step": "b"',  # parses
                b'{"trunc'):
        for p in paths.values():
            p.write_bytes(p.read_bytes().split(b"\n{\"seq\": 9")[0]
                          .rstrip(b"\n") + b"\n" + raw)
        jj = jjournal.RunJournal(paths["jax"])
        tj = tjournal.RunJournal(paths["port"])
        assert tj.records() == jj.records()
        assert tj.scan_records() == jj.scan_records()
        assert tj.done_steps() == jj.done_steps()
        assert tj.last_event("b") == jj.last_event("b")


# -- leases -------------------------------------------------------------------


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_leases_cross_read(tmp_path, writer, reader):
    """A lease either side writes, the other reads with the same fields
    and the same state: live, stale after the window, dead, missing."""
    wl, rl = SIDES[writer][1], SIDES[reader][1]
    now = {"t": 1000.0}
    clock = lambda: now["t"]
    lease = wl.Lease(tmp_path / "l.json", step="sweep", clock=clock)
    got, want = rl.read_lease(lease.path), wl.read_lease(lease.path)
    assert (got.pid, got.host, got.step, got.beat_at, got.seq) == (
        want.pid, want.host, want.step, want.beat_at, want.seq)
    for dt, state in ((0.0, "live"), (60.0, "stale")):
        now["t"] += dt
        assert rl.lease_state(lease.path, 10.0, clock=clock) == state
        assert wl.lease_state(lease.path, 10.0, clock=clock) == state
    wl.seed_lease(tmp_path / "dead.json", pid=DEAD_PID, step="x")
    assert rl.lease_state(tmp_path / "dead.json", 10.0) == "dead"
    (tmp_path / "junk.json").write_text("{not json")
    assert rl.read_lease(tmp_path / "junk.json") is None
    assert rl.lease_state(tmp_path / "none.json", 10.0) == "missing"


def test_lease_beat_throttles_and_configures_from_env(tmp_path, monkeypatch):
    now = {"t": 5.0}
    lease = tlease.Lease(tmp_path / "b.json", interval_s=1.0,
                         clock=lambda: now["t"])
    lease.beat()
    assert tlease.read_lease(lease.path).seq == 1
    now["t"] += 1.5
    lease.beat()
    assert tlease.read_lease(lease.path).seq == 2
    monkeypatch.setenv(tlease.ENV_PATH, str(tmp_path / "env.json"))
    tlease.configure_from_env(step="host")
    assert tlease.read_lease(tmp_path / "env.json").step == "host"


# -- hang diagnosis -----------------------------------------------------------


PROBES = [{"configured": c, "reachable": r} for c in (False, True)
          for r in (False, True)] + [{}, {"configured": True}]


@pytest.mark.parametrize("probe", PROBES, ids=str)
def test_classify_hang_matches_jax(probe):
    assert twatch.classify_hang(probe) == jwatch.classify_hang(probe)
    assert (twatch.RETRY, twatch.DEGRADE_CPU, twatch.HALT) == (
        jwatch.RETRY, jwatch.DEGRADE_CPU, jwatch.HALT)


def test_card_probe_verdicts_with_injected_children(tmp_path):
    """The probe's three outcomes, the child never spawned without a
    visible device, the device nodes read from a directory, and a hidden
    card (CUDA_VISIBLE_DEVICES="") counts as no card."""
    spawned = []

    def runner(ok, detail):
        return lambda env, t: spawned.append(t) or (ok, detail)

    none = twatch.probe_card(env={}, devices=lambda env: [],
                             runner=runner(True, "x"))
    assert not none["configured"] and not spawned
    assert twatch.classify_hang(none) == twatch.RETRY
    down = twatch.probe_card(env={}, timeout_s=3.0,
                             devices=lambda env: ["nvidia0"],
                             runner=runner(False, "timed out"))
    assert twatch.classify_hang(down) == twatch.DEGRADE_CPU
    up = twatch.probe_card(env={}, devices=lambda env: ["nvidia0"],
                           runner=runner(True, "ok"))
    assert twatch.classify_hang(up) == twatch.HALT and spawned == [3.0, 30.0]
    assert "card nvidia0 reachable" in twatch.format_diagnosis(
        {"probe": up, "action": twatch.HALT})
    for name in ("nvidia1", "nvidia0", "nvidiactl", "nvidia-uvm", "null"):
        (tmp_path / name).write_text("")
    assert twatch.visible_devices({}, dev_dir=tmp_path) == ["nvidia0",
                                                            "nvidia1"]
    assert twatch.visible_devices({"CUDA_VISIBLE_DEVICES": ""},
                                  dev_dir=tmp_path) == []


def test_probe_child_times_out_and_is_killed():
    """A probe child that cannot answer in time is killed and reported
    unreachable; the supervisor is never blocked past the timeout."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.monotonic()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twatch, "_PROBE_CHILD", "import time; time.sleep(30)")
        ok, detail = twatch._run_probe_child(env, 0.5)
    assert not ok and "did not finish" in detail
    assert time.monotonic() - t0 < 10


# -- the supervisor against the JAX package's ---------------------------------


def _write_argv(out: Path, text: str = "done") -> list[str]:
    return [sys.executable, "-c",
            f"open({str(out)!r}, 'w').write({text!r})"]


def _hang_argv() -> list[str]:
    return [sys.executable, "-c", "import time; time.sleep(60)"]


def _events(sup) -> list[tuple]:
    """The journal as (event, step, attempt, degraded, action, rc,
    signal) — everything but times, pids, argv and the probe's fields."""
    out = []
    for r in sup.journal.records():
        d = r.get("detail", {})
        out.append((r["event"], r["step"], d.get("attempt"),
                    d.get("degraded"), d.get("action"), d.get("rc"),
                    d.get("signal")))
    return out


def _run_both(tmp_path, build, **kw):
    """Run the JAX and the port supervisor over the same DAG (``build``
    maps (side module, folder) to steps and an optional pre-run hook);
    returns {side: (summary or exception, supervisor, folder)}."""
    out = {}
    for side, (sup_mod, lease_mod) in SIDES.items():
        folder = tmp_path / side
        folder.mkdir()
        steps, before = build(sup_mod, lease_mod, folder)
        prober = kw.get("probe")
        probers = ({"jax": lambda: prober, "port": lambda env: prober}
                   if prober is not None else {})
        sup = sup_mod.Supervisor(
            folder / "run", steps,
            **{k: v for k, v in kw.items() if k != "probe"},
            **({"prober": probers[side]} if probers else {}))
        if before:
            before(sup, steps)
        try:
            result = sup.run()
        except Exception as e:  # noqa: BLE001 — compared across sides
            result = e
        out[side] = (result, sup, folder)
    return out


def _assert_same(out, summary=None, error=None):
    (jres, jsup_, _), (tres, tsup_, _) = out["jax"], out["port"]
    if error is None:
        assert tres == jres == summary
    else:
        assert type(jres).__name__ == type(tres).__name__ == error, (jres,
                                                                     tres)
    assert _events(tsup_) == _events(jsup_)


def _dag(sup_mod, folder):
    a, b = folder / "a.out", folder / "b.out"
    return [sup_mod.Step("b", [sys.executable, "-c",
                               f"import shutil; shutil.copy({str(a)!r}, "
                               f"{str(b)!r})"], done=b.exists, deps=("a",)),
            sup_mod.Step("a", _write_argv(a), done=a.exists)]


CASES = {
    "done_then_resume": dict(
        build=lambda sm, lm, f: (_dag(sm, f), None),
        summary={"a": "done", "b": "done"}, rerun={"a": "skipped",
                                                   "b": "skipped"}),
    "typed_failure": dict(
        build=lambda sm, lm, f: ([sm.Step("bad", [sys.executable, "-c",
                                                  "raise SystemExit(7)"],
                                          done=lambda: False)], None),
        error="StepFailed"),
    "preempted": dict(
        build=lambda sm, lm, f: ([sm.Step("s", [sys.executable, "-c",
                                                "raise SystemExit(75)"],
                                          done=lambda: False)], None),
        error="StepPreempted"),
    "halted": dict(
        build=lambda sm, lm, f: ([sm.Step("s", [sys.executable, "-c",
                                                "raise SystemExit(78)"],
                                          done=lambda: False)], None),
        error="StepHalted"),
    "killed_then_failed": dict(
        build=lambda sm, lm, f: ([sm.Step("k", [sys.executable, "-c",
                                                "import os, signal; os.kill("
                                                "os.getpid(), signal.SIGKILL)"],
                                          done=lambda: False)], None),
        error="StepFailed"),
    "exit0_no_artifact": dict(
        build=lambda sm, lm, f: ([sm.Step("z", [sys.executable, "-c", ""],
                                          done=lambda: False)], None),
        error="StepFailed"),
    "dead_owner_taken_over": dict(
        build=lambda sm, lm, f: (
            [sm.Step("w", _write_argv(f / "w.out"),
                     done=(f / "w.out").exists)],
            lambda sup, steps: lm.seed_lease(sup.lease_path(steps[0]),
                                             pid=DEAD_PID, step="w")),
        summary={"w": "done"}),
    "live_owner_refused": dict(
        build=lambda sm, lm, f: (
            [sm.Step("w", _write_argv(f / "w.out"),
                     done=(f / "w.out").exists)],
            lambda sup, steps: lm.seed_lease(sup.lease_path(steps[0]),
                                             pid=os.getpid(), step="w")),
        error="ConcurrentSupervisorError"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervisor_matches_jax(tmp_path, case):
    spec = CASES[case]
    out = _run_both(tmp_path, spec["build"], max_attempts=2,
                    heartbeat_stale_s=60.0)
    _assert_same(out, spec.get("summary"), spec.get("error"))
    if "rerun" in spec:
        # a fresh supervisor over the finished run: everything skipped
        again = {}
        for side, (sup_mod, _) in SIDES.items():
            folder = out[side][2]
            sup = sup_mod.Supervisor(folder / "run", _dag(sup_mod, folder),
                                     heartbeat_stale_s=60.0)
            again[side] = (sup.run(), sup, folder)
        _assert_same(again, spec["rerun"])
    if case == "live_owner_refused":
        assert not (out["port"][2] / "w.out").exists()


def test_bad_dags_raise_like_jax(tmp_path):
    msgs = {}
    for side, (sm, _) in SIDES.items():
        got = []
        a = sm.Step("a", ["true"], done=lambda: False)
        for steps in ([sm.Step("x", ["true"], done=lambda: False,
                               deps=("ghost",))],
                      [sm.Step("a", ["true"], done=lambda: False,
                               deps=("b",)),
                       sm.Step("b", ["true"], done=lambda: False,
                               deps=("a",))],
                      [a, a]):
            with pytest.raises(ValueError) as e:
                sm.Supervisor(tmp_path / side, steps)
            got.append(str(e.value))
        msgs[side] = got
    assert msgs["port"] == msgs["jax"]


def test_stale_owner_killed_like_jax(tmp_path):
    """A hung orphan (alive, old heartbeat) is SIGKILLed and journaled
    before the step re-runs, on both sides."""
    orphans = []

    def build(sm, lm, f):
        orphan = subprocess.Popen(_hang_argv())
        orphans.append(orphan)
        step = sm.Step("w", _write_argv(f / "w.out"),
                       done=(f / "w.out").exists)
        return [step], lambda sup, steps: lm.seed_lease(
            sup.lease_path(steps[0]), pid=orphan.pid, step="w",
            clock=lambda: time.time() - 60.0)

    try:
        out = _run_both(tmp_path, build, heartbeat_stale_s=5.0)
        _assert_same(out, {"w": "done"})
        assert [o.wait(timeout=10) for o in orphans] == [-9, -9]
    finally:
        for o in orphans:
            if o.poll() is None:
                o.kill()


@pytest.mark.parametrize("probe, error", [
    ({"configured": False, "reachable": False}, "StepFailed"),
    ({"configured": True, "reachable": True}, "StepHung"),
], ids=["retry", "halt"])
def test_hang_verdicts_match_jax(tmp_path, probe, error):
    out = _run_both(
        tmp_path, lambda sm, lm, f: ([sm.Step("hang", _hang_argv(),
                                              done=lambda: False)], None),
        max_attempts=2, heartbeat_stale_s=0.5, poll_s=0.05, probe=probe)
    _assert_same(out, error=error)
    hung = [r for r in out["port"][1].journal.records()
            if r["event"] == "step.hung"]
    assert hung and hung[0]["detail"]["probe"] == probe
    assert hung[0]["detail"]["action"] == twatch.classify_hang(probe)


def test_degrade_verdict_moves_the_step_to_the_cpu(tmp_path):
    """Card configured but unreachable: the journaled ``step.hung`` →
    ``step.spawn degraded=true``, and the respawn gets ``device="cpu"``
    with the card hidden (the JAX side pins JAX_PLATFORMS instead)."""
    probe = {"configured": True, "reachable": False}

    def build(sm, lm, f):
        # one command on both sides: it hangs until the degraded
        # environment pins it to the CPU
        out = f / "deg.out"
        code = ("import os, time\n"
                "if 'cpu' not in (os.environ.get('SPARSE_CODING_DEVICE'), "
                "os.environ.get('JAX_PLATFORMS')):\n"
                "    time.sleep(60)\n"
                "open(" + repr(str(out)) + ", 'w').write("
                "os.environ.get('SPARSE_CODING_DEVICE', '') + '|' + "
                "os.environ.get('CUDA_VISIBLE_DEVICES', '<unset>'))")
        return [sm.Step("s", [sys.executable, "-c", code], done=out.exists,
                        env={"SPARSE_CODING_DEVICE": None,
                             "JAX_PLATFORMS": None})], None

    # the degraded child must finish inside the window, under a loaded
    # host too
    out = _run_both(tmp_path, build, max_attempts=2, heartbeat_stale_s=3.0,
                    poll_s=0.05, probe=probe)
    _assert_same(out, {"s": "done"})
    assert (out["port"][2] / "deg.out").read_text() == "cpu|"
    spawns = [r["detail"] for r in out["port"][1].journal.records()
              if r["event"] == "step.spawn"]
    assert [d["degraded"] for d in spawns] == [False, True]
    assert spawns[0]["argv"] == spawns[1]["argv"]


def test_cpu_only_children_get_the_cpu_and_no_card(tmp_path):
    out = tmp_path / "env.out"
    step = tsup.Step("s", [sys.executable, "-c",
                           "import os; open(" + repr(str(out)) + ", 'w')"
                           ".write(os.environ['SPARSE_CODING_DEVICE'] + '|'"
                           " + os.environ['CUDA_VISIBLE_DEVICES'])"],
                     done=out.exists)
    assert tsup.Supervisor(tmp_path / "run", [step], cpu_only=True,
                           heartbeat_stale_s=60.0).run() == {"s": "done"}
    assert out.read_text() == "cpu|"


def test_unported_builders_raise_naming_their_items(tmp_path):
    """Only the bench's supervised mode waits for its item; the group
    builders and steps are ported (tests/test_torch_port_groups.py)."""
    with pytest.raises(NotImplementedError, match="item 1 "):
        tsup.supervise_bench(tmp_path)
    assert not (tmp_path / "bench.json").exists()


# -- the builders -------------------------------------------------------------


def _config(root: Path, **harvest) -> dict:
    return {"harvest": {"dataset_folder": str(root / "chunks"), **harvest},
            "sweep": {"ensemble": {"output_folder": str(root / "sweep")}},
            "eval": {"output_folder": str(root / "eval")},
            "catalog": {"output_folder": str(root / "catalog")}}


def _shape(steps):
    return [(s.name, s.deps, s.done()) for s in steps]


@pytest.mark.parametrize("builder, harvest, only", [
    ("build_pipeline", {}, None),
    ("build_pipeline", {}, ["sweep", "eval"]),
    ("build_sharded_pipeline", {"n_shards": 2}, None),
    ("build_sharded_pipeline", {"n_shards": 2}, ["scrub", "sweep"]),
    ("build_group_pipeline", {"layers": [0, 1]}, None),
    ("build_group_pipeline", {"layers": [0, 1]}, ["group", "sweep"]),
    ("build_group_tenant_pipeline", {}, None),
])
def test_builders_match_jax(tmp_path, builder, harvest, only):
    """The same names, deps, argv shape and done() answers, before and
    after the completion markers appear; the persisted config equal."""
    cfg = _config(tmp_path, **harvest)
    j = getattr(jsup, builder)(tmp_path / "jrun", cfg, only=only)
    t = getattr(tsup, builder)(tmp_path / "trun", cfg, only=only)
    assert _shape(t) == _shape(j)
    assert [s.argv[3:] for s in t] == [[a.replace("jrun", "trun")
                                        for a in s.argv[3:]] for s in j]
    assert t[0].argv[2] == "sparse_coding_tpu_torch.pipeline.steps"
    chunks = tmp_path / "chunks"
    for i in range(2):
        (chunks / f"shard-{i:03d}").mkdir(parents=True, exist_ok=True)
        (chunks / f"shard-{i:03d}" / "meta.json").write_text("{}")
        (chunks / f"shard-{i:03d}" / "shard.digest").write_text("{}")
    (chunks / "meta.json").write_text("{}")
    (chunks / "manifest.json").write_text(json.dumps({"n_shards": 2}))
    (chunks / "groups.json").write_text("{}")
    for d, name in (("sweep/final", "dense_l1_range_learned_dicts.pkl"),
                    ("eval", "eval.json"), ("catalog", "index.json")):
        (tmp_path / d).mkdir(parents=True, exist_ok=True)
        (tmp_path / d / name).write_text("{}")
    for run in ("jrun", "trun"):
        (tmp_path / run / "scrub.done.json").write_text("{}")
    assert _shape(t) == _shape(j) and all(s.done() for s in t)
    assert (tmp_path / "trun" / "pipeline.json").read_text() == (
        tmp_path / "jrun" / "pipeline.json").read_text()


def test_run_id_persists_across_supervisors(tmp_path):
    rid = tsup.load_or_create_run_id(tmp_path / "run")
    assert rid.startswith("run-")
    assert tsup.load_or_create_run_id(tmp_path / "run") == rid
    assert tsup.Supervisor(tmp_path / "run", []).run_id == rid


# -- the steps against the JAX package's ----------------------------------------


def _jax_store(folder: Path, d: int = 8, rows: int = 96, n_chunks: int = 2):
    from sparse_coding_tpu.data.chunk_store import ChunkWriter

    rs = np.random.default_rng(4)
    w = ChunkWriter(folder, d, chunk_size_gb=rows * d * 2 / 2**30,
                    dtype="float16")
    w.add(rs.normal(size=(rows * n_chunks, d)).astype(np.float32))
    w.finalize()


def test_eval_step_matches_jax(tmp_path):
    import jax.numpy as jnp

    from sparse_coding_tpu.models import learned_dict as jld
    from sparse_coding_tpu.utils.artifacts import save_learned_dicts

    d, n = 8, 12
    _jax_store(tmp_path / "chunks", d=d)
    rs = np.random.default_rng(5)
    a = lambda *s: jnp.asarray(rs.normal(size=s).astype(np.float32))
    dicts = [(jld.UntiedSAE(encoder=a(n, d), encoder_bias=a(n),
                            dictionary=a(n, d)),
              {"l1_alpha": 1e-3, "dict_size": n, "tied": False}),
             (jld.TiedSAE(dictionary=a(n, d), encoder_bias=a(n)),
              {"l1_alpha": 3e-3, "dict_size": n, "tied": True,
               "name": "t"})]
    pkl = tmp_path / "sweep" / "final" / "dense_l1_range_learned_dicts.pkl"
    pkl.parent.mkdir(parents=True)
    save_learned_dicts(dicts, pkl)
    outs = {}
    for side, run in (("jax", jsteps.run_eval),
                      ("port", lambda c: tsteps.run_eval(c, device="cpu"))):
        cfg = {"harvest": {"dataset_folder": str(tmp_path / "chunks")},
               "sweep": {"ensemble": {"output_folder":
                                      str(tmp_path / "sweep")}},
               "eval": {"output_folder": str(tmp_path / side),
                        "n_eval_rows": 64, "seed": 2}}
        run(cfg)
        outs[side] = json.loads((tmp_path / side / "eval.json").read_text())
    j, t = outs["jax"], outs["port"]
    assert {k: v for k, v in t.items() if k != "dicts"} == {
        k: v for k, v in j.items() if k != "dicts"}
    for jr, tr in zip(j["dicts"], t["dicts"]):
        assert {k: v for k, v in tr.items() if k not in ("fvu", "l0")} == {
            k: v for k, v in jr.items() if k not in ("fvu", "l0")}
        for k in ("fvu", "l0"):
            assert tr[k] == pytest.approx(jr[k], rel=EVAL_RTOL, abs=1e-7)


def test_sweep_step_matches_jax_with_carried_inits(tmp_path, monkeypatch):
    """The sweep step on the JAX package's autodiff and the port's kernel
    path (plain versions on the CPU), the JAX experiment's init members
    carried into the port's: the final artifacts agree within rtol 2e-4."""
    from sparse_coding_tpu.config import EnsembleArgs as JaxArgs
    from sparse_coding_tpu.train import experiments as jexp
    from sparse_coding_tpu.utils.artifacts import (
        load_learned_dicts as jload,
    )
    from sparse_coding_tpu_torch.train import experiments as texp
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    _jax_store(tmp_path / "chunks", d=8, rows=128, n_chunks=2)
    l1s = [1e-3, 1e-2]
    ens = dict(dataset_folder=str(tmp_path / "chunks"), batch_size=32,
               learned_dict_ratio=2.0, n_chunks=2, seed=0, lr=1e-3)
    jcfg = JaxArgs(output_folder=str(tmp_path / "j"), use_fused="off", **ens)
    inits = {name: e.unstack() for e, _, name in
             jexp.dense_l1_range_experiment(jcfg, None, l1_range=l1s,
                                            activation_dim=8)}
    monkeypatch.setitem(jexp.EXPERIMENTS, "dense_l1_range",
                        lambda c, m: jexp.dense_l1_range_experiment(
                            c, m, l1_range=l1s, activation_dim=8))
    monkeypatch.setitem(texp.EXPERIMENTS, "dense_l1_range",
                        lambda c, m, device=None:
                        texp.dense_l1_range_experiment(
                            c, m, l1_range=l1s, activation_dim=8,
                            inits=inits, device=device))
    jsteps.run_sweep({"sweep": {"ensemble": {
        **ens, "output_folder": str(tmp_path / "j"), "use_fused": "off"},
        "log_every": 4}})
    tsteps.run_sweep({"sweep": {"ensemble": {
        **ens, "output_folder": str(tmp_path / "t")}, "log_every": 4}},
        device="cpu")
    rel = Path("final") / "dense_l1_range_learned_dicts.pkl"
    jd, td = jload(tmp_path / "j" / rel), load_learned_dicts(
        tmp_path / "t" / rel)
    assert [h for _, h in td] == [h for _, h in jd] and len(td) == 2
    for (j, _), (t, _) in zip(jd, td):
        np.testing.assert_allclose(t.dictionary.numpy(),
                                   np.asarray(j.dictionary), **DICT_TOL)
    # a second call resumes from the final set and rewrites the marker
    tsteps.run_sweep({"sweep": {"ensemble": {
        **ens, "output_folder": str(tmp_path / "t")}, "log_every": 4}},
        device="cpu")
    again = load_learned_dicts(tmp_path / "t" / rel)
    assert all(torch.equal(a.dictionary, b.dictionary)
               for (a, _), (b, _) in zip(again, td))


def test_steps_without_a_card_raise_unless_told_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    cfg = {"harvest": {"mode": "synthetic",
                       "dataset_folder": str(tmp_path / "c"),
                       "activation_dim": 4, "n_ground_truth_features": 6,
                       "dataset_size": 64, "n_chunks": 2, "batch_rows": 16}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.run_harvest(cfg)
    tsteps.run_harvest(cfg, device="cpu")
    assert (tmp_path / "c" / "meta.json").exists()


def test_synthetic_harvest_resumes_bitwise(tmp_path, monkeypatch):
    """A harvest killed after its first chunk resumes from the durable
    prefix, skipping the covered batches without drawing them, to the
    same store bytes; the shard writers' concatenation is the unsharded
    stream."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

    cfg = {"mode": "synthetic", "activation_dim": 6,
           "n_ground_truth_features": 10, "dataset_size": 240,
           "n_chunks": 4, "batch_rows": 70, "seed": 1}
    tsteps.run_harvest({"harvest": {**cfg, "dataset_folder":
                                    str(tmp_path / "full")}}, device="cpu")
    calls = []
    real = tcrash._kill_self

    class Killed(Exception):
        pass

    def kill(site):
        calls.append(site)
        raise Killed(site)

    monkeypatch.setattr(tcrash, "_kill_self", kill)
    tcrash.install_crash_plan(tcrash.parse_crash_plan("chunk.flushed:nth=2"))
    try:
        with pytest.raises(Killed):
            tsteps.run_harvest({"harvest": {**cfg, "dataset_folder":
                                            str(tmp_path / "k")}},
                               device="cpu")
    finally:
        tcrash.install_crash_plan(None)
        monkeypatch.setattr(tcrash, "_kill_self", real)
    assert calls == ["chunk.flushed"]
    assert not (tmp_path / "k" / "meta.json").exists()
    tsteps.run_harvest({"harvest": {**cfg, "dataset_folder":
                                    str(tmp_path / "k")}}, device="cpu")
    for name in ("0.npy", "1.npy", "2.npy", "3.npy", "meta.json"):
        assert (tmp_path / "k" / name).read_bytes() == (
            tmp_path / "full" / name).read_bytes(), name
    sharded = {**cfg, "n_shards": 2, "dataset_folder": str(tmp_path / "s")}
    for i in range(2):
        tsteps.run_shard_harvest({"harvest": sharded}, i, device="cpu")
    full = ChunkStore(tmp_path / "full")
    got = [ChunkStore(tmp_path / "s" / f"shard-{i:03d}").load_chunk(c)
           for i in range(2) for c in range(2)]
    for c, arr in enumerate(got):
        np.testing.assert_array_equal(arr, full.load_chunk(c))


@pytest.mark.parametrize("exc, code", [("SweepPreempted", 75),
                                       ("DivergenceHaltError", 78)])
def test_step_main_maps_typed_shutdowns(tmp_path, monkeypatch, exc, code):
    from sparse_coding_tpu_torch.resilience.errors import DivergenceHaltError
    from sparse_coding_tpu_torch.resilience.preempt import SweepPreempted

    err = (SweepPreempted(2) if exc == "SweepPreempted"
           else DivergenceHaltError("sweep.chunk", "nan"))

    def boom(config, device=None):
        raise err

    monkeypatch.setitem(tsteps.STEPS, "sweep", boom)
    # main resolves the step's device first: no card here
    monkeypatch.setenv(tsteps.ENV_DEVICE, "cpu")
    (tmp_path / "p.json").write_text("{}")
    with pytest.raises(SystemExit) as e:
        tsteps.main(["sweep", "--config", str(tmp_path / "p.json")])
    assert e.value.code == code == (tsup.STEP_EXIT_PREEMPTED
                                    if code == 75 else tsup.STEP_EXIT_HALTED)
    with pytest.raises(SystemExit, match="usage"):
        tsteps.main(["nope", "--config", "x"])


def test_sweep_child_keeps_a_sigterm_that_lands_before_the_sweep(tmp_path):
    """A SIGTERM that reaches the sweep step child after main opened its
    guard but before the sweep opened its own is not lost: the sweep
    checkpoints after its first chunk and the child exits preempted."""
    _jax_store(tmp_path / "chunks", d=8, rows=64, n_chunks=3)
    out = tmp_path / "sweep"
    (tmp_path / "p.json").write_text(json.dumps({"sweep": {
        "experiment": "dense_l1_range", "log_every": 4,
        "ensemble": {"output_folder": str(out),
                     "dataset_folder": str(tmp_path / "chunks"),
                     "batch_size": 32, "learned_dict_ratio": 2.0,
                     "n_chunks": 3, "seed": 0,
                     "checkpoint_every_chunks": 1}}}))
    code = ("import os, signal, sys\n"
            "from sparse_coding_tpu_torch.pipeline import steps\n"
            "sweep = steps.STEPS['sweep']\n"
            "def early(config, device=None):\n"
            "    os.kill(os.getpid(), signal.SIGTERM)\n"
            "    return sweep(config, device=device)\n"
            "steps.STEPS['sweep'] = early\n"
            "steps.main(sys.argv[1:])\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPARSE_CODING_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **{tsteps.ENV_DEVICE: "cpu"})
    run = subprocess.run([sys.executable, "-c", code, "sweep", "--config",
                          str(tmp_path / "p.json")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == tsup.STEP_EXIT_PREEMPTED, run.stderr[-3000:]
    assert "checkpointed after chunk 1" in run.stderr
    assert (out / "ckpt").exists() and not (out / "final").exists()


# -- the whole slice, supervised, killed and resumed -----------------------------


def _slice_config(root: Path) -> dict:
    chunks = str(root / "chunks")
    return {
        "harvest": {"mode": "synthetic", "dataset_folder": chunks,
                    "seed": 3, "activation_dim": 16,
                    "n_ground_truth_features": 12, "dataset_size": 512,
                    "n_chunks": 4, "batch_rows": 96, "dtype": "float16"},
        "sweep": {"experiment": "dense_l1_range", "log_every": 4,
                  "ensemble": {"output_folder": str(root / "sweep"),
                               "dataset_folder": chunks, "batch_size": 32,
                               "learned_dict_ratio": 2.0, "n_chunks": 4,
                               "seed": 0, "checkpoint_every_chunks": 1,
                               "profile_steps": 2}},
        "eval": {"output_folder": str(root / "eval"), "n_eval_rows": 64},
        "catalog": {"output_folder": str(root / "catalog")},
    }


def _artifact_bytes(root: Path) -> dict:
    out = {}
    for rel in ("chunks", "sweep/ckpt", "sweep/final", "eval", "catalog"):
        for p in sorted((root / rel).rglob("*")):
            if p.is_file() and "fsck" not in p.parts:
                out[str(p.relative_to(root))] = p.read_bytes()
    return out


def test_supervised_slice_killed_and_resumed_is_bitwise(tmp_path):
    """The uninterrupted reference runs the four steps in one plain
    process; the supervised run (``cpu_only``) is SIGKILLed at the second
    ``sweep.chunk`` barrier, and a fresh supervisor — preflight fsck on —
    resumes it. Chunks, the last checkpoint set, final dicts, eval.json
    and the catalog are bitwise the reference's; the journal shows the kill and the lease
    takeover; every step span ran on the CPU; the run report saw the
    kernel path and the trace; one perf-ledger row was appended."""
    from sparse_coding_tpu_torch.obs import ledger
    from sparse_coding_tpu_torch.obs.report import build_report

    ref_cfg = _slice_config(tmp_path / "ref")
    (tmp_path / "ref").mkdir()
    (tmp_path / "ref.json").write_text(json.dumps(ref_cfg))
    code = ("import json, sys\n"
            "from sparse_coding_tpu_torch.pipeline import steps\n"
            "cfg = json.load(open(sys.argv[1]))\n"
            "for s in ('harvest', 'sweep', 'eval', 'catalog'):\n"
            "    steps.STEPS[s](cfg, device='cpu')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPARSE_CODING_")}
    env["PYTHONPATH"] = str(REPO)
    ref = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "ref.json")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]

    root = tmp_path / "sup"
    cfg = _slice_config(root)
    run = root / "run"
    steps = [s for s in tsup.build_pipeline(run, cfg)
             if s.name in ("harvest", "sweep")]
    steps[1].env = {tcrash.ENV_VAR: "sweep.chunk:nth=2"}
    with pytest.raises(tsup.StepFailed, match="killed by signal 9"):
        tsup.Supervisor(run, steps, max_attempts=1, cpu_only=True,
                        heartbeat_stale_s=120.0).run()
    assert (root / "sweep" / "ckpt").exists()
    sup = tsup.Supervisor(run, tsup.build_pipeline(run, cfg), cpu_only=True,
                          heartbeat_stale_s=120.0)
    assert sup.run() == {"harvest": "skipped", "sweep": "done",
                         "eval": "done", "catalog": "done"}
    got, want = _artifact_bytes(root), _artifact_bytes(tmp_path / "ref")
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    events = [(r["event"], r["step"]) for r in sup.journal.records()]
    assert ("step.killed", "sweep") in events
    assert ("lease.takeover", "sweep") in events
    assert ("run.fsck", "") in events and events[-1] == ("run.done", "")
    report = build_report(run)
    # the killed sweep never closed its span; each step's last attempt did
    assert {name: s["count"] for name, s in report["spans"].items()
            if name.startswith("step.")} == {
        "step.harvest": 1, "step.sweep": 1, "step.eval": 1,
        "step.catalog": 1}
    devices = {(ev.get("device"), ev.get("card_peak_bytes"))
               for p in (run / "obs").glob("*.jsonl")
               for ev in map(json.loads, p.read_text().splitlines())
               if str(ev.get("span", "")).startswith("step.")}
    assert devices == {("cpu", 0)}
    assert report["kernel_paths"] and "autodiff" not in report[
        "kernel_paths"]
    assert report["perf"]["trace_captured"] >= 1
    assert (root / "sweep" / "trace" / "trace.json").exists()
    rows = ledger.read_rows(run / ledger.LEDGER_NAME)
    assert [r["kind"] for r in rows] == ["run"] and rows[0]["paths"]
