"""The port's run report, perf ledger, trace capture and device probes
(sparse_coding_tpu_torch/obs/) against the JAX package's, on the CPU.

Event files are written by the JAX package's own sink and registry (two
processes of one run, spans with errors, counters, gauges, histograms,
perf samples, a torn tail), then both ``build_report``s read them: every
section both define must be equal — exactly, since both are the same
arithmetic over the same numbers. The port reports what it prepares
(nvcc runs, CUDA-graph captures) under ``preparation`` in place of the
JAX package's XLA retrace/compile sections. ``diff_reports``,
``diff_ledger_suites`` and ``run_summary_row`` are held equal on the same
inputs, and the ledger's rows read the same from either side's file.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sparse_coding_tpu.obs import ledger as jledger
from sparse_coding_tpu.obs import report as jreport
from sparse_coding_tpu.obs.registry import Registry as JRegistry
from sparse_coding_tpu.obs.sink import EventSink as JSink
from sparse_coding_tpu.obs.spans import emit_event as jemit
from sparse_coding_tpu.obs.spans import flush_metrics as jflush
from sparse_coding_tpu.obs.spans import record_span as jspan
from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.obs import cudaprobes, ledger, report, trace
from sparse_coding_tpu_torch.obs.registry import Registry
from sparse_coding_tpu_torch.resilience import faults

REPO = Path(__file__).resolve().parents[1]

# the sections both reports define (the JAX one adds retraces, compiles
# and compile_cache; the port adds preparation)
SHARED = ("run_dir", "run_ids", "steps", "files", "events", "skipped_lines",
          "spans", "counters", "gauges", "histograms", "span_errors",
          "gateway", "ladder", "plane", "ingest", "guardian", "kernel_paths",
          "perf", "dropped_events")


def _write_run(run_dir: Path, scale: float = 1.0, backend: str = "cpu",
               torn: bool = True) -> Path:
    """Two processes' event files for one run, through the JAX writers."""
    obs_dir = run_dir / "obs"
    for proc, step in ((1, "sweep"), (2, "eval")):
        reg = JRegistry()
        sink = JSink(obs_dir / f"{step}-{proc}.jsonl")
        for i in range(5):
            jspan("sweep.chunk", 0.1 * scale * (i + 1), sink=sink,
                  registry=reg, run="run-a", step=step)
        jspan("ingest.decode", 0.02, sink=sink, registry=reg, run="run-a")
        jspan("guardian.check", 0.01, ok=(proc == 1), error="ValueError",
              sink=sink, registry=reg, run="run-a")
        jemit("perf.sample", sink=sink, backend=backend, stream="train")
        reg.counter("ensemble.path_resolved", path="train_step_tiled",
                    reason="default").inc(proc)
        reg.counter("gateway.shed", priority="batch").inc(3)
        reg.counter("gateway.hedges_fired").inc(2)
        reg.counter("serve.batches", bucket="8").inc(4)
        reg.counter("serve.rows", bucket="8").inc(29)
        reg.counter("guardian.rollbacks").inc(proc)
        reg.counter("obs.trace.captured").inc()
        reg.counter("perf.samples", path="train_step_tiled").inc(2)
        reg.counter("build.nvcc_runs").inc(proc - 1)
        reg.counter("xcache.captures").inc(3)
        reg.histogram("xcache.capture_s").observe(0.25)
        reg.gauge("gateway.ladder.rung", idx="0").set(8)
        reg.counter("plane.rebalances").inc(proc)
        reg.counter("plane.scale_ups").inc()
        reg.gauge("plane.serve_slices").set(proc)
        reg.gauge("train.mfu", backend=backend, path="x").set(0.3 / scale)
        reg.gauge("sweep.items_per_sec").set(1000.0 * proc / scale)
        for v in (0.01, 0.02, 0.04):
            reg.histogram("train.device_step_s", backend=backend).observe(
                v * scale)
            reg.histogram("perf.roofline_gap").observe(1.5)
        jflush(sink=sink, registry=reg)
        sink.close()
        if torn and proc == 2:
            with open(sink.path, "ab") as f:
                f.write(b'{"kind": "span.end", "span": "torn')
    return run_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("report")
    return {"a": _write_run(root / "a"),
            "b": _write_run(root / "b", scale=1.5),
            "gpu": _write_run(root / "gpu", backend="cuda", torn=False)}


@pytest.mark.parametrize("which", ["a", "b", "gpu"])
def test_build_report_matches_jax(runs, which):
    j = jreport.build_report(runs[which])
    t = report.build_report(runs[which])
    for section in SHARED:
        assert t[section] == j[section], section
    assert t["preparation"] == {"nvcc_runs": 1, "captures": 6,
                                "capture_s": 0.5}
    assert "retraces" not in t and "compile_cache" not in t
    text = report.format_report(t)
    assert "preparation: 1 nvcc run(s), 6 CUDA-graph capture(s)" in text
    assert "kernel paths (step-path resolutions): train_step_tiled=3" in text


@pytest.mark.parametrize("a, b", [("a", "b"), ("b", "a"), ("a", "gpu")])
def test_diff_reports_matches_jax(runs, a, b):
    for threshold in (0.10, 0.6):
        j = jreport.diff_reports(jreport.build_report(runs[a]),
                                 jreport.build_report(runs[b]), threshold)
        t = report.diff_reports(report.build_report(runs[a]),
                                report.build_report(runs[b]), threshold)
        assert t == j
    # the JAX text points at its TPU runbook; the rest is the same
    assert report.format_diff(t) == jreport.format_diff(j).replace(
        " (docs/RUNBOOK_TUNNEL.md)", "")


def _suite_rows():
    rows = []
    for rnd, scale in enumerate((1.0, 0.8, 1.3)):
        for suite, unit in (("ens", "acts/s"), ("lat", "ms"), ("x", "?")):
            rows.append({"kind": "suite", "suite": suite, "unit": unit,
                         "variant": {"d": 512}, "backend": "cuda",
                         "value": 100.0 * scale, "round": rnd})
        rows.append({"kind": "suite", "suite": "fresh", "unit": "s",
                     "backend": "cpu", "value": float(rnd + 1)})
        rows.append({"kind": "bench", "value": 1.0})
    return rows


@pytest.mark.parametrize("split", [4, 8, 12])
def test_diff_ledger_suites_matches_jax(split):
    rows = _suite_rows()
    prior, new = rows[:split], rows[split:]
    for threshold in (0.1, 0.25):
        t = report.diff_ledger_suites(prior, new, threshold)
        assert t == jreport.diff_ledger_suites(prior, new, threshold)
    assert report.format_ledger_diff(t) == jreport.format_ledger_diff(t)


def test_ledger_rows_and_summary_match_jax(runs, tmp_path, monkeypatch):
    monkeypatch.delenv(ledger.ENV_LEDGER, raising=False)
    rep = jreport.build_report(runs["a"])
    assert ledger.run_summary_row(rep, run_id="r") == \
        jledger.run_summary_row(rep, run_id="r")
    assert ledger.run_summary_row(report.build_report(runs["a"])) == \
        jledger.run_summary_row(rep)
    for mod, name in ((jledger, "j"), (ledger, "t")):
        assert mod.append_row({"kind": "run", "ts": 1.0, "v": [1, 2]},
                              tmp_path / name / mod.LEDGER_NAME)
        with open(tmp_path / name / mod.LEDGER_NAME, "ab") as f:
            f.write(b'{"torn": ')
    assert ledger.read_rows(tmp_path / "t" / ledger.LEDGER_NAME) == \
        jledger.read_rows(tmp_path / "j" / jledger.LEDGER_NAME) == [
            {"kind": "run", "ts": 1.0, "v": [1, 2]}]
    assert ledger.ledger_path(tmp_path) == tmp_path / ledger.LEDGER_NAME
    monkeypatch.setenv(ledger.ENV_LEDGER, str(tmp_path / "env.jsonl"))
    assert ledger.ledger_path(tmp_path) == tmp_path / "env.jsonl"


def test_ledger_append_fault_is_counted_not_raised(tmp_path):
    prev = obs.set_registry(Registry())
    try:
        with faults.inject(site=ledger.SITE, mode="error", error="OSError"):
            assert not ledger.append_row({"kind": "run"},
                                         tmp_path / "l.jsonl")
        counters = obs.get_registry().snapshot()["counters"]
    finally:
        obs.set_registry(prev)
    assert counters["obs.ledger.dropped"] == 1
    assert not (tmp_path / "l.jsonl").exists()


def _write_fleet(root: Path, runs: dict) -> Path:
    """A fleet dir through the JAX writers: a queue (one tenant done, one
    halted, one queued, plane records), the scheduler's event file with
    its counters, and two tenants' run dirs (``_write_run``'s)."""
    from sparse_coding_tpu.pipeline.fleet_queue import FleetQueue

    fleet = root / "fleet"
    q = FleetQueue(fleet / "fleet_queue.jsonl", clock=lambda: 0.0)
    for name, prio in (("g0", "batch"), ("g1", "batch"),
                       ("scav", "scavenger")):
        q.enqueue(name, {"kind": "group", "config": {}, "priority": prio},
                  2)
    for name, outcome in (("g0", "halted"), ("g1", "done")):
        q.append("run.place", name, attempt=1)
        q.append("run.release", name, outcome=outcome)
    q.append("plane.rebalance", serve_slices=2, fleet_slices=0,
             reason="up")
    q.append("plane.rebalance", serve_slices=1, fleet_slices=1,
             reason="down")
    for name, src in (("g0", "a"), ("g1", "b")):
        shutil.copytree(runs[src], fleet / "runs" / name)
    reg = JRegistry()
    sink = JSink(fleet / "obs" / "fleet-7.jsonl")
    reg.counter("fleet.placements").inc(2)
    reg.counter("fleet.halts").inc()
    reg.counter("fleet.releases", outcome="halted").inc()
    reg.counter("fleet.releases", outcome="done").inc()
    reg.counter("plane.rebalances").inc(2)
    reg.counter("plane.scale_downs").inc()
    reg.gauge("plane.fleet_slices").set(1)
    jspan("fleet.run", 3.0, sink=sink, registry=reg)
    jflush(sink=sink, registry=reg)
    sink.close()
    return fleet


def test_fleet_report_matches_jax(runs, tmp_path, capsys):
    fleet = _write_fleet(tmp_path, runs)
    assert report.is_fleet_dir(fleet) and not report.is_fleet_dir(tmp_path)
    j = jreport.build_fleet_report(fleet)
    t = report.build_fleet_report(fleet)
    for key in ("fleet_dir", "states", "plane", "scheduler"):
        assert t[key] == j[key], key
    assert t["states"] == {"g0": "halted", "g1": "done", "scav": "queued"}
    assert t["scheduler"]["releases"] == {"done": 1, "halted": 1}
    assert [r["reason"] for r in t["plane"]["records"]] == ["up", "down"]
    assert list(t["tenants"]) == list(j["tenants"])
    for name, tt in t["tenants"].items():
        jt = j["tenants"][name]
        assert {k: v for k, v in tt.items() if k != "report"} == \
            {k: v for k, v in jt.items() if k != "report"}
        for section in SHARED:
            assert tt["report"][section] == jt["report"][section], section
    text = report.format_fleet_report(t)
    assert "3 tenant(s)" in text and "1 halt(s)" in text
    assert "plane: 2 rebalance(s) (0 up/1 down)" in text
    assert "tenant g0: halted (batch, 1 slice(s), 1 attempt(s))" in text
    assert "1 nvcc run(s), 6 capture(s)" in text
    report.main([str(fleet)])
    assert capsys.readouterr().out.strip() == text
    report.main([str(fleet), "--json"])
    assert json.loads(capsys.readouterr().out)["states"] == t["states"]


def test_cli_json_and_diff(runs, capsys):
    report.main([str(runs["a"]), "--json"])
    assert json.loads(capsys.readouterr().out)["events"] == \
        report.build_report(runs["a"])["events"]
    report.main(["--diff", str(runs["a"]), str(runs["b"]), "--json"])
    diff = json.loads(capsys.readouterr().out)
    assert diff["compared"] > 0 and diff["regressions"]
    with pytest.raises(SystemExit, match="usage"):
        report.main([])


# -- trace capture --------------------------------------------------------------


def _counters():
    return obs.get_registry().snapshot()["counters"]


@pytest.fixture()
def fresh_registry():
    prev = obs.set_registry(Registry())
    yield
    obs.set_registry(prev)


def test_trace_capture_finalizes_atomically(tmp_path, fresh_registry):
    import torch

    out = tmp_path / "trace"
    # debris of a killed capture is cleaned at begin
    (tmp_path / ".trace.tmp.1").mkdir()
    with trace.capture(out) as cap:
        assert cap.active
        torch.ones(8).sum()
    assert not cap.active and cap.end() is None  # idempotent
    assert json.loads((out / trace.TRACE_NAME).read_text())["traceEvents"]
    assert json.loads((out / trace.KERNELS_NAME).read_text()) == {}
    assert not list(tmp_path.glob(".trace.tmp.*"))
    assert _counters()["obs.trace.captured"] == 1
    # a recapture replaces the artifact whole
    assert trace.TraceCapture(out).begin()


@pytest.mark.parametrize("stage", ["begin", "finalize"])
def test_trace_capture_fault_is_a_counted_skip(tmp_path, fresh_registry,
                                               stage):
    nth = 1 if stage == "begin" else 2
    cap = trace.TraceCapture(tmp_path / "trace")
    with faults.inject(site=trace.SITE, mode="error", nth=nth):
        started = cap.begin()
        assert started == (stage == "finalize")
        assert cap.end() is None
    assert _counters()["obs.trace.skipped"] == 1
    assert "obs.trace.captured" not in _counters()
    assert not (tmp_path / "trace").exists()
    assert not list(tmp_path.glob(".trace.tmp.*"))


def test_trace_site_is_a_crash_barrier():
    from sparse_coding_tpu_torch.resilience.crash import CRASH_SITES

    assert trace.SITE in CRASH_SITES and trace.SITE in faults.FAULT_SITES


def test_profiling_helpers(tmp_path, fresh_registry):
    import torch

    from sparse_coding_tpu_torch.utils.profiling import annotate
    from sparse_coding_tpu_torch.utils.profiling import trace as ptrace

    with ptrace(tmp_path / "t"):
        with annotate("region.x"):
            torch.ones(4).add_(1)
    text = (tmp_path / "t" / trace.TRACE_NAME).read_text()
    assert "region.x" in text


# -- device probes --------------------------------------------------------------


def test_cuda_probes_on_the_cpu(fresh_registry, monkeypatch):
    """No card: no memory gauge and no CUDA context; the nvcc runs of
    this process are published once each."""
    import torch

    from sparse_coding_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "NVCC_RUNS", 3)
    monkeypatch.setattr(cudaprobes, "_nvcc_published", 1)
    assert obs.update_memory_gauges() == 0
    assert obs.update_memory_gauges() == 0
    snap = obs.get_registry().snapshot()
    assert snap["counters"] == {"build.nvcc_runs": 2}
    assert not any(k.startswith("cuda.mem") for k in snap["gauges"])
    assert not torch.cuda.is_initialized()


def test_memory_gauges_sample_only_the_cards_allocated_on(fresh_registry,
                                                        monkeypatch):
    """On a host of several cards, only the card the process allocated on
    is sampled: ``mem_get_info`` on another would create a context
    there."""
    import torch

    asked = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 7 * (i == 1),
        "allocated_bytes.all.peak": 9 * (i == 1)})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: asked.append(i) or (5, 11))
    assert obs.update_memory_gauges() == 1
    assert asked == [1]
    gauges = obs.get_registry().snapshot()["gauges"]
    assert {k: v["value"] for k, v in gauges.items()
            if k.startswith("cuda.mem")} == {
        "cuda.mem.bytes_in_use{device=1}": 7,
        "cuda.mem.peak_bytes_in_use{device=1}": 9,
        "cuda.mem.bytes_limit{device=1}": 11,
        "cuda.mem.bytes_free{device=1}": 5}


def test_report_cli_leaves_cuda_uninitialized(runs):
    code = ("import sys, torch\n"
            "from sparse_coding_tpu_torch.obs.report import main\n"
            "main([sys.argv[1]])\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code, str(runs["a"])],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"
    assert "run run-a" in out.stdout
