"""Merge a run's event files into one summary (the port's counterpart of
the JAX package's ``obs/report.py``).

``python -m sparse_coding_tpu_torch.obs.report <run_dir> [--json]``
scans ``<run_dir>/obs/*.jsonl`` — one file per process that took part in
the run (the supervisor and every step attempt) — and joins them on the
run ID the supervisor propagated:

- per-span duration stats (count, errors, p50/p95/p99, total wall) from
  ``span.end`` events, exact;
- merged registry counters (summed across processes), gauges (latest by
  wall clock) and histograms (bin for bin) from each file's LAST
  ``metrics`` event, the crash-safe snapshot hosts flush at durable
  boundaries;
- ``preparation``: what the port prepares in place of XLA's traces and
  compiles — the nvcc runs that built kernel libraries
  (``build.nvcc_runs``) and the CUDA-graph captures (``xcache.captures``,
  with their seconds). The JAX report's retrace/compile and executable
  cache sections have no meaning here and are not produced;
- hygiene: files scanned, torn/corrupt lines skipped, run IDs seen;
- the serving gateway and ladder, the elastic plane, the ingest and
  scrub, the guardian, the kernel-path mix (``ensemble.path_resolved``:
  which kernel path each ensemble ran, the evidence that a step child
  went through the kernels) and the device-time ``perf`` section, as in
  the JAX package.

``--diff <run_a> <run_b>`` compares two runs' perf sections and flags
MFU and latency regressions (label-exact, backend-aware), and
:func:`diff_ledger_suites` gates ledger suite rows round over round.
On a fleet dir (its ``fleet_queue.jsonl``) the CLI routes to
:func:`build_fleet_report`: the queue replayed, each tenant's own merged
report, and the scheduler's and the plane's counters.

Diagnostics go to the returned dict / stdout only; this module never
initializes CUDA, so the CLI runs on a host whose card is wedged.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Optional

import threading

from sparse_coding_tpu_torch.obs.registry import Histogram
from sparse_coding_tpu_torch.obs.sink import scan_events


def _quantile(values: list[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
    return ordered[idx]


def split_labels(name: str) -> tuple[str, dict]:
    """``"base{k=v,k2=v2}"`` → ``(base, {k: v, k2: v2})`` (``{}`` for a
    bare name) — the ONE parser of the registry's instrument-label
    encoding (obs/registry._label_key), shared by every section below."""
    if "{" not in name:
        return name, {}
    base = name[:name.index("{")]
    labels = dict(pair.partition("=")[::2]
                  for pair in name[name.index("{") + 1:-1].split(","))
    return base, labels


def build_report(run_dir: str | Path, obs_subdir: str = "obs") -> dict:
    """The merged summary dict for one run directory."""
    run_dir = Path(run_dir)
    obs_dir = run_dir / obs_subdir
    files = sorted(obs_dir.glob("*.jsonl")) if obs_dir.exists() else []
    spans: dict[str, dict] = {}
    counters: dict[str, int] = {}
    gauges: dict[str, dict] = {}  # name -> {"value", "max", "ts"}
    merged: dict[str, Histogram] = {}
    run_ids: set[str] = set()
    steps: set[str] = set()
    perf_backends: set[str] = set()
    skipped_total = 0
    n_events = 0
    errors: dict[str, int] = {}

    for path in files:
        events, skipped = scan_events(path)
        skipped_total += skipped
        n_events += len(events)
        last_metrics: Optional[dict] = None
        for ev in events:
            if ev.get("run"):
                run_ids.add(ev["run"])
            if ev.get("step"):
                steps.add(ev["step"])
            kind = ev.get("kind")
            if kind == "span.end":
                s = spans.setdefault(ev.get("span", "?"), {
                    "count": 0, "errors": 0, "dur_s": []})
                s["count"] += 1
                if not ev.get("ok", True):
                    s["errors"] += 1
                    err = ev.get("error", "Error")
                    errors[err] = errors.get(err, 0) + 1
                if isinstance(ev.get("dur_s"), (int, float)):
                    s["dur_s"].append(float(ev["dur_s"]))
            elif kind == "perf.sample":
                # which backend(s) this run's device-time samples were
                # measured on — the diff's cross-backend guard reads it
                # even when a sample carried no MFU (zero-flops costs)
                if ev.get("backend"):
                    perf_backends.add(str(ev["backend"]))
            elif kind == "metrics":
                last_metrics = ev
        if last_metrics is not None:
            snap = last_metrics.get("registry", {})
            for name, v in snap.get("counters", {}).items():
                counters[name] = counters.get(name, 0) + int(v)
            ts = float(last_metrics.get("ts", 0.0))
            for name, g in snap.get("gauges", {}).items():
                if name not in gauges or ts >= gauges[name]["ts"]:
                    gauges[name] = {"value": g.get("value"),
                                    "max": g.get("max"), "ts": ts}
            for name, h in snap.get("histograms", {}).items():
                hist = merged.get(name)
                if hist is None:
                    hist = merged[name] = Histogram(threading.Lock(),
                                                    bounds=h.get("bounds"))
                try:
                    hist.merge_snapshot(h)
                except ValueError:
                    pass  # bounds drifted between processes: skip, not die

    span_stats = {}
    for name, s in sorted(spans.items()):
        durs = s["dur_s"]
        span_stats[name] = {
            "count": s["count"], "errors": s["errors"],
            "total_s": round(sum(durs), 6),
            "p50_s": _quantile(durs, 0.50), "p95_s": _quantile(durs, 0.95),
            "p99_s": _quantile(durs, 0.99),
        }
    histograms = {name: {**h.snapshot(),
                         "p50": h.quantile(0.50), "p95": h.quantile(0.95),
                         "p99": h.quantile(0.99)}
                  for name, h in merged.items()}

    def _hist_sum(name: str) -> float:
        h = histograms.get(name)
        return round(float(h["sum"]), 3) if h else 0.0

    # what the port prepares where the JAX package traces and compiles:
    # nvcc builds of the kernel libraries and CUDA-graph captures
    preparation = {
        "nvcc_runs": counters.get("build.nvcc_runs", 0),
        "captures": counters.get("xcache.captures", 0),
        "capture_s": _hist_sum("xcache.capture_s"),
    }

    # gateway evidence: the self-healing
    # front door's hedge / shed / failover / spare-activation story in
    # one place, so a replica incident reads out of the SAME merged
    # report as its latency and compile evidence
    def _by_label(prefix: str, label: str) -> dict:
        out = {}
        for name, v in counters.items():
            base, labels = split_labels(name)
            if base == prefix and label in labels:
                out[labels[label]] = out.get(labels[label], 0) + int(v)
        return out

    gateway = {
        "hedges_fired": counters.get("gateway.hedges_fired", 0),
        "hedges_won": counters.get("gateway.hedges_won", 0),
        "hedges_wasted": counters.get("gateway.hedges_wasted", 0),
        "hedges_abandoned": counters.get("gateway.hedges_abandoned", 0),
        "failovers": counters.get("gateway.failovers", 0),
        "route_errors": counters.get("gateway.route_errors", 0),
        "spare_activations": counters.get("gateway.spare_activations", 0),
        "spare_activation_errors":
            counters.get("gateway.spare_activation_errors", 0),
        "spare_exhausted": counters.get("gateway.spare_exhausted", 0),
        "shed": _by_label("gateway.shed", "priority"),
        "served": _by_label("gateway.served", "priority"),
        "routes": _by_label("gateway.routes", "replica"),
        "replica_errors": _by_label("gateway.replica_errors", "replica"),
        "dispatch_timeouts": _by_label("gateway.dispatch_timeouts",
                                       "replica"),
        "admission_level":
            gauges.get("gateway.admission_level", {}).get("value"),
    }

    # traffic-shaped ladder evidence: the
    # ACTIVE rung set (published as idx-labeled gauges at every swap),
    # the swap/hold/skip tallies, the continuous-rebatching outcome, and
    # the pad-waste the ladder exists to shrink — Σ over buckets of
    # (batches x bucket − rows served). One section answers "did the
    # derived ladder actually pay": rungs match traffic, wasted pad
    # falls, swaps are counted not flapping
    active_rungs = []
    for name, g in gauges.items():
        base, labels = split_labels(name)
        if base == "gateway.ladder.rung" and "idx" in labels:
            v = g.get("value")
            if v:
                active_rungs.append((int(labels["idx"]), int(v)))
    wasted_pad_rows = 0
    served_rows = _by_label("serve.rows", "bucket")
    for b, n_batches in _by_label("serve.batches", "bucket").items():
        try:
            wasted_pad_rows += (int(b) * int(n_batches)
                                - int(served_rows.get(b, 0)))
        except (TypeError, ValueError):
            continue
    ladder = {
        "rungs": [r for _, r in sorted(active_rungs)],
        "swaps": counters.get("gateway.ladder.swaps", 0),
        "held": counters.get("gateway.ladder.held", 0),
        "derive_errors": counters.get("gateway.ladder.derive_errors", 0),
        "swap_errors": counters.get("gateway.ladder.swap_errors", 0),
        "rebatch_joined": counters.get("serve.rebatch.joined", 0),
        "rebatch_joined_rows": counters.get("serve.rebatch.joined_rows", 0),
        "rebatch_rejected": counters.get("serve.rebatch.rejected", 0),
        # every joined row is a pad row the dispatched batch would have
        # burned anyway — the rebatcher's direct savings
        "pad_rows_saved": counters.get("serve.rebatch.joined_rows", 0),
        "wasted_pad_rows": wasted_pad_rows,
    }
    # data-plane evidence: the async ingest
    # pipeline's per-stage walls (decode vs host→device staging vs the
    # whole sweep.chunk block — "compute-bound" means decode stops
    # dominating sweep.chunk), stream-death degradations, and the scrub's
    # verify/quarantine tallies — one place an operator reads a data
    # incident out of, alongside the latency and compile evidence
    def _span_wall(name: str) -> float:
        s = span_stats.get(name)
        return float(s["total_s"]) if s else 0.0

    ingest = {
        "decode_s": _span_wall("ingest.decode"),
        "transfer_s": _span_wall("ingest.transfer"),
        "sweep_chunk_s": _span_wall("sweep.chunk"),
        "decoded_chunks": span_stats.get("ingest.decode", {}).get("count", 0),
        "degraded_streams": counters.get("ingest.degraded", 0),
        "scrub_checked": counters.get("scrub.chunks_checked", 0),
        "scrub_quarantined": counters.get("scrub.chunks_quarantined", 0),
    }
    # kernel-path evidence: every Ensemble._resolve_step
    # decision is a counted event — which program each bucket's steps ran
    # (two_stage / train_step / the feature-tiled variants / autodiff)
    # and why (roofline | forced | no_admissible_tile | ...) — so a sweep
    # that quietly fell back to autodiff is visible in every run report
    # instead of invisible in all artifacts
    kernel_paths: dict = {}
    for name, v in counters.items():
        base, labels = split_labels(name)
        if base != "ensemble.path_resolved" or not labels:
            continue
        ent = kernel_paths.setdefault(labels.get("path", "?"),
                                      {"count": 0, "reasons": {}})
        ent["count"] += int(v)
        reason = labels.get("reason", "?")
        ent["reasons"][reason] = ent["reasons"].get(reason, 0) + int(v)

    # device-time perf evidence: the
    # sampled probe's measured MFU per kernel path (backend-labeled —
    # cpu rows are reference numbers, never compared against on-chip
    # rows), per-path device step walls, the predicted-vs-achieved
    # roofline gap, the request critical-path stage decomposition, and
    # the managed-trace capture tallies — the section --diff compares
    # between runs
    def _hist_stats(h: dict) -> dict:
        return {"count": h["count"], "p50": h.get("p50"),
                "p95": h.get("p95"), "p99": h.get("p99")}

    perf_mfu: dict = {}
    for name, g in gauges.items():
        if split_labels(name)[0] in ("train.mfu", "serve.mfu"):
            perf_mfu[name] = g["value"]
    device_steps: dict = {}
    gaps: dict = {}
    stages: dict = {}
    for name, h in histograms.items():
        base, labels = split_labels(name)
        if base in ("train.device_step_s", "serve.device_step_s"):
            device_steps[name] = _hist_stats(h)
        elif base == "perf.roofline_gap":
            gaps[name] = _hist_stats(h)
        elif base == "serve.stage_s":
            stages[labels.get("stage", "?")] = _hist_stats(h)
    perf = {
        "mfu": perf_mfu,
        "device_step_s": device_steps,
        "roofline_gap": gaps,
        "request_stages": stages,
        "backends": sorted(perf_backends),
        "samples": sum(v for n, v in counters.items()
                       if n.startswith("perf.samples")),
        "trace_captured": counters.get("obs.trace.captured", 0),
        "trace_skipped": counters.get("obs.trace.skipped", 0),
    }

    # elastic-plane evidence: the arbiter's rebalance story — how often
    # serving and the fleet traded slices, which direction, what it cost
    # (scavenger reclaims), what failed (fault-sited errors, retried next
    # tick) — and the current split gauges
    plane = {
        "rebalances": counters.get("plane.rebalances", 0),
        "scale_ups": counters.get("plane.scale_ups", 0),
        "scale_downs": counters.get("plane.scale_downs", 0),
        "reclaims": counters.get("plane.reclaims", 0),
        "reconciles": counters.get("plane.reconciles", 0),
        "replicas_released": counters.get("plane.replicas_released", 0),
        "rebalance_errors": counters.get("plane.rebalance_errors", 0),
        "scale_errors": counters.get("plane.scale_errors", 0),
        "serve_slices": gauges.get("plane.serve_slices", {}).get("value"),
        "fleet_slices": gauges.get("plane.fleet_slices", {}).get("value"),
        "replicas": gauges.get("plane.replicas", {}).get("value"),
    }

    # guardian evidence: the sweep's divergence
    # ladder — member quarantines, chunk quarantines, rollbacks, typed
    # halts — plus the boundary-check and rollback walls, so one merged
    # report tells the whole incident story next to the throughput and
    # ingest evidence it disturbed
    guardian = {
        "members_quarantined":
            counters.get("guardian.members_quarantined", 0),
        "chunks_quarantined": counters.get("guardian.chunks_quarantined", 0),
        "rollbacks": counters.get("guardian.rollbacks", 0),
        "halts": counters.get("guardian.halts", 0),
        "checks": span_stats.get("guardian.check", {}).get("count", 0),
        "check_s": _span_wall("guardian.check"),
        "rollback_s": _span_wall("guardian.rollback"),
    }
    return {
        "run_dir": str(run_dir),
        "run_ids": sorted(run_ids),
        "steps": sorted(steps),
        "files": [p.name for p in files],
        "events": n_events,
        "skipped_lines": skipped_total,
        "spans": span_stats,
        "counters": dict(sorted(counters.items())),
        "gauges": {k: {"value": v["value"], "max": v["max"]}
                   for k, v in sorted(gauges.items())},
        "histograms": histograms,
        "span_errors": errors,
        "preparation": preparation,
        "gateway": gateway,
        "ladder": ladder,
        "plane": plane,
        "ingest": ingest,
        "guardian": guardian,
        "kernel_paths": kernel_paths,
        "perf": perf,
        "dropped_events": counters.get("obs.sink.dropped", 0),
    }


def is_fleet_dir(path: str | Path) -> bool:
    """A fleet dir is recognized by its queue file — the CLI auto-routes
    to the fleet section (one report command, whatever the layout)."""
    from sparse_coding_tpu_torch.pipeline.fleet_queue import QUEUE_NAME

    return (Path(path) / QUEUE_NAME).exists()


def build_fleet_report(fleet_dir: str | Path) -> dict:
    """The multi-tenant merge: replay the fleet queue (host only — runs
    on a host whose card is wedged) and build each tenant's OWN merged
    report over its run dir, plus the scheduler's
    placement/preemption/containment counters from the fleet-level event
    files. One command answers the incident questions: which tenant
    halted, what did it cost everyone else (nothing), and did the next
    tenant start warm (no nvcc run, no capture outside a warmup)."""
    from sparse_coding_tpu_torch.pipeline.fleet_queue import (
        QUEUE_NAME,
        FleetQueue,
    )

    fleet_dir = Path(fleet_dir)
    state = FleetQueue(fleet_dir / QUEUE_NAME).replay()
    tenants = {}
    for name, run in sorted(state.runs.items()):
        report = build_report(fleet_dir / "runs" / name)
        tenants[name] = {
            "state": run.state, "priority": run.priority,
            "slices": run.slices, "attempts": run.attempts,
            "report": report,
        }
    # the scheduler's own evidence stream (obs/fleet-<pid>.jsonl files)
    sched = build_report(fleet_dir)
    counters = sched.get("counters", {})
    releases = {}
    for cname, v in counters.items():
        base, labels = split_labels(cname)
        if base == "fleet.releases" and "outcome" in labels:
            releases[labels["outcome"]] = releases.get(
                labels["outcome"], 0) + int(v)
    # plane.rebalance records are plane-level journal events (step=""),
    # invisible to the run-state fold by design — surface them here so
    # the fleet report shows the tide cycle the tenants lived through
    rebalances = [
        {"seq": int(r.get("seq", 0)),
         "serve_slices": int((r.get("detail") or {}).get(
             "serve_slices", 0)),
         "fleet_slices": int((r.get("detail") or {}).get(
             "fleet_slices", 0)),
         "reason": (r.get("detail") or {}).get("reason", "?")}
        for r in FleetQueue(fleet_dir / QUEUE_NAME).journal.records()
        if r.get("event") == "plane.rebalance"]
    return {
        "fleet_dir": str(fleet_dir),
        "states": state.summary(),
        "tenants": tenants,
        "plane": {**sched.get("plane", {}), "records": rebalances},
        "scheduler": {
            "placements": counters.get("fleet.placements", 0),
            "preemptions": counters.get("fleet.preemptions", 0),
            "halts": counters.get("fleet.halts", 0),
            "reclaims": counters.get("fleet.reclaims", 0),
            "worker_hangs": counters.get("fleet.worker_hangs", 0),
            "place_errors": counters.get("fleet.place_errors", 0),
            "preempt_errors": counters.get("fleet.preempt_errors", 0),
            "releases": releases,
            "events": sched.get("events", 0),
        },
    }


def format_fleet_report(fleet: dict) -> str:
    sched = fleet["scheduler"]
    lines = [f"fleet {fleet['fleet_dir']} — "
             f"{len(fleet['tenants'])} tenant(s)",
             f"scheduler: {sched['placements']} placement(s), "
             f"{sched['preemptions']} preemption(s), "
             f"{sched['halts']} halt(s), {sched['reclaims']} reclaim(s), "
             f"{sched['worker_hangs']} hung worker(s); releases "
             + (", ".join(f"{k}={v}"
                          for k, v in sorted(sched["releases"].items()))
                or "-")]
    plane = fleet.get("plane", {})
    if plane.get("records") or plane.get("rebalances"):
        lines.append(
            f"plane: {plane.get('rebalances', 0)} rebalance(s) "
            f"({plane.get('scale_ups', 0)} up/"
            f"{plane.get('scale_downs', 0)} down), "
            f"{plane.get('reclaims', 0)} scavenger reclaim(s), "
            f"{plane.get('rebalance_errors', 0)}+"
            f"{plane.get('scale_errors', 0)} error(s); split "
            f"serve={plane.get('serve_slices', '-')}/"
            f"fleet={plane.get('fleet_slices', '-')} slice(s)")
    for name, t in fleet["tenants"].items():
        rep = t["report"]
        gd = rep.get("guardian", {})
        prep = rep.get("preparation", {})
        lines.append(
            f"tenant {name}: {t['state']} ({t['priority']}, "
            f"{t['slices']} slice(s), {t['attempts']} attempt(s)) — "
            f"guardian {gd.get('halts', 0)} halt(s)/"
            f"{gd.get('rollbacks', 0)} rollback(s), "
            f"{prep.get('nvcc_runs', 0)} nvcc run(s), "
            f"{prep.get('captures', 0)} capture(s), "
            f"{rep.get('events', 0)} event(s)")
    lines.append("per-tenant detail: python -m "
                 "sparse_coding_tpu_torch.obs.report "
                 "<fleet_dir>/runs/<tenant>")
    return "\n".join(lines)


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.2f}s"


def format_report(report: dict) -> str:
    lines = [f"run {', '.join(report['run_ids']) or '(no run id)'} — "
             f"{len(report['files'])} event file(s), {report['events']} "
             f"events, {report['skipped_lines']} torn/corrupt line(s) "
             f"skipped",
             f"steps: {', '.join(report['steps']) or '-'}"]
    if report["spans"]:
        lines.append("spans (count/err  p50  p95  p99  total):")
        for name, s in report["spans"].items():
            lines.append(
                f"  {name:<28} {s['count']}/{s['errors']}  "
                f"{_fmt_s(s['p50_s'])}  {_fmt_s(s['p95_s'])}  "
                f"{_fmt_s(s['p99_s'])}  {_fmt_s(s['total_s'])}")
    throughput = {k: v for k, v in report["gauges"].items()
                  if k.endswith("per_sec")}
    if throughput:
        lines.append("throughput:")
        for name, g in throughput.items():
            lines.append(f"  {name:<28} {g['value']:.1f} (max {g['max']:.1f})")
    prep = report["preparation"]
    lines.append(f"preparation: {prep['nvcc_runs']} nvcc run(s), "
                 f"{prep['captures']} CUDA-graph capture(s) "
                 f"({_fmt_s(prep['capture_s'])})")
    gw = report.get("gateway", {})
    if any(v for k, v in gw.items()
           if k != "admission_level" and (v if isinstance(v, int)
                                          else sum(v.values()))):
        shed = ", ".join(f"{p}={n}" for p, n in sorted(gw["shed"].items()))
        routes = ", ".join(f"{r}={n}"
                           for r, n in sorted(gw["routes"].items()))
        lines.append(
            f"gateway: hedges {gw['hedges_fired']}f/{gw['hedges_won']}w/"
            f"{gw['hedges_wasted']}x, failovers {gw['failovers']}, "
            f"spares {gw['spare_activations']} activated "
            f"({gw['spare_activation_errors']} failed), "
            f"admission level {gw['admission_level']}")
        if shed:
            lines.append(f"  shed: {shed}")
        if routes:
            lines.append(f"  routes: {routes}")
    lad = report.get("ladder", {})
    if lad.get("rungs") or any(
            lad.get(k) for k in ("swaps", "held", "derive_errors",
                                 "swap_errors", "rebatch_joined",
                                 "rebatch_rejected")):
        rungs = ",".join(str(r) for r in lad.get("rungs", [])) or "?"
        lines.append(
            f"ladder: active [{rungs}], {lad['swaps']} swap(s) "
            f"({lad['held']} held, {lad['derive_errors']} derive err, "
            f"{lad['swap_errors']} swap err); rebatch "
            f"{lad['rebatch_joined']} joined "
            f"(+{lad['rebatch_joined_rows']} rows) / "
            f"{lad['rebatch_rejected']} rejected; pad rows "
            f"{lad['wasted_pad_rows']} wasted / "
            f"{lad['pad_rows_saved']} saved")
    ing = report.get("ingest", {})
    if any(ing.get(k) for k in ("decoded_chunks", "degraded_streams",
                                "scrub_checked", "scrub_quarantined")):
        lines.append(
            f"ingest: {ing['decoded_chunks']} async decode(s) "
            f"({_fmt_s(ing['decode_s'])} decoding, "
            f"{_fmt_s(ing['transfer_s'])} staging, "
            f"{_fmt_s(ing['sweep_chunk_s'])} sweep.chunk), "
            f"{ing['degraded_streams']} stream death(s) degraded; "
            f"scrub {ing['scrub_checked']} checked / "
            f"{ing['scrub_quarantined']} quarantined")
    gd = report.get("guardian", {})
    if any(gd.get(k) for k in ("members_quarantined", "chunks_quarantined",
                               "rollbacks", "halts")):
        lines.append(
            f"guardian: {gd['members_quarantined']} member(s) quarantined, "
            f"{gd['chunks_quarantined']} chunk(s) quarantined, "
            f"{gd['rollbacks']} rollback(s), {gd['halts']} halt(s) "
            f"({gd['checks']} checks, {_fmt_s(gd['check_s'])} checking, "
            f"{_fmt_s(gd['rollback_s'])} restoring)")
    kp = report.get("kernel_paths", {})
    if kp:
        parts = []
        for path, ent in sorted(kp.items()):
            reasons = ",".join(f"{r}={n}"
                               for r, n in sorted(ent["reasons"].items()))
            parts.append(f"{path}={ent['count']} [{reasons}]")
        lines.append("kernel paths (step-path resolutions): "
                     + ", ".join(parts))
    pf = report.get("perf", {})
    if pf.get("samples") or pf.get("trace_captured") or pf.get(
            "trace_skipped"):
        lines.append(
            f"perf: {pf['samples']} device-time sample(s), traces "
            f"{pf['trace_captured']} captured / {pf['trace_skipped']} "
            "skipped")
        for name, v in sorted(pf.get("mfu", {}).items()):
            lines.append(f"  {name:<40} {v:.4f}")
        for name, s in sorted(pf.get("device_step_s", {}).items()):
            lines.append(f"  {name:<40} p50 {_fmt_s(s['p50'])}  "
                         f"p95 {_fmt_s(s['p95'])}  ({s['count']})")
        for name, s in sorted(pf.get("roofline_gap", {}).items()):
            lines.append(f"  {name:<40} x{s['p50']:.2f} measured/"
                         f"predicted  ({s['count']})")
        if pf.get("request_stages"):
            stage_bits = "  ".join(
                f"{st}={_fmt_s(s['p50'])}/{_fmt_s(s['p95'])}/"
                f"{_fmt_s(s['p99'])}"
                for st, s in sorted(pf["request_stages"].items()))
            lines.append(f"  request stages (p50/p95/p99): {stage_bits}")
    if report["counters"]:
        lines.append("counters:")
        for name, v in report["counters"].items():
            lines.append(f"  {name:<28} {v}")
    if report["span_errors"]:
        lines.append(f"errors: {report['span_errors']}")
    return "\n".join(lines)


def _perf_backends(perf: dict) -> set:
    """The backends a run's perf samples were measured on: the
    ``perf.sample`` events' backend field (present even for zero-flops
    samples that set no MFU gauge) unioned with the backend-labeled MFU
    gauge names."""
    out = set(perf.get("backends", []))
    for name in perf.get("mfu", {}):
        backend = split_labels(name)[1].get("backend")
        if backend:
            out.add(backend)
    return out


def diff_reports(report_a: dict, report_b: dict,
                 threshold: float = 0.10) -> dict:
    """Compare two runs' perf evidence (A = baseline, B = candidate):
    MFU drops and latency/step-wall increases beyond ``threshold`` are
    flagged as regressions. A cpu-fallback run never compares against an
    on-chip run: backend-labeled rows only
    match their exact label twin, and when the two runs' detected
    backends differ, every backend-UNLABELED metric (step walls,
    roofline gaps, request stages, latency histograms) is skipped and
    counted instead of flagged as a bogus cross-backend regression."""
    pa, pb = report_a.get("perf", {}), report_b.get("perf", {})
    ba, bb = _perf_backends(pa), _perf_backends(pb)
    cross_backend = bool(ba) and bool(bb) and ba != bb
    regressions: list[str] = []
    improvements: list[str] = []
    compared = 0
    skipped_cross_backend = 0

    def _flag(name: str, a: float, b: float, higher_is_better: bool,
              fmt: str = "{:.4f}", backend_labeled: bool = False) -> None:
        nonlocal compared, skipped_cross_backend
        if not a or a <= 0 or b is None:
            return
        if cross_backend and not backend_labeled:
            skipped_cross_backend += 1
            return
        compared += 1
        rel = (b - a) / a
        worse = rel < -threshold if higher_is_better else rel > threshold
        better = rel > threshold if higher_is_better else rel < -threshold
        line = (f"{name}: {fmt.format(a)} -> {fmt.format(b)} "
                f"({rel * 100.0:+.1f}%)")
        if worse:
            regressions.append(line)
        elif better:
            improvements.append(line)

    for name, a in pa.get("mfu", {}).items():
        b = pb.get("mfu", {}).get(name)
        if b is not None:
            _flag(name, a, b, higher_is_better=True,
                  backend_labeled="backend" in split_labels(name)[1])
    for section, stat in (("device_step_s", "p50"),
                          ("roofline_gap", "p50"),
                          ("request_stages", "p95")):
        for name, sa in pa.get(section, {}).items():
            sb = pb.get(section, {}).get(name)
            if sb is not None and sa.get(stat) and sb.get(stat) is not None:
                _flag(f"{section}:{name}:{stat}", sa[stat], sb[stat],
                      higher_is_better=False, fmt="{:.6f}")
    for hist in ("gateway.latency_s",):
        ha = report_a.get("histograms", {}).get(hist)
        hb = report_b.get("histograms", {}).get(hist)
        if ha and hb and ha.get("p95") and hb.get("p95") is not None:
            _flag(f"{hist}:p95", ha["p95"], hb["p95"],
                  higher_is_better=False, fmt="{:.6f}")
    return {"run_a": report_a.get("run_dir"), "run_b": report_b.get("run_dir"),
            "threshold": threshold, "compared": compared,
            "backends_a": sorted(ba), "backends_b": sorted(bb),
            "skipped_cross_backend": skipped_cross_backend,
            "regressions": regressions, "improvements": improvements}


def _unit_higher_is_better(unit: str) -> Optional[bool]:
    """Direction semantics of a ledger row's unit: rates (``.../s``) and
    ratios improve upward; walls (``s``/``ms``) and overhead percentages
    improve downward. ``None`` = unknown semantics — never gated on."""
    u = (unit or "").strip()
    if "/s" in u or u == "ratio":
        return True
    head = u.split()[0] if u else ""
    if head in ("s", "ms") or u.startswith("%"):
        return False
    return None


def diff_ledger_suites(prior_rows: list[dict], new_rows: list[dict],
                       threshold: float = 0.10) -> dict:
    """Compare a bench run's suite rows against the last prior ledger row
    with the same (suite, variant, unit, backend) — the round-over-round
    regression gate. Backend is part of the key, so a cpu-fallback
    round never compares against an on-chip round (the same guard
    ``diff_reports`` applies per-run); rows with no prior twin are listed
    as ``fresh``, not flagged; units with unknown direction semantics are
    skipped and counted."""
    def _key(r: dict) -> tuple:
        return (r.get("suite"), json.dumps(r.get("variant"), sort_keys=True,
                                           default=repr),
                r.get("unit"), r.get("backend"))

    baseline: dict[tuple, dict] = {}
    for r in prior_rows:
        if r.get("kind") == "suite" and isinstance(r.get("value"),
                                                   (int, float)):
            baseline[_key(r)] = r  # last prior row per key = the baseline
    regressions: list[str] = []
    improvements: list[str] = []
    fresh: list[str] = []
    compared = 0
    skipped = 0
    for r in new_rows:
        if r.get("kind") != "suite" or not isinstance(r.get("value"),
                                                      (int, float)):
            continue
        variant = r.get("variant")
        label = (f"{r.get('suite')}[{variant}]" if variant is not None
                 else str(r.get("suite")))
        label += f" ({r.get('unit')}, {r.get('backend')})"
        prior = baseline.get(_key(r))
        if prior is None:
            fresh.append(label)
            continue
        higher = _unit_higher_is_better(r.get("unit") or "")
        a, b = float(prior["value"]), float(r["value"])
        if higher is None or a <= 0:
            skipped += 1
            continue
        compared += 1
        rel = (b - a) / a
        line = f"{label}: {a:g} -> {b:g} ({rel * 100.0:+.1f}%)"
        worse = rel < -threshold if higher else rel > threshold
        better = rel > threshold if higher else rel < -threshold
        if worse:
            regressions.append(line)
        elif better:
            improvements.append(line)
    return {"threshold": threshold, "compared": compared,
            "skipped": skipped, "fresh": fresh,
            "regressions": regressions, "improvements": improvements}


def format_ledger_diff(diff: dict) -> str:
    lines = [f"bench gate: {diff['compared']} suite row(s) compared "
             f"against the perf ledger (threshold "
             f"{diff['threshold'] * 100:.0f}%, {len(diff['fresh'])} "
             f"fresh, {diff['skipped']} skipped)"]
    for r in diff["regressions"]:
        lines.append(f"  REGRESSION  {r}")
    for i in diff["improvements"]:
        lines.append(f"  improvement {i}")
    if not diff["regressions"] and not diff["improvements"]:
        lines.append("  no significant change vs prior rounds")
    return "\n".join(lines)


def format_diff(diff: dict) -> str:
    lines = [f"perf diff {diff['run_a']} -> {diff['run_b']} "
             f"({diff['compared']} metric(s) compared, threshold "
             f"{diff['threshold'] * 100:.0f}%)"]
    if diff.get("skipped_cross_backend"):
        lines.append(
            f"  note: runs measured on different backends "
            f"({','.join(diff['backends_a']) or '?'} vs "
            f"{','.join(diff['backends_b']) or '?'}); "
            f"{diff['skipped_cross_backend']} backend-unlabeled metric(s) "
            "skipped, not compared")
    for r in diff["regressions"]:
        lines.append(f"  REGRESSION  {r}")
    for i in diff["improvements"]:
        lines.append(f"  improvement {i}")
    if not diff["regressions"] and not diff["improvements"]:
        lines.append("  no significant change")
    return "\n".join(lines)


def _print_report(payload: dict, formatter, as_json: bool) -> None:
    """The one CLI emit path: JSON or formatted, `| head`-tolerant."""
    try:
        print(json.dumps(payload, indent=2, default=float) if as_json
              else formatter(payload))
    except BrokenPipeError:
        # `... | head` closed the pipe: normal CLI usage, not an error
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if "--diff" in argv:
        argv.remove("--diff")
        threshold = 0.10
        if "--threshold" in argv:
            i = argv.index("--threshold")
            try:
                threshold = float(argv[i + 1])
            except (IndexError, ValueError):
                raise SystemExit(
                    "--threshold needs a numeric value (e.g. "
                    "--threshold 0.1)") from None
            del argv[i:i + 2]
        if len(argv) != 2:
            raise SystemExit(
                "usage: python -m sparse_coding_tpu_torch.obs.report --diff "
                "<run_a> <run_b> [--threshold 0.1] [--json]")
        diff = diff_reports(build_report(argv[0]), build_report(argv[1]),
                            threshold=threshold)
        print(json.dumps(diff, indent=2, default=float) if as_json
              else format_diff(diff))
        return
    if len(argv) != 1:
        raise SystemExit(
            "usage: python -m sparse_coding_tpu_torch.obs.report "
            "<run_dir|fleet_dir> [--json] | --diff <run_a> <run_b>")
    if is_fleet_dir(argv[0]):
        _print_report(build_fleet_report(argv[0]), format_fleet_report,
                      as_json)
        return
    _print_report(build_report(argv[0]), format_report, as_json)


if __name__ == "__main__":
    main()
