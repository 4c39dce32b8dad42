"""Durable perf ledger: one JSONL row per measurement (the port's copy of
the JAX package's ``obs/ledger.py``, row for row).

The pipeline supervisor appends one summary row per completed run, and
``obs.report --diff`` reads the rows back beside the per-run reports.

Row schema (``kind`` discriminates):

    {"kind": "bench" | "suite" | "run", "ts": <unix>, "run": <run id>,
     "backend": "cuda" | "cpu", "variant": {...} | str,
     "mfu": float | None, "value": float, "unit": str,
     "paths": {<kernel path>: count, ...},       # the run's path mix
     "step_wall_p50_s": float | None, ...}       # free-form extras ride

Rows append through one ``O_APPEND`` write of a full line and an fsync
(safe across processes: the steps and the supervisor share the file),
behind the fault site ``obs.ledger.append``: a failing append drops that
row, counts ``obs.ledger.dropped`` and returns False — bookkeeping never
fails a run. Readers skip a torn tail as the event sink's do.

Path: ``SPARSE_CODING_PERF_LEDGER`` wins; else
``<default_dir>/perf_ledger.jsonl`` when a caller anchors one (the
supervisor anchors its run dir); else the repo root's.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

from sparse_coding_tpu_torch.obs.registry import get_registry
from sparse_coding_tpu_torch.obs.sink import scan_events
from sparse_coding_tpu_torch.resilience.faults import fault_point, register_fault_site

ENV_LEDGER = "SPARSE_CODING_PERF_LEDGER"
LEDGER_NAME = "perf_ledger.jsonl"
SITE = "obs.ledger.append"

register_fault_site(SITE, "perf-ledger row append (obs/ledger.py)")

_REPO_ROOT = Path(__file__).resolve().parents[2]


def ledger_path(default_dir: Optional[str | Path] = None) -> Path:
    """The ledger file this process should append to: the env override
    (the supervisor propagates one per run), else ``default_dir``'s, else
    the repo-root cross-round ledger."""
    env = os.environ.get(ENV_LEDGER, "").strip()
    if env:
        return Path(env)
    if default_dir is not None:
        return Path(default_dir) / LEDGER_NAME
    return _REPO_ROOT / LEDGER_NAME


def append_row(row: dict, path: Optional[str | Path] = None) -> bool:
    """Append one row (``ts`` stamped if absent) as a single atomic
    O_APPEND line+fsync. Returns False — counting ``obs.ledger.dropped``
    — on any failure; never raises into the measurement it records."""
    target = Path(path) if path is not None else ledger_path()
    record = dict(row)
    record.setdefault("ts", time.time())
    try:
        data = (json.dumps(record, default=repr) + "\n").encode()
        target.parent.mkdir(parents=True, exist_ok=True)
        fault_point(SITE)
        fd = os.open(str(target), os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                     0o644)
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
    except Exception:  # noqa: BLE001 — bookkeeping is never fatal
        get_registry().counter("obs.ledger.dropped").inc()
        return False
    return True


def read_rows(path: Optional[str | Path] = None) -> list[dict]:
    """All readable rows (torn tail / corrupt lines skipped by the event
    sink's reader contract)."""
    target = Path(path) if path is not None else ledger_path()
    return scan_events(target)[0]


def run_summary_row(report: dict, run_id: str = "",
                    kind: str = "run") -> dict:
    """One supervisor summary row distilled from a ``build_report`` dict:
    the run's MFU gauges, kernel-path mix, and step walls — the shape
    ``obs.report --diff`` compares between runs."""
    gauges = report.get("gauges", {})
    mfu = {name: g.get("value") for name, g in gauges.items()
           if name == "train.mfu" or name.startswith("train.mfu{")
           or name == "serve.mfu" or name.startswith("serve.mfu{")}
    paths = {p: ent.get("count", 0)
             for p, ent in report.get("kernel_paths", {}).items()}
    chunk = report.get("spans", {}).get("sweep.chunk", {})
    return {"kind": kind, "run": run_id or ",".join(report.get("run_ids", [])),
            "mfu": mfu, "paths": paths,
            "step_wall_p50_s": chunk.get("p50_s"),
            "events": report.get("events", 0)}
