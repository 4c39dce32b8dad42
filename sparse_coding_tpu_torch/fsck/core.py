"""fsck orchestration (the port's copy of the JAX package's
``fsck/core.py``): walk → checkers → (optional) repair → re-scan →
atomic report.

The walk is deterministic (sorted dirnames and filenames, ``fsck/``
report dirs pruned so a previous report never audits itself) and every
checker sees each directory exactly once. A supervisor run dir pulls its
artifact roots in via the persisted ``pipeline.json``, so
``run_fsck(<run_dir>)`` audits the whole durable footprint of the run —
journal, leases, chunk store, checkpoints, eval and catalog outputs —
not just the journal dir. The report is written LAST, atomically, to
``<root>/fsck/report.json``; its bytes are deterministic for a given
tree state.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from sparse_coding_tpu_torch.fsck.checkers import CHECKERS, REPO_ROOT, ScanCtx
from sparse_coding_tpu_torch.fsck.findings import Report, finalize_findings
from sparse_coding_tpu_torch.fsck.repair import repair_findings
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text

REPORT_DIR = "fsck"
REPORT_NAME = "report.json"


def _walk_one(ctx: ScanCtx, root: Path) -> None:
    for dirpath, dirnames, filenames in os.walk(root, topdown=True):
        dirnames[:] = sorted(d for d in dirnames if d != REPORT_DIR)
        d = Path(dirpath)
        files, dirs = set(filenames), set(dirnames)
        for check in CHECKERS:
            check(ctx, d, files, dirs)


def scan_tree(root: str | Path, extra_roots=(),
              stale_after_s: float = 300.0) -> Report:
    """Audit ``root`` (plus any ``extra_roots`` not already under it) and
    return the finalized :class:`Report`. Read-only: repair is a
    separate, explicit pass."""
    root = Path(root).resolve()
    ctx = ScanCtx(root=root, stale_after_s=stale_after_s)
    roots = [root]
    for extra in extra_roots:
        extra = Path(extra).resolve()
        if not extra.is_dir():
            continue
        if any(extra == r or r in extra.parents for r in roots):
            continue  # already covered by an earlier root
        roots.append(extra)
    for r in roots:
        _walk_one(ctx, r)
    return Report(root=str(root),
                  findings=finalize_findings(ctx.findings))


def artifact_roots(run_dir: str | Path) -> list[Path]:
    """The artifact directories a supervisor run's persisted
    ``pipeline.json`` names (dataset, sweep output, eval output, catalog
    output), anchored the same way the supervisor anchors them (absolute
    as-is, relative against the repo root)."""
    run_dir = Path(run_dir)
    cfg_path = run_dir / "pipeline.json"
    try:
        config = json.loads(cfg_path.read_text())
    except (OSError, ValueError):
        return []
    if not isinstance(config, dict):
        return []

    def anchor(p) -> Path:
        p = Path(p)
        return p if p.is_absolute() else REPO_ROOT / p

    out: list[Path] = []
    for keys in (("harvest", "dataset_folder"),
                 ("sweep", "ensemble", "output_folder"),
                 ("eval", "output_folder"),
                 ("catalog", "output_folder")):
        node = config
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                node = None
                break
            node = node[k]
        if node is not None:
            out.append(anchor(node))
    return out


def run_fsck(root: str | Path, repair: bool = False,
             write_report: bool = True,
             stale_after_s: float = 300.0) -> Report:
    """The full pass the CLI and the supervisor's preflight share:
    scan (a run dir expands to its artifact roots), optionally apply the
    provably-safe repairs and RE-SCAN so the report describes the tree
    as it now is, then atomically write the report last."""
    root = Path(root).resolve()
    extra = artifact_roots(root) if (root / "pipeline.json").exists() else []
    report = scan_tree(root, extra_roots=extra, stale_after_s=stale_after_s)
    if repair and report.repairable:
        applied = repair_findings(root, report.findings)
        report = scan_tree(root, extra_roots=extra,
                           stale_after_s=stale_after_s)
        report.repaired = applied
    if write_report:
        out_dir = root / REPORT_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_text(out_dir / REPORT_NAME, report.to_json() + "\n")
    return report
