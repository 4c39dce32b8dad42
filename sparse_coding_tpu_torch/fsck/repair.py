"""The provably-safe repair subset (the port's copy of the JAX package's
``fsck/repair.py``, for the artifact classes the port writes).

Only findings carrying a ``repair`` action id are touched; everything
else — above all ``INCONSISTENT`` — is an operator decision, and repair
refuses it by construction (the action table has no entry that could
destroy contradictory evidence). Actions:

``debris.sweep``       unlink ``.{name}.tmp.{pid}`` debris (dead owner —
                       the committed file is complete either way)
``lease.drop``         unlink a dead pid's (or unreadable) lease file —
                       the takeover lease_state() already permits
``journal.trim_tail``  drop the unterminated final line of a JSONL file
``xcache.reconcile``   rewrite the warmup manifest keyed by each
                       descriptor's canonical JSON (bookkeeping)
``ckpt.drop_staging``  remove ``ckpt_staging/`` leftovers (the resuming
                       sweep discards them anyway)
``ckpt.fallback_prev`` remove a corrupt live ``ckpt/`` set whose
                       ``ckpt_prev/`` fallback verified sound — resume
                       then replays from the last-good set
``groups.drop_pool``   remove a ``group-<g>/`` pooled-view dir absent
                       from ``groups.json`` (a rebuild at a smaller G
                       leaves stale pools behind); the view holds only a
                       derivable manifest — the chunk bytes live in the
                       shard dirs, untouched

``crash_barrier("fsck.repair")`` fires immediately before EACH action's
durable mutation, every action is idempotent, and actions apply in
sorted order — so a SIGKILL mid-repair, a restart and a re-run converge
on the same repaired tree.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from sparse_coding_tpu_torch.fsck.findings import Finding
from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_write_bytes,
    atomic_write_text,
)
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)

register_crash_site("fsck.repair",
                    "fsck repair engine — immediately before applying one "
                    "repair action's durable mutation (fsck/repair.py); "
                    "SIGKILL here, restart, and the re-run repairs the "
                    "remainder to a bitwise-identical tree")


def _resolve(root: Path, finding: Finding) -> Path:
    p = Path(finding.path)
    return p if p.is_absolute() else root / p


def _unlink(path: Path) -> None:
    path.unlink(missing_ok=True)


def _rmtree(path: Path) -> None:
    shutil.rmtree(path, ignore_errors=True)


def _trim_tail(path: Path) -> None:
    """Keep everything through the last newline; a file with no newline
    at all becomes empty (its only line is the torn one)."""
    try:
        data = path.read_bytes()
    except OSError:
        return
    if not data or data.endswith(b"\n"):
        return
    cut = data.rfind(b"\n")
    kept = data[: cut + 1] if cut >= 0 else b""
    atomic_write_bytes(path, kept)


def _reconcile_warmup(path: Path) -> None:
    """Rewrite a warmup manifest keyed by each descriptor's canonical
    JSON, dropping entries that are not descriptors. Deterministic and
    idempotent: an already reconciled manifest is not rewritten."""
    try:
        old = json.loads(path.read_text())
    except (OSError, ValueError):
        return
    if not isinstance(old, dict):
        return
    new = {json.dumps(v, sort_keys=True, default=str): v
           for v in old.values() if isinstance(v, dict)}
    if new == old:
        return
    atomic_write_text(path, json.dumps(new, sort_keys=True, default=str))


def _ckpt_set_dir(root: Path, finding: Finding, name: str) -> Path | None:
    """Walk up from the finding's path to the checkpoint-set dir called
    ``name`` (findings may point at a file inside the set)."""
    p = _resolve(root, finding)
    for cand in (p, *p.parents):
        if cand.name == name:
            return cand
    return None


def repair_findings(root: str | Path,
                    findings: list[Finding]) -> list[dict]:
    """Apply every finding's named repair action; returns the applied
    action list (sorted, deduped — the report's ``repaired`` field).
    Unknown action ids are skipped loudly in the return value rather
    than raised: a newer scanner must never brick an older repairer."""
    root = Path(root).resolve()
    # dedupe: several findings can demand the same mutation (e.g. every
    # corrupt file in a live ckpt set resolves to one fallback_prev)
    planned: dict[tuple[str, str], Finding] = {}
    for f in findings:
        if not f.repair:
            continue
        target = _resolve(root, f)
        if f.repair == "ckpt.fallback_prev":
            d = _ckpt_set_dir(root, f, "ckpt")
            if d is None:
                continue
            key = (f.repair, str(d))
        elif f.repair == "ckpt.drop_staging":
            d = _ckpt_set_dir(root, f, "ckpt_staging")
            if d is None:
                continue
            key = (f.repair, str(d))
        else:
            key = (f.repair, str(target))
        planned.setdefault(key, f)

    applied: list[dict] = []
    for (action, target_s), f in sorted(planned.items()):
        target = Path(target_s)
        crash_barrier("fsck.repair")
        if action == "debris.sweep" or action == "lease.drop":
            _unlink(target)
        elif action == "journal.trim_tail":
            _trim_tail(target)
        elif action == "xcache.reconcile":
            _reconcile_warmup(target)
        elif action in ("ckpt.drop_staging", "ckpt.fallback_prev",
                        "groups.drop_pool"):
            _rmtree(target)
        else:
            applied.append({"action": action, "path": f.path,
                            "applied": False,
                            "note": "unknown repair action — skipped"})
            continue
        applied.append({"action": action, "path": f.path, "applied": True})
    return sorted(applied, key=lambda a: (a["action"], a["path"]))
