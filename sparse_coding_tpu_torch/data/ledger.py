"""Durable quarantine ledger for chunk folders (the JAX package's
``data/ledger.py``, same file format).

A reader that finds a corrupt chunk records it in ``quarantine.json`` next
to ``meta.json``: one entry per chunk index, rewritten atomically on every
change and loaded when a ``ChunkStore`` opens, so a fresh process starts
already knowing which chunks are bad. Entries hold the failure ``reason``
and the chunk's file NAME (never an absolute path), and the payload embeds
its own digest; keys are sorted, so the same entries give byte-identical
files on either side. The rewrite carries the fault site
``ledger.write``: ``ChunkStore._quarantine`` degrades to an in-memory
quarantine when it fails.
"""

from __future__ import annotations

import json
from pathlib import Path

from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.resilience.errors import LedgerCorruptionError
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.resilience.manifest import (
    check_payload_digest,
    embed_payload_digest,
)

LEDGER_NAME = "quarantine.json"

register_fault_site("ledger.write",
                    "durable quarantine-ledger rewrite (data/ledger.py "
                    "record_quarantine) — ChunkStore._quarantine degrades "
                    "to in-memory-only on failure")


def ledger_path(folder: str | Path) -> Path:
    return Path(folder) / LEDGER_NAME


def load_quarantine(folder: str | Path) -> dict[int, dict]:
    """``{chunk_index: {"reason": ..., "file": ...}}`` from the folder's
    ledger; ``{}`` when it is missing or unreadable. A ledger that parses
    but fails its embedded digest raises :class:`LedgerCorruptionError`:
    acting on it could un-hole a poisoned chunk."""
    path = ledger_path(folder)
    try:
        raw = json.loads(path.read_text())
        chunks = {int(k): dict(v) for k, v in raw.get("chunks", {}).items()}
    except (OSError, ValueError, TypeError, AttributeError):
        return {}
    if check_payload_digest(raw) == "mismatch":
        raise LedgerCorruptionError(path, "payload digest mismatch")
    return chunks


def record_quarantine(folder: str | Path, chunk_index: int, reason: str,
                      file_name: str = "") -> dict[int, dict]:
    """Add (or overwrite) one entry and rewrite the ledger atomically;
    returns the updated map. The same entry written twice gives
    byte-identical ledgers."""
    folder = Path(folder)
    entries = load_quarantine(folder)
    entries[int(chunk_index)] = {"reason": str(reason),
                                 "file": str(file_name)}
    _rewrite(folder, entries)
    return entries


def clear_quarantine(folder: str | Path,
                     chunk_index: int) -> dict[int, dict]:
    """Drop one entry (the chunk healed). When the last entry goes, the
    ledger file goes too. Clearing an absent entry is a no-op. Returns the
    updated map."""
    folder = Path(folder)
    entries = load_quarantine(folder)
    if entries.pop(int(chunk_index), None) is not None:
        _rewrite(folder, entries)
    return entries


def _rewrite(folder: Path, entries: dict[int, dict]) -> None:
    path = ledger_path(folder)
    if not entries:
        path.unlink(missing_ok=True)
        return
    payload = embed_payload_digest(
        {"version": 1,
         "chunks": {str(k): entries[k] for k in sorted(entries)}})
    fault_point("ledger.write")
    atomic_write_text(path, json.dumps(payload, indent=2, sort_keys=True))
