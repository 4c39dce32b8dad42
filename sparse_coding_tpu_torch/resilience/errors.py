"""Typed failures of the resilience layer (the port's subset of the JAX
package's ``resilience/errors.py``)."""

from __future__ import annotations

from pathlib import Path


class LedgerCorruptionError(RuntimeError):
    """A small JSON ledger (``quarantine.json``) fails its embedded payload
    digest (``resilience/manifest.py::check_payload_digest``). Atomic
    writes make torn ledgers impossible, so a mismatch means bit rot or a
    hand edit that forgot to re-digest: the reader must not act on it."""

    def __init__(self, path: str | Path, reason: str):
        super().__init__(f"ledger corrupt at {path}: {reason}")
        self.path = Path(path)
        self.reason = reason
