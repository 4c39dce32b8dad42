"""Typed failures of the resilience layer (the port's copy of the JAX
package's ``resilience/errors.py``, for what the sweep path raises).

Every hardened path converts low-level failures into one of these at its
boundary, so a caller can tell "the data is damaged" (corruption: do not
retry; fall back or quarantine) from "the operation hiccupped" (transient
I/O: bounded retry, ``resilience/retry.py``) from "we were asked to stop"
(preemption, ``resilience/preempt.py``).
"""

from __future__ import annotations

from pathlib import Path


class ResilienceError(RuntimeError):
    """Base class for typed resilience-layer failures."""


class UnknownFaultSiteError(ResilienceError, ValueError):
    """A fault or crash plan named a site no module registered. Raised when
    the plan is parsed: a typo in ``SPARSE_CODING_FAULT_PLAN`` or
    ``SPARSE_CODING_CRASH_PLAN`` would otherwise disable the injection
    without a word."""

    def __init__(self, site: str, registered, kind: str = "fault"):
        super().__init__(
            f"unknown {kind} site {site!r} (registered: {sorted(registered)})")
        self.site = site
        self.kind = kind


class ChunkCorruptionError(ResilienceError, ValueError):
    """A chunk failed its integrity check: its content digest differs from
    the one ``meta.json`` recorded, its decoded rows are not finite, or the
    file is missing or unreadable. Names the chunk, so exactly one chunk
    can be re-harvested; ``ChunkStore(quarantine_corrupt=True)`` readers
    skip it."""

    def __init__(self, chunk_index: int, path: str | Path, reason: str):
        super().__init__(f"chunk {chunk_index} ({path}): {reason}")
        self.chunk_index = int(chunk_index)
        self.path = Path(path)
        self.reason = reason


class CheckpointCorruptionError(ResilienceError):
    """A checkpoint payload fails the digest its sidecar recorded, or does
    not load. ``train/sweep.py::resume_sweep_state`` falls back to the
    ``ckpt_prev/`` set."""

    def __init__(self, path: str | Path, reason: str):
        super().__init__(f"checkpoint corrupt at {path}: {reason}")
        self.path = Path(path)
        self.reason = reason


class LedgerCorruptionError(ResilienceError):
    """A small JSON ledger (``quarantine.json``, ``guardian.json``) fails
    its embedded payload digest (``resilience/manifest.py::
    check_payload_digest``). Atomic writes make torn ledgers impossible,
    so a mismatch means bit rot or a hand edit that forgot to re-digest:
    the reader must not act on it."""

    def __init__(self, path: str | Path, reason: str):
        super().__init__(f"ledger corrupt at {path}: {reason}")
        self.path = Path(path)
        self.reason = reason


class UndersizedInputError(ResilienceError, ValueError):
    """A streaming statistic consumed no complete batch (the input is
    smaller than the batch size), so its result would be a silent NaN."""

    def __init__(self, reason: str):
        super().__init__(reason)


class DivergenceHaltError(ResilienceError):
    """The training guardian spent its rollback ladder: a rollback was
    demanded again at a site that already rolled back, or past the run's
    budget (``train/guardian.py``). ``diagnosis`` is the triage fork:

    - ``"poisoned-data"``: non-finite activations keep reaching the step;
      scrub or re-harvest the store before re-running;
    - ``"hyperparameter"``: members keep diverging on inputs the sentinel
      proved finite; shrink the lr/l1 corners of the grid.
    """

    def __init__(self, site: str, diagnosis: str, detail: str = ""):
        super().__init__(
            f"sweep halted by the guardian at {site}: {diagnosis}"
            + (f" ({detail})" if detail else ""))
        self.site = site
        self.diagnosis = diagnosis
        self.detail = detail
