"""Finding taxonomy + the byte-deterministic fsck report (the port's copy
of the JAX package's ``fsck/findings.py``: the same kinds, fields and
report bytes).

A finding is one observed defect in the durable tree, typed by what it
MEANS for a resume:

``MISSING``
    An artifact a completion marker certifies (a chunk in ``meta.json``,
    a shard in the store manifest, a ``.npy`` in the catalog index) is
    absent. The marker promised completeness, so nothing will regenerate
    it — fatal.
``CORRUPT``
    Damage with a safe fallback or regeneration path: a corrupt live
    checkpoint set with a sound ``ckpt_prev/`` retained (the sweep's own
    fallback), an unreadable warmup manifest (the next warm start
    captures cold), an unreadable diagnostic file. Usually repairable.
``TORN``
    An unterminated JSONL tail — the SIGKILL-mid-append instant. Readers
    already skip it by contract (obs/sink.py); the repair trims it so a
    truncated-but-parsing line can never poison a fold.
``ORPHAN``
    Bytes nothing references: ``.tmp.<pid>`` debris from a SIGKILLed
    atomic write (dead owner), ``ckpt_staging/`` leftovers, chunk and
    array files no completion marker lists. Deleting them is provably
    safe.
``STALE``
    Benign bookkeeping drift: a dead pid's lease, a digest-less legacy
    ledger, a journal "done" whose artifact vanished (the step is
    resumable by contract and simply re-runs).
``INCONSISTENT``
    Two durable artifacts contradict with no safe automatic resolution
    (chunk bytes vs their recorded digest, both checkpoint sets corrupt,
    a seal not matching its manifest, a ledger failing its embedded
    payload digest). Always fatal: a resume over it could silently
    diverge, which is the one outcome fsck exists to forbid.

``fatal=True`` means the supervisor's resume preflight must halt typed
rather than admit work; ``repair`` names the provably-safe action
(``fsck/repair.py``) or is empty when only an operator can decide.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

MISSING = "MISSING"
CORRUPT = "CORRUPT"
TORN = "TORN"
ORPHAN = "ORPHAN"
STALE = "STALE"
INCONSISTENT = "INCONSISTENT"

FINDING_KINDS = (MISSING, CORRUPT, TORN, ORPHAN, STALE, INCONSISTENT)


@dataclass(frozen=True, order=True)
class Finding:
    """One defect: ``path`` is relative to the scan root where possible
    (posix), absolute otherwise — never host-random, so a report over
    the same tree state is byte-identical."""

    path: str
    artifact_class: str
    kind: str
    detail: str
    repair: str = ""          # repair-action id, "" = not auto-repairable
    fatal: bool = False

    def __post_init__(self):
        if self.kind not in FINDING_KINDS:
            raise ValueError(f"unknown finding kind {self.kind!r}")


@dataclass
class Report:
    """One scan's outcome. ``findings`` are sorted and deduped;
    ``repaired`` lists the actions an immediately-preceding repair pass
    applied (empty for a plain scan)."""

    root: str
    findings: list[Finding] = field(default_factory=list)
    repaired: list[dict] = field(default_factory=list)

    @property
    def fatal(self) -> list[Finding]:
        return [f for f in self.findings if f.fatal]

    @property
    def repairable(self) -> list[Finding]:
        return [f for f in self.findings if f.repair]

    @property
    def clean(self) -> bool:
        return not self.findings

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def to_payload(self) -> dict:
        return {
            "version": 1,
            "root": self.root,
            "clean": self.clean,
            "counts": {k: v for k, v in sorted(self.counts().items())},
            "n_fatal": len(self.fatal),
            "findings": [asdict(f) for f in self.findings],
            "repaired": list(self.repaired),
        }

    def to_json(self) -> str:
        # deterministic bytes: sorted findings (dataclass order), sorted
        # keys, no timestamps/pids — two scans of the same tree state
        # produce identical reports, which the chaos matrix compares on
        return json.dumps(self.to_payload(), indent=2, sort_keys=True)


def finalize_findings(findings: list[Finding]) -> list[Finding]:
    """Sorted, deduped finding list (checkers may legitimately observe
    the same defect from two directions, e.g. a shard's meta both as a
    seal mismatch and a store-manifest mismatch)."""
    return sorted(set(findings))
