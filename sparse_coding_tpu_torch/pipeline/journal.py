"""Append-only run journal: the supervisor's single source of truth (the
port's copy of the JAX package's ``pipeline/journal.py``, record for
record: the same fields, appends and torn-tail rules).

Crash-only design rule: the supervisor keeps NO state in memory that it
cannot rebuild from disk, because the supervisor itself may be SIGKILLed
between any two instructions. Every observable step transition (spawned,
done, killed, failed, hung, lease takeover) is appended here *before* the
supervisor acts on it, so a restarted supervisor replays the journal and
continues exactly where the dead one stopped.

Appends are atomic (read + append + tmp/fsync/rename via
:mod:`resilience.atomic`): a reader — including a concurrently restarted
supervisor — only ever sees a complete journal, never a torn tail line.
Journals are small (a handful of records per step), so the rewrite-append
costs nothing measurable; in exchange there is no partial-line recovery
code to test.

Truth hierarchy on restart: *artifacts beat the journal*. A "done" record
whose completion artifact is missing means the artifact's durability
raced the record — the step re-runs (it is resumable by contract); the
journal is how the supervisor explains itself, the filesystem is what it
trusts.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

from sparse_coding_tpu_torch.resilience.atomic import atomic_write_bytes


class RunJournal:
    """One journal file (``journal.jsonl``) for one pipeline run dir."""

    def __init__(self, path: str | Path, clock=time.time, run_id: str = ""):
        self.path = Path(path)
        self._clock = clock
        # journal records carry the run ID the supervisor minted,
        # joining them with the obs events and the steps' lease beats
        self.run_id = run_id
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def append(self, event: str, step: str = "", **detail) -> dict:
        rec = {"seq": self._next_seq(), "ts": self._clock(),
               "pid": os.getpid(), "event": event, "step": step}
        if self.run_id:
            rec["run"] = self.run_id
        if detail:
            rec["detail"] = detail
        existing = self.path.read_bytes() if self.path.exists() else b""
        if existing and not existing.endswith(b"\n"):
            # an operator-edited journal may lack the trailing newline; a
            # new record must never merge into (and thus corrupt) that line
            existing += b"\n"
        atomic_write_bytes(self.path,
                           existing + json.dumps(rec).encode() + b"\n")
        return rec

    def records(self) -> list[dict]:
        """All records, oldest first. Tolerant of a malformed line (cannot
        happen under the atomic append, but a journal is also an operator-
        edited artifact during incident response — never die over it).
        Unlike :meth:`scan_records` this accepts an unterminated final
        line: an operator edit may legitimately drop the trailing newline,
        and the appender must still see that record to continue seq."""
        if not self.path.exists():
            return []
        out = []
        for line in self.path.read_bytes().splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    def scan_records(self) -> tuple[list[dict], int]:
        """``(records, skipped_lines)`` under the obs event readers'
        torn-tail contract (obs/sink.py::scan_events): only newline-
        terminated, JSON-parsing dict lines count; an unterminated tail
        is skipped and counted, never folded. The distinction matters
        because a TRUNCATED json line can still parse as valid JSON
        (``{"seq": 12}`` torn to ``{"seq": 1}``) — any reader folding the
        journal into state (fleet queue replay, fsck) must use this, not
        :meth:`records`."""
        if not self.path.exists():
            return [], 0
        raw = self.path.read_bytes()
        out: list[dict] = []
        skipped = 0
        if not raw:
            return out, skipped
        lines = raw.split(b"\n")
        torn_tail = lines.pop()  # b"" when the last append committed
        if torn_tail:
            skipped += 1
        for line in lines:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                out.append(rec)
            else:
                skipped += 1
        return out, skipped

    def _next_seq(self) -> int:
        recs = self.records()
        return recs[-1]["seq"] + 1 if recs else 1

    def last_event(self, step: str) -> Optional[dict]:
        for rec in reversed(self.records()):
            if rec.get("step") == step:
                return rec
        return None

    def done_steps(self) -> set[str]:
        return {r["step"] for r in self.records()
                if r.get("event") == "step.done"}
