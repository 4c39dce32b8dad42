"""Named crash barriers: deterministic whole-process SIGKILL (the port's
copy of the JAX package's ``resilience/crash.py``).

A ``crash_barrier(site)`` call sits right after (or between) the durable
effects whose order a recovery depends on. A :class:`CrashPlan` —
installed in code or through ``SPARSE_CODING_CRASH_PLAN`` (the grammar of
``SPARSE_CODING_FAULT_PLAN``, keys ``nth`` and ``count`` only) — SIGKILLs
the process at exactly the Nth hit of a site: no ``atexit``, no buffers
flushed, no ``finally`` — the honest model of ``kill -9``, an OOM kill or
a power cut.

The port's sites:

====================  =====================================================
``chunk.flushed``     ChunkWriter._write — a chunk file and its digest just
                      became durable
``store.finalize``    ChunkWriter.finalize — every chunk durable, meta.json
                      (the completeness marker) not yet written
``sweep.chunk``       train/sweep.py — the end of one chunk's training,
                      checkpoint and artifact block
``ckpt.swap``         train/sweep.py _swap_in_checkpoint_set — ckpt/ renamed
                      to ckpt_prev/, the new set not yet renamed in
``guardian.rollback`` train/guardian.py — incident ledger and chunk
                      quarantine durable, the restore not yet performed
====================  =====================================================

Hits count per process: a resumed process starts fresh counters.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from dataclasses import dataclass, field
from typing import Optional

from sparse_coding_tpu_torch.resilience.errors import UnknownFaultSiteError
from sparse_coding_tpu_torch.resilience.faults import parse_plan_entries

ENV_VAR = "SPARSE_CODING_CRASH_PLAN"

# site name -> one-line description; hosts add theirs via register_crash_site
CRASH_SITES: dict[str, str] = {
    "chunk.flushed": "a chunk file + digest just became durable "
                     "(ChunkWriter._write)",
    "store.finalize": "all chunks durable, meta.json not yet written "
                      "(ChunkWriter.finalize)",
    "sweep.chunk": "end of one sweep chunk's train+checkpoint+artifact block",
    "ckpt.swap": "mid checkpoint-set swap: old set renamed to ckpt_prev/, "
                 "new set not yet renamed in",
    "guardian.rollback": "guardian incident ledger + chunk quarantine "
                         "durable, the last-good checkpoint restore not "
                         "yet performed (train/guardian.py)",
}


def register_crash_site(name: str, description: str) -> str:
    """Register a crash site (host modules call this at import)."""
    CRASH_SITES[name] = description
    return name


@dataclass(frozen=True)
class CrashSpec:
    """SIGKILL the process on hits ``nth .. nth+count-1`` of ``site``."""

    site: str
    nth: int = 1
    count: int = 1

    def __post_init__(self):
        if self.site not in CRASH_SITES:
            raise UnknownFaultSiteError(self.site, CRASH_SITES, kind="crash")
        if self.nth < 1:
            raise ValueError("nth is 1-based and must be >= 1")
        if self.count < 0:
            raise ValueError("count must be >= 0 (0 = every hit from nth)")

    def fires_on(self, hit: int) -> bool:
        if hit < self.nth:
            return False
        return self.count == 0 or hit < self.nth + self.count


@dataclass
class CrashPlan:
    """Installed :class:`CrashSpec`s with per-site hit counters."""

    specs: list[CrashSpec] = field(default_factory=list)
    hits: dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def hit(self, site: str) -> Optional[CrashSpec]:
        with self._lock:
            n = self.hits.get(site, 0) + 1
            self.hits[site] = n
            for spec in self.specs:
                if spec.site == site and spec.fires_on(n):
                    return spec
        return None


def parse_crash_plan(text: str) -> CrashPlan:
    """The fault-plan grammar with keys ``nth``/``count``; an unknown site
    raises :class:`UnknownFaultSiteError` at once."""
    entries = parse_plan_entries(text, keys=("nth", "count"),
                                 int_keys=("nth", "count"),
                                 label="crash-plan")
    return CrashPlan(specs=[CrashSpec(**e) for e in entries])


_active: Optional[CrashPlan] = None
_env_checked = False
_install_lock = threading.Lock()


def active_crash_plan() -> Optional[CrashPlan]:
    """The installed plan; parses ``SPARSE_CODING_CRASH_PLAN`` once if
    nothing was installed in code."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        with _install_lock:
            if _active is None and not _env_checked:
                text = os.environ.get(ENV_VAR, "").strip()
                if text:
                    _active = parse_crash_plan(text)
                _env_checked = True
    return _active


def install_crash_plan(plan: Optional[CrashPlan]) -> Optional[CrashPlan]:
    """Install (or with None clear) the active plan; returns the previous
    one."""
    global _active, _env_checked
    with _install_lock:
        prev, _active = _active, plan
        _env_checked = True
    return prev


def _kill_self(site: str) -> None:  # monkeypatchable in unit tests
    # best effort: SIGKILL leaves no other chance for a breadcrumb
    try:
        sys.stderr.write(f"crash_barrier: SIGKILL at site {site!r}\n")
        sys.stderr.flush()
    except Exception:
        pass
    os.kill(os.getpid(), signal.SIGKILL)


def crash_barrier(site: str) -> None:
    """No-op without an active plan; SIGKILLs the process when the plan
    covers this hit."""
    plan = active_crash_plan()
    if plan is None:
        return
    if plan.hit(site) is not None:
        _kill_self(site)
