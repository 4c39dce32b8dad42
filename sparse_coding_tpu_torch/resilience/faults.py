"""Deterministic fault injection: named sites, Nth-hit trigger plans (the
port's copy of the JAX package's ``resilience/faults.py``, same grammar).

Every failure-prone operation on the sweep path calls
``fault_point(site, payload)``; a :class:`FaultPlan` — installed in code
(:class:`inject`) or through ``SPARSE_CODING_FAULT_PLAN`` — fires a chosen
fault on exactly the Nth hit of a site. Counting is per plan and under a
lock, so a plan replays identically across runs and threads.

The port's sites (pre-registered here, so an environment plan validates
before the host modules import):

====================  =====================================================
``chunk.read``        ChunkStore.load_chunk — every chunk load
``chunk.write``       ChunkWriter._write — every chunk flush
``ckpt.save``         utils/checkpoint.py save_ensemble
``ckpt.restore``      utils/checkpoint.py restore_ensemble
``ledger.write``      data/ledger.py — the quarantine-ledger rewrite
``ingest.decode``     data/ingest.py chunk_stream — each stream decode
``sweep.anomaly``     train/guardian.py — every host batch of the sweep
                      (mode=nan: a non-finite-input incident; mode=error
                      with message ``member=<i>``: a member divergence)
``obs.sink.write``    obs/sink.py — every event line append
====================  =====================================================

Plan syntax: compact ``site:key=val,key=val`` entries joined by ``;``, or
a JSON list of objects with the same keys. Keys: ``nth`` (1-based first
hit that fires, default 1), ``count`` (consecutive hits that fire,
default 1; 0 = every hit from nth on), ``mode`` (``error`` raises;
``corrupt`` flips one bit of an array or bytes payload; ``nan`` writes one
NaN into a float payload), ``error`` (exception class for mode=error),
``message``, ``seed`` (selects the byte or element for corrupt/nan).
Payloads are numpy arrays, bytes, or torch tensors (the bfloat16 batches
of ``train_dtype="bfloat16"``).

Injected exceptions subclass both the requested builtin (so real handlers
treat them as the genuine failure) and :class:`InjectedFault` (so a test
can tell the failure was injected).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from sparse_coding_tpu_torch.resilience.errors import UnknownFaultSiteError

ENV_VAR = "SPARSE_CODING_FAULT_PLAN"

# site name -> one-line description; hosts add theirs via register_fault_site
FAULT_SITES: dict[str, str] = {
    "chunk.read": "chunk store read",
    "chunk.write": "chunk store write/flush",
    "ckpt.save": "checkpoint save",
    "ckpt.restore": "checkpoint restore",
    "ledger.write": "quarantine-ledger rewrite (data/ledger.py)",
    "ingest.decode": "async ingest stream decode (data/ingest.py)",
    "sweep.anomaly": "training-batch anomaly injection in the sweep hot "
                     "loop (train/guardian.py)",
    "obs.sink.write": "observability event-sink line append (obs/sink.py)",
}


def register_fault_site(name: str, description: str) -> str:
    """Register a fault site (host modules call this at import)."""
    FAULT_SITES[name] = description
    return name


class InjectedFault(Exception):
    """Marker base of every exception that fault injection raises."""


_ERROR_BASES: dict[str, type] = {
    "OSError": OSError,
    "IOError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "MemoryError": MemoryError,
}
_injected_types: dict[type, type] = {}


def _injected_type(base: type) -> type:
    t = _injected_types.get(base)
    if t is None:
        t = type(f"Injected{base.__name__}", (InjectedFault, base), {})
        _injected_types[base] = t
    return t


@dataclass(frozen=True)
class FaultSpec:
    """One fault: fires on hits ``nth .. nth+count-1`` of ``site``."""

    site: str
    nth: int = 1
    count: int = 1
    mode: str = "error"  # "error" | "corrupt" | "nan"
    error: str = "OSError"
    message: str = "injected fault"
    seed: int = 0

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise UnknownFaultSiteError(self.site, FAULT_SITES, kind="fault")
        if self.mode not in ("error", "corrupt", "nan"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.mode == "error" and self.error not in _ERROR_BASES:
            raise ValueError(
                f"unknown error type {self.error!r} "
                f"(supported: {sorted(_ERROR_BASES)})")
        if self.nth < 1:
            raise ValueError("nth is 1-based and must be >= 1")
        if self.count < 0:
            raise ValueError("count must be >= 0 (0 = every hit from nth)")

    def fires_on(self, hit: int) -> bool:
        if hit < self.nth:
            return False
        return self.count == 0 or hit < self.nth + self.count

    def build_error(self) -> BaseException:
        return _injected_type(_ERROR_BASES[self.error])(
            f"{self.message} [site={self.site}]")


@dataclass
class FaultPlan:
    """Installed :class:`FaultSpec`s with per-site hit counters; ``fired``
    records every (site, hit) that triggered."""

    specs: list[FaultSpec] = field(default_factory=list)
    hits: dict[str, int] = field(default_factory=dict)
    fired: list[tuple[str, int]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def hit(self, site: str) -> Optional[FaultSpec]:
        with self._lock:
            n = self.hits.get(site, 0) + 1
            self.hits[site] = n
            for spec in self.specs:
                if spec.site == site and spec.fires_on(n):
                    self.fired.append((site, n))
                    return spec
        return None


_active: Optional[FaultPlan] = None
_env_checked = False
_install_lock = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    """The installed plan; parses ``SPARSE_CODING_FAULT_PLAN`` once if
    nothing was installed in code."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        with _install_lock:
            if _active is None and not _env_checked:
                text = os.environ.get(ENV_VAR, "").strip()
                if text:
                    _active = parse_fault_plan(text)
                _env_checked = True
    return _active


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or with None clear) the active plan; returns the previous
    one. An explicit install wins over the environment."""
    global _active, _env_checked
    with _install_lock:
        prev, _active = _active, plan
        _env_checked = True
    return prev


class inject:
    """Context manager: install a plan for the block, restore the previous
    one after. ``inject(FaultSpec(...), ...)`` or, for one spec,
    ``inject(site="chunk.read", nth=2)``; the plan is the ``as`` target."""

    def __init__(self, *specs: FaultSpec, **one_spec):
        if one_spec:
            specs = specs + (FaultSpec(**one_spec),)
        self.plan = FaultPlan(specs=list(specs))
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self._prev = install_plan(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        install_plan(self._prev)


def _copy(payload, spec: FaultSpec):
    if payload is None:
        raise ValueError(
            f"fault site {spec.site!r} carries no payload; mode={spec.mode} "
            "is only valid at data-bearing sites (use mode=error)")
    if isinstance(payload, (bytes, bytearray)):
        return bytearray(payload)
    if hasattr(payload, "clone"):  # a torch tensor
        return payload.clone()
    return np.array(payload, copy=True)


def _corrupt_payload(payload, spec: FaultSpec):
    """Flip one bit of a bytes, array or tensor payload; ``seed`` selects
    the byte."""
    out = _copy(payload, spec)
    if isinstance(out, bytearray):
        out[spec.seed % len(out)] ^= 0x01
        return bytes(out)
    if hasattr(out, "clone"):
        import torch

        flat = out.reshape(-1).view(torch.uint8)
        flat[spec.seed % flat.numel()] ^= 0x01
    else:
        flat = out.view(np.uint8).reshape(-1)
        flat[spec.seed % flat.size] ^= 0x01
    return out


def _nan_payload(payload, spec: FaultSpec):
    """Overwrite one float element with NaN (``seed`` selects it): a bit
    flip gives a wrong but usually finite value, while finite guards need a
    certain non-finite one."""
    out = _copy(payload, spec)
    if isinstance(out, bytearray) or not (
            out.is_floating_point() if hasattr(out, "clone")
            else np.issubdtype(out.dtype, np.floating)):
        raise ValueError(
            f"fault site {spec.site!r} payload cannot hold NaN; mode=nan "
            "needs a float-array payload")
    flat = out.reshape(-1)
    flat[spec.seed % flat.shape[0]] = float("nan")
    return out


def fault_point(site: str, payload=None):
    """The injection hook every hardened path calls. Returns the payload
    (a mutated copy when a corrupt- or nan-mode fault fires, so a caller
    can tell by identity) or raises an error-mode fault. Costs one check
    when no plan is active."""
    plan = active_plan()
    if plan is None:
        return payload
    spec = plan.hit(site)
    if spec is None:
        return payload
    if spec.mode == "error":
        raise spec.build_error()
    if spec.mode == "nan":
        return _nan_payload(payload, spec)
    return _corrupt_payload(payload, spec)


def parse_plan_entries(text: str, keys: Sequence[str],
                       int_keys: Sequence[str],
                       label: str = "fault-plan") -> list[dict]:
    """The plan grammar shared with ``SPARSE_CODING_CRASH_PLAN`` (a JSON
    list, or compact ``site:key=val,...;...``) → spec-kwargs dicts."""
    text = text.strip()
    if text.startswith("[") or text.startswith("{"):
        raw = json.loads(text)
        if isinstance(raw, dict):
            raw = [raw]
        return [dict(entry) for entry in raw]
    entries: list[dict] = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, _, rest = entry.partition(":")
        kwargs: dict = {"site": site.strip()}
        for pair in filter(None, (p.strip() for p in rest.split(","))):
            key, sep, val = pair.partition("=")
            if not sep or key not in keys:
                raise ValueError(
                    f"bad {label} pair {pair!r} in entry {entry!r} "
                    f"(expected key=value with key in {'/'.join(keys)})")
            kwargs[key] = int(val) if key in int_keys else val
        entries.append(kwargs)
    return entries


def parse_fault_plan(text: str) -> FaultPlan:
    """The environment/CLI plan syntax → a validated plan; an unknown site
    raises :class:`UnknownFaultSiteError` at once."""
    entries = parse_plan_entries(
        text, keys=("nth", "count", "mode", "error", "message", "seed"),
        int_keys=("nth", "count", "seed"), label="fault-plan")
    return FaultPlan(specs=[FaultSpec(**e) for e in entries])
