"""Training health guardian: divergence quarantine and last-good rollback
(the port's copy of the JAX package's ``train/guardian.py``).

The in-step sentinel (``ensemble.py``) detects and contains numerical
failure on the device: a member whose step went non-finite keeps its
params bit for bit, and the per-member ``finite``, ``grad_norm`` and
batch-level ``inputs_finite`` flags ride the aux. This module is the host
half of the ladder:

1. **Member quarantine.** A member that went non-finite on finite inputs
   has diverged: its live bit is cleared (``Ensemble.freeze_members``),
   the incident goes into ``guardian.json`` beside the checkpoints
   (atomic, digest-embedded), and its artifacts are tagged
   ``diverged=True``.
2. **Rollback.** Non-finite inputs, or a quarantined share of members at
   or above ``member_fraction``, make the incident and a chunk quarantine
   durable first (the store's ledger turns the chunk into a positional
   hole); the ``guardian.rollback`` crash barrier sits between that and
   the restore of the last-good checkpoint set, and the sweep replays —
   bitwise the run that never saw the chunk.
3. **Halt.** A rollback demanded again at a site that already rolled
   back, or past the budget, raises :class:`DivergenceHaltError` with the
   diagnosis ``poisoned-data`` or ``hyperparameter``.

The per-window accumulation is one small device combine (no host sync);
the chunk boundary pulls it once. The drill site ``sweep.anomaly``
poisons a batch (mode=nan) or member ``i``'s loss scale (mode=error,
message ``member=<i>``). On a mesh every rank runs the ladder on the
same gathered aux; the decisions that lead into collectives (an input
incident, a fraction breach, before and after a quarantine-free chunk)
are agreed by every rank (``parallel.agree_any``), and rank 0 alone
writes the ledger, as process 0 does in the JAX package.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.parallel import agree_any
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.errors import (
    ChunkCorruptionError,
    DivergenceHaltError,
    LedgerCorruptionError,
)
from sparse_coding_tpu_torch.resilience.faults import (
    InjectedFault,
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.resilience.manifest import (
    check_payload_digest,
    embed_payload_digest,
)

LEDGER_NAME = "guardian.json"

register_fault_site("sweep.anomaly",
                    "training-batch anomaly injection — every host batch "
                    "passes through this site in the sweep hot loop "
                    "(train/guardian.py inject_anomaly); mode=nan poisons "
                    "the batch (non-finite-input incident), mode=error "
                    "with message member=<i> poisons that member's "
                    "loss-scale buffer (per-member divergence drill)")
register_crash_site("guardian.rollback",
                    "guardian incident ledger + chunk quarantine durable, "
                    "the last-good checkpoint restore not yet performed "
                    "(train/guardian.py rollback_restore)")

_MEMBER_RE = re.compile(r"member=(\d+)")


class GuardianRollback(Exception):
    """Control flow: the guardian decided to roll back. ``train/sweep.py``
    catches it at the chunk loop, restores through
    :meth:`Guardian.rollback_restore` and replays; it never escapes
    ``sweep()``."""

    def __init__(self, site: str, incident: str, chunk_pos: int,
                 chunk_index: int):
        super().__init__(
            f"guardian rollback at {site}: {incident} "
            f"(chunk {chunk_index} quarantined)")
        self.site = site
        self.incident = incident
        self.chunk_pos = int(chunk_pos)
        self.chunk_index = int(chunk_index)


def _writes_ledger() -> bool:
    """Rank 0 of a world (or the one process) owns the ledger file: the
    decisions are replicated, so one writer keeps its bytes whole."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _reduce_leading(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce leading (``run_steps`` window) axes down to the member
    axis."""
    while x.dim() > 1:
        x = op(x, dim=0)
    return x


def _combine(acc, finite, grad_norm, inputs_finite):
    """One window folded into a bucket's device accumulator (finite_all
    [N], inputs_all scalar, grad_norm_max [N]); no host sync."""
    f = _reduce_leading(finite, torch.all)
    g = _reduce_leading(grad_norm, torch.amax)
    i = (torch.all(inputs_finite) if inputs_finite is not None
         else torch.ones((), dtype=torch.bool, device=f.device))
    if acc is None:
        return f, i, g
    return acc[0] & f, acc[1] & i, torch.maximum(acc[2], g)


class Guardian:
    """Host-side divergence bookkeeping for one sweep run.

    ``ensembles`` is the sweep's ``[(Ensemble | EnsembleGroup, hypers,
    name)]``; a group's members are keyed by bucket, as in the JAX
    guardian. ``member_names`` the per-entry stream names (the ledger's readable
    ``member`` field). State lives in ``<out_dir>/guardian.json``,
    written atomically with sorted keys and no clock fields, so an
    interrupted and resumed incident leaves a ledger byte-identical to an
    uninterrupted one."""

    def __init__(self, out_dir: str | Path, ensembles: Sequence,
                 member_names: Sequence[Sequence[str]],
                 member_fraction: float = 0.5,
                 rollback_budget: int = 4,
                 fresh: bool = False):
        self.path = Path(out_dir) / LEDGER_NAME
        self.ensembles = list(ensembles)
        self.member_names = [list(n) for n in member_names]
        self.member_fraction = float(member_fraction)
        self.rollback_budget = int(rollback_budget)
        self._acc: dict = {}  # (ens_idx, sub_name) -> device accumulator
        if fresh:
            # a non-resume run into a reused out_dir starts over, like its
            # checkpoints; a resume keeps the ledger
            if _writes_ledger():
                self.path.unlink(missing_ok=True)
            self._state = _empty_ledger()
        else:
            self._state = self._load()

    # -- ledger ---------------------------------------------------------------

    def _load(self) -> dict:
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return _empty_ledger()
        if isinstance(raw, dict) and raw.get("version") == 1:
            # a parse-able ledger failing its digest could halt a healthy
            # run or trust a diverged member: typed, never silent
            if check_payload_digest(raw) == "mismatch":
                raise LedgerCorruptionError(self.path,
                                            "payload digest mismatch")
            raw.pop("payload_sha256", None)
            raw.setdefault("members", {})
            raw.setdefault("rollbacks", {})
            return raw
        return _empty_ledger()

    def _write(self) -> None:
        if not _writes_ledger():
            return
        atomic_write_text(
            self.path,
            json.dumps(embed_payload_digest(self._state), indent=2,
                       sort_keys=True))

    def total_rollbacks(self) -> int:
        return sum(rb["count"] for rb in self._state["rollbacks"].values())

    # -- injection drill ------------------------------------------------------

    def inject_anomaly(self, batch):
        """Fault site ``sweep.anomaly``: every host batch passes through.
        mode=nan returns a NaN-poisoned copy; mode=error naming
        ``member=<i>`` poisons that member's loss scale instead (its loss
        and grads go NaN, its params stay finite). Any other error-mode
        injection propagates."""
        try:
            return fault_point("sweep.anomaly", batch)
        except InjectedFault as e:
            m = _MEMBER_RE.search(str(e))
            if m is None:
                raise
            self._poison_member(int(m.group(1)))
            return batch

    def _poison_member(self, index: int) -> None:
        """Member ``index`` of the first bucket of the first sweep entry;
        out of range is a plan bug and fails loudly. On a mesh the rank
        holding the member poisons it."""
        ens = self.ensembles[0][0].buckets()[0][1]
        if not 0 <= int(index) < ens.n_members:
            raise ValueError(
                f"sweep.anomaly drill names member={index} but the first "
                f"bucket has {ens.n_members} member(s)")
        index = ens.local_index(index)
        if index is None:
            return
        state = ens.state
        if "l1_alpha" in state.buffers:
            alpha = state.buffers["l1_alpha"].clone()
            alpha[index] = float("nan")
            ens.state = state.replace(
                buffers={**state.buffers, "l1_alpha": alpha})
        else:
            # no loss scale: a NaN lr makes the member's update non-finite
            lrs = state.lrs.clone()
            lrs[index] = float("nan")
            ens.state = state.replace(lrs=lrs)

    # -- per-window observation -----------------------------------------------

    def observe(self, ens_idx: int, sub_name: str, aux) -> None:
        """Fold one window's aux into the (entry, bucket) accumulator; a
        no-op when the sentinel is off."""
        if getattr(aux, "finite", None) is None:
            return
        key = (int(ens_idx), str(sub_name))
        self._acc[key] = _combine(self._acc.get(key), aux.finite,
                                  aux.grad_norm, aux.inputs_finite)

    # -- the chunk-boundary ladder --------------------------------------------

    def check_boundary(self, chunk_pos: int, chunk_index: int,
                       store=None) -> None:
        """One host sync per chunk, then the ladder: an input incident
        (rollback), new member quarantines (freeze + ledger), a fraction
        breach (rollback). Raises :class:`GuardianRollback`, or
        :class:`DivergenceHaltError` once the ladder is spent."""
        if not self._acc:
            # nothing trained this chunk (a quarantined hole); a standing
            # fraction breach still escalates here, or a rolled-back run
            # would sail past the state it rolled back for. Agreed
            # unconditionally: every rank makes the same sequence of
            # consensus calls
            if agree_any(self._dead_fraction() >= self.member_fraction,
                         "guardian-fraction"):
                self._escalate(chunk_pos, chunk_index, "hyperparameter",
                               store)
            return
        t0 = obs.monotime()
        pulled = {k: tuple(v.cpu().numpy() for v in acc)
                  for k, acc in self._acc.items()}
        self._acc.clear()

        if agree_any(any(not bool(np.all(inputs))
                         for _, inputs, _ in pulled.values()),
                     "guardian-input"):
            self._escalate(chunk_pos, chunk_index, "poisoned-data", store)

        newly: list[tuple[int, str, int, Optional[float]]] = []
        for (ens_idx, sub), (finite, _inputs, gn) in sorted(pulled.items()):
            finite = np.asarray(finite).reshape(-1)
            gn = np.asarray(gn).reshape(-1)
            for i in np.flatnonzero(~finite):
                if self._member_key(ens_idx, sub, int(i)) in \
                        self._state["members"]:
                    continue  # already quarantined (stays non-finite)
                norm = float(gn[i]) if np.isfinite(gn[i]) else None
                newly.append((ens_idx, sub, int(i), norm))
        if newly:
            self._quarantine_members(newly, chunk_pos, chunk_index)

        if agree_any(self._dead_fraction() >= self.member_fraction,
                     "guardian-fraction"):
            self._escalate(chunk_pos, chunk_index, "hyperparameter", store)
        obs.record_span("guardian.check", obs.monotime() - t0,
                        chunk=chunk_index, pos=chunk_pos,
                        quarantined=len(newly))

    def _member_key(self, ens_idx: int, sub: str, i: int) -> str:
        name = self.ensembles[ens_idx][2]
        return f"{name}/{sub or name}/{i}"

    def dead_indices(self, ens_idx: int, sub_name: str) -> list[int]:
        """Quarantined member indices of one entry's bucket: the sweep's
        log masks them out of its aggregate streams."""
        entry_name = self.ensembles[ens_idx][2]
        bucket = sub_name or entry_name
        return sorted(info["index"]
                      for info in self._state["members"].values()
                      if info["entry"] == entry_name
                      and info["bucket"] == bucket)

    def _quarantine_members(self, newly, chunk_pos: int,
                            chunk_index: int) -> None:
        frozen = []
        for ens_idx, sub, i, norm in newly:
            entry_name = self.ensembles[ens_idx][2]
            names = (self.member_names[ens_idx]
                     if ens_idx < len(self.member_names) else [])
            key = self._member_key(ens_idx, sub, i)
            self._state["members"][key] = {
                "entry": entry_name, "bucket": sub or entry_name,
                "index": i,
                "member": names[i] if i < len(names) else f"member{i}",
                "reason": "non-finite loss/grads on finite inputs",
                "grad_norm": norm,
                "chunk_pos": chunk_pos, "chunk": chunk_index,
            }
            frozen.append(key)
        # freeze before the durable write: even a failed ledger write
        # leaves this process protected
        by_bucket: dict[tuple[int, str], list[int]] = {}
        for ens_idx, sub, i, _ in newly:
            by_bucket.setdefault((ens_idx, sub), []).append(i)
        for (ens_idx, sub), idxs in by_bucket.items():
            entry, _, entry_name = self.ensembles[ens_idx]
            for bucket, ens in entry.buckets():
                if (bucket or entry_name) == (sub or entry_name):
                    ens.freeze_members(idxs)
        self._write()
        obs.counter("guardian.members_quarantined").inc(len(newly))
        obs.emit_event("guardian.incident", incident="member-divergence",
                       members=frozen, chunk=chunk_index, pos=chunk_pos)

    def _dead_fraction(self) -> float:
        total = sum(ens.n_members for e, _, _ in self.ensembles
                    for _, ens in e.buckets())
        return len(self._state["members"]) / max(1, total)

    def _escalate(self, chunk_pos: int, chunk_index: int, incident: str,
                  store) -> None:
        """Record the rollback durably (or halt, typed, if this site
        already rolled back or the budget is spent), quarantine the chunk
        through the store's ledger, and raise the rollback."""
        site = f"chunk[{chunk_pos}]"
        rb = self._state["rollbacks"].get(site)
        if (rb is not None and rb["count"] >= 1) or \
                self.total_rollbacks() >= self.rollback_budget:
            self._state["halt"] = {"site": site, "diagnosis": incident,
                                   "chunk": chunk_index}
            self._write()
            obs.counter("guardian.halts").inc()
            obs.emit_event("guardian.halt", site=site, diagnosis=incident,
                           chunk=chunk_index)
            raise DivergenceHaltError(
                site, incident,
                detail=f"chunk {chunk_index}; "
                       f"{len(self._state['members'])} member(s) "
                       f"quarantined, {self.total_rollbacks()} rollback(s)")
        self._state["rollbacks"][site] = {
            "count": (rb["count"] + 1 if rb else 1),
            "incident": incident, "chunk": chunk_index}
        self._write()
        self._quarantine_chunk(store, chunk_index)
        obs.counter("guardian.rollbacks").inc()
        obs.emit_event("guardian.incident", incident=incident,
                       chunk=chunk_index, pos=chunk_pos, rollback=True)
        raise GuardianRollback(site, incident, chunk_pos, chunk_index)

    def _quarantine_chunk(self, store, chunk_index: int) -> None:
        if store is None:
            return
        try:
            path = store._path(chunk_index)
        except ChunkCorruptionError:
            return  # already a hole
        # every rank of a mesh records it: the store's ledger rewrite is
        # atomic per process and byte-identical for the same entry
        store._quarantine(ChunkCorruptionError(
            chunk_index, path,
            "guardian: non-finite activations reached the training step"))
        obs.counter("guardian.chunks_quarantined").inc()

    # -- rollback and resume --------------------------------------------------

    def rollback_restore(self, restore_fn: Callable[[], tuple]) -> tuple:
        """The restore half of a rollback, behind the ``guardian.rollback``
        crash barrier; ``restore_fn`` is the sweep's closure over
        ``resume_sweep_state`` (or the re-init before the first
        checkpoint). Returns its (chunks_done, rng_state)."""
        crash_barrier("guardian.rollback")
        t0 = obs.monotime()
        done, rng_state = restore_fn()
        self.refreeze()
        obs.record_span("guardian.rollback", obs.monotime() - t0,
                        chunks_done=int(done))
        return done, rng_state

    def refreeze(self) -> None:
        """Re-apply every ledgered member quarantine: a restored (or
        re-initialized) state predates the freeze."""
        for info in self._state["members"].values():
            for e, _, name in self.ensembles:
                if name != info["entry"]:
                    continue
                for bucket, ens in e.buckets():
                    if (bucket or name) == info["bucket"]:
                        ens.freeze_members([info["index"]])

    # -- artifact hygiene -----------------------------------------------------

    def diverged_flat(self, entry_name: str) -> dict[int, dict]:
        """Flat member index → ledger info for one entry, in the order the
        sweep flattens a group's dicts (buckets in insertion order)."""
        out: dict[int, dict] = {}
        for e, _, name in self.ensembles:
            if name != entry_name:
                continue
            offset = 0
            for bucket, ens in e.buckets():
                for info in self._state["members"].values():
                    if info["entry"] == name and \
                            info["bucket"] == (bucket or name):
                        out[offset + info["index"]] = info
                offset += ens.n_members
        return out

    def tag_hypers(self, entry_name: str,
                   tagged: Sequence[tuple]) -> list[tuple]:
        """[(dict, hyper)] with quarantined members' hypers carrying
        ``diverged=True`` and the ledger's reason."""
        diverged = self.diverged_flat(entry_name)
        return [(ld, {**hyper, "diverged": True,
                      "diverged_reason": diverged[i]["reason"]}
                 if i in diverged else hyper)
                for i, (ld, hyper) in enumerate(tagged)]


def _empty_ledger() -> dict:
    return {"version": 1, "members": {}, "rollbacks": {}}
