"""Per-artifact-class checkers: the registry the fsck walk drives (the
port's counterpart of the JAX package's ``fsck/checkers.py``).

Each checker is ``fn(ctx, d, files, dirs)`` — called once per directory
of the scan (sorted walk order) — and decides from the directory's OWN
contents whether it owns an artifact class there (``meta.json`` with
``chunk_digests`` ⇒ chunk store, ``manifest.json`` with
``kind=sharded_chunk_store`` ⇒ sharded store, ``warmup.json`` ⇒ the
capture cache's warmup manifest, ``index.json`` with ``files`` ⇒
catalog, ``journal.jsonl`` ⇒ supervisor run dir, ``groups.json`` ⇒ group
assignment, ``fleet_queue.jsonl`` ⇒ fleet dir, ``ckpt``/``ckpt_prev`` ⇒
checkpoint retention pair). The finding kinds,
fatal rules and repairs are the JAX package's; verification reuses the
write side's rules (chunk and payload digests, shard seals, the torn-tail
reader contract) plus the cross-checks no single reader performs
(journal "done" ⇒ artifact exists and verifies; manifest shard count ⇔
sealed dirs; catalog index ⇔ ``.npy`` digests; checkpoint sidecars ⇔
``ckpt_prev/`` retention; group marker ⇔ store manifest; queue replay ⇔
``runs/<name>/``).

Re-aimed at the port's formats:

- **checkpoints**: ``<name>.tensors`` payloads against their
  ``.meta.json`` sidecars' ``payload_sha256``, the orbax backend's
  shard files (``<name>.tensors.shard-<m>-of-<M>``, each with its
  sidecar) against their index sidecar, and ``.sha256``-sidecar'd
  pytrees (``utils/checkpoint.py``); the live/prev retention rules are
  the JAX package's;
- **the capture cache**: the warmup manifest (``xcache/manifest.py``),
  where the JAX package has ``exec/`` entries and an LRU manifest.

Every byte read funnels through :meth:`ScanCtx.read_bytes` /
:meth:`ScanCtx.read_quiet` and therefore the fault site ``fsck.scan``:
mode=error degrades the file to an "unreadable" finding — the scan
itself always completes — and mode=corrupt flips a read byte.

Nothing here imports torch: the CLI audits a host whose card is wedged.
"""

from __future__ import annotations

import io
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from sparse_coding_tpu_torch.fsck.findings import (
    CORRUPT,
    INCONSISTENT,
    MISSING,
    ORPHAN,
    STALE,
    TORN,
    Finding,
)
from sparse_coding_tpu_torch.resilience.faults import fault_point, register_fault_site
from sparse_coding_tpu_torch.resilience.lease import pid_alive, read_lease
from sparse_coding_tpu_torch.resilience.manifest import (
    array_sha256,
    bytes_sha256,
    check_payload_digest,
)

register_fault_site("fsck.scan",
                    "fsck audit read — every artifact byte-read the "
                    "checkers perform (fsck/checkers.py); mode=error "
                    "degrades the file to an 'unreadable' finding, "
                    "mode=corrupt flips a read byte so a sound tree "
                    "reports digest mismatches (scan must still complete)")

# mirrors pipeline/supervisor.py: children run with cwd=REPO_ROOT, so
# relative config paths in pipeline.json anchor against the same root
REPO_ROOT = Path(__file__).resolve().parents[2]

_TMP_RE = re.compile(r"^\..+\.tmp\.(\d+)$")
_SHARD_RE = re.compile(r"^shard-\d+$")
_GROUP_RE = re.compile(r"^group-\d+$")


@dataclass
class ScanCtx:
    """Shared scan state: the root findings are reported relative to,
    the staleness window for lease classification, and the finding
    accumulator every checker appends into."""

    root: Path
    stale_after_s: float = 300.0
    findings: list[Finding] = field(default_factory=list)

    def rel(self, path: Path) -> str:
        try:
            return path.resolve().relative_to(self.root).as_posix() or "."
        except ValueError:
            return path.resolve().as_posix()

    def add(self, path: Path, artifact_class: str, kind: str, detail: str,
            repair: str = "", fatal: bool = False) -> None:
        self.findings.append(Finding(
            path=self.rel(path), artifact_class=artifact_class, kind=kind,
            detail=detail, repair=repair, fatal=fatal))

    def read_quiet(self, path: Path) -> tuple[Optional[bytes], str]:
        """``(bytes, "")`` or ``(None, reason)`` — every checker read
        goes through here so the ``fsck.scan`` fault site covers the
        whole audit surface. The scan NEVER dies over one file."""
        try:
            data = path.read_bytes()
        except OSError as e:
            return None, str(e)
        try:
            return fault_point("fsck.scan", data), ""
        except Exception as e:  # injected error mode (or a torn read)
            return None, str(e)

    def read_bytes(self, path: Path, artifact_class: str) -> Optional[bytes]:
        """read_quiet + an ``unreadable`` CORRUPT finding on failure."""
        data, err = self.read_quiet(path)
        if data is None:
            self.add(path, artifact_class, CORRUPT, f"unreadable: {err}")
        return data


CHECKERS: list = []


def checker(fn):
    CHECKERS.append(fn)
    return fn


def _scan_jsonl(data: bytes) -> tuple[list[dict], int, bool]:
    """The obs event readers' torn-tail contract (obs/sink.py
    scan_events) over in-memory bytes: ``(records, skipped, torn_tail)``
    — only newline-terminated JSON-dict lines count."""
    records: list[dict] = []
    skipped = 0
    if not data:
        return records, skipped, False
    lines = data.split(b"\n")
    torn = bool(lines.pop())
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
        else:
            skipped += 1
    return records, skipped, torn


# -- tmp debris (every directory) ---------------------------------------------

@checker
def check_debris(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """``.{name}.tmp.{pid}`` files are resilience/atomic.py's staging
    names; one left behind means its writer was SIGKILLed between
    tmp-write and rename. The committed file (old or new) is complete
    either way — the debris is pure orphan bytes once the pid is gone."""
    for name in sorted(files):
        m = _TMP_RE.match(name)
        if not m:
            continue
        pid = int(m.group(1))
        if pid_alive(pid):
            ctx.add(d / name, "debris", STALE,
                    f"atomic-write tmp file owned by live pid {pid} "
                    "(write in flight — not touched)")
        else:
            ctx.add(d / name, "debris", ORPHAN,
                    f"atomic-write tmp debris from dead pid {pid} "
                    "(SIGKILL between tmp-write and rename)",
                    repair="debris.sweep")


# -- chunk stores + their quarantine ledger -----------------------------------

def _quarantined_indices(ctx: ScanCtx, d: Path, files: set) -> set:
    """Indices the quarantine ledger holes out of the store — verified
    first, because a LYING ledger would make fsck mis-read every hole."""
    if "quarantine.json" not in files:
        return set()
    path = d / "quarantine.json"
    data = ctx.read_bytes(path, "quarantine_ledger")
    if data is None:
        return set()
    try:
        raw = json.loads(data)
        chunks = {int(k) for k in raw.get("chunks", {})}
    except (ValueError, TypeError, AttributeError) as e:
        # readers degrade to an empty ledger (data/ledger.py) and the
        # chunk digests still catch what it knew — flagged, not fatal
        ctx.add(path, "quarantine_ledger", CORRUPT,
                f"unparseable quarantine ledger: {e} (readers treat as "
                "empty; quarantined chunks will re-verify as corrupt)")
        return set()
    state = check_payload_digest(raw)
    if state == "mismatch":
        ctx.add(path, "quarantine_ledger", INCONSISTENT,
                "payload digest mismatch — the recorded quarantine set "
                "cannot be trusted (LedgerCorruptionError on load)",
                fatal=True)
    elif state == "absent":
        ctx.add(path, "quarantine_ledger", STALE,
                "digest-less legacy ledger (loads unverified; rewritten "
                "with a digest on its next update)")
    return chunks


@checker
def check_chunk_store(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """``meta.json`` with ``chunk_digests`` is the completion marker the
    writer emits LAST — so every chunk it certifies must exist and match
    its recorded digest (data/chunk_store.py's read-side rule, applied
    store-wide). Quarantined indices are positional holes by design."""
    if "meta.json" not in files:
        return
    path = d / "meta.json"
    data = ctx.read_bytes(path, "chunk_store")
    if data is None:
        return
    try:
        meta = json.loads(data)
        digests = meta.get("chunk_digests")
    except (ValueError, AttributeError) as e:
        ctx.add(path, "chunk_store", CORRUPT,
                f"unparseable completion marker meta.json: {e}", fatal=True)
        return
    if not isinstance(digests, dict):
        return  # some other subsystem's meta.json
    quarantined = _quarantined_indices(ctx, d, files)
    try:
        n_chunks = int(meta.get("n_chunks", len(digests)))
    except (TypeError, ValueError):
        ctx.add(path, "chunk_store", INCONSISTENT,
                "meta.json n_chunks is not an integer", fatal=True)
        return
    for i in range(n_chunks):
        p = d / f"{i}.npy"
        if i in quarantined:
            continue  # a quarantine hole, not a defect
        if not p.exists():
            ctx.add(p, "chunk_store", MISSING,
                    "chunk certified complete by meta.json is absent "
                    "(and not quarantined)", fatal=True)
            continue
        want = digests.get(str(i))
        if not want:
            continue  # digest-less legacy chunk — nothing to verify
        raw = ctx.read_bytes(p, "chunk_store")
        if raw is None:
            continue
        try:
            arr = np.load(io.BytesIO(raw), allow_pickle=False)
        except Exception as e:
            ctx.add(p, "chunk_store", INCONSISTENT,
                    f"chunk does not deserialize: {e}", fatal=True)
            continue
        if array_sha256(arr) != want:
            ctx.add(p, "chunk_store", INCONSISTENT,
                    "chunk bytes do not match the digest meta.json "
                    "recorded at finalize", fatal=True)
    for p in sorted(d.glob("*.npy")):
        if p.stem.isdigit() and int(p.stem) >= n_chunks:
            ctx.add(p, "chunk_store", ORPHAN,
                    "chunk file beyond meta.json's n_chunks (nothing "
                    "references it)")


# -- sharded store manifest ⇔ seals -------------------------------------------

@checker
def check_shard_store(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """Store ``manifest.json`` (written last, after every shard sealed)
    ⇔ the sealed shard dirs: count, per-shard ``meta.json`` digest, and
    the ``shard.digest`` seal must agree three ways
    (data/shard_store.py's build-time rules, re-checked cold)."""
    if "manifest.json" not in files:
        return
    path = d / "manifest.json"
    data = ctx.read_bytes(path, "shard_store")
    if data is None:
        return
    try:
        manifest = json.loads(data)
    except ValueError as e:
        if any(_SHARD_RE.match(n) for n in dirs):
            ctx.add(path, "shard_store", CORRUPT,
                    f"unparseable store manifest next to shard dirs: {e}",
                    fatal=True)
        return
    if not isinstance(manifest, dict) \
            or manifest.get("kind") != "sharded_chunk_store":
        return
    shards = manifest.get("shards", [])
    if int(manifest.get("n_shards", -1)) != len(shards):
        ctx.add(path, "shard_store", INCONSISTENT,
                f"manifest n_shards={manifest.get('n_shards')} does not "
                f"match its own shard list ({len(shards)})", fatal=True)
    listed = set()
    for s in shards:
        name = str(s.get("name", ""))
        listed.add(name)
        sd = d / name
        if not sd.is_dir():
            ctx.add(sd, "shard_store", MISSING,
                    "shard listed in the store manifest is absent",
                    fatal=True)
            continue
        meta_p, seal_p = sd / "meta.json", sd / "shard.digest"
        if not meta_p.exists() or not seal_p.exists():
            ctx.add(sd, "shard_store", INCONSISTENT,
                    "manifest lists an unsealed shard (meta.json or "
                    "shard.digest missing)", fatal=True)
            continue
        meta_bytes = ctx.read_bytes(meta_p, "shard_store")
        seal_bytes = ctx.read_bytes(seal_p, "shard_store")
        if meta_bytes is None or seal_bytes is None:
            continue
        got = bytes_sha256(meta_bytes)
        try:
            seal = str(json.loads(seal_bytes)["meta_sha256"])
        except (ValueError, KeyError, TypeError) as e:
            ctx.add(seal_p, "shard_store", INCONSISTENT,
                    f"unreadable shard seal: {e}", fatal=True)
            continue
        if got != seal or got != str(s.get("meta_sha256", "")):
            ctx.add(sd, "shard_store", INCONSISTENT,
                    "shard meta.json digest disagrees with its seal "
                    "and/or the store manifest", fatal=True)
    for name in sorted(dirs):
        if _SHARD_RE.match(name) and name not in listed:
            ctx.add(d / name, "shard_store", ORPHAN,
                    "shard dir absent from the store manifest")


# -- checkpoint retention pair ------------------------------------------------

_SHARD_FILE_RE = re.compile(r"^(.+\.tensors)\.shard-(\d+)-of-(\d+)$")


def _payload_problem(ctx: ScanCtx, p: Path, side: Path) -> Optional[str]:
    """Why one tensor file fails its ``.meta.json`` sidecar, or None."""
    if not side.exists():
        return "digest sidecar (.meta.json) missing"
    side_bytes = ctx.read_quiet(side)[0]
    raw = ctx.read_quiet(p)[0]
    if side_bytes is None or raw is None:
        return "payload or sidecar unreadable"
    try:
        want = json.loads(side_bytes)["payload_sha256"]
    except (ValueError, KeyError, TypeError) as e:
        return f"unreadable sidecar: {e}"
    if bytes_sha256(raw) != want:
        return "payload does not match its sidecar digest"
    return None


def _ckpt_set_problems(ctx: ScanCtx, d: Path) -> list[tuple[Path, str]]:
    """Damage list for one checkpoint set dir: ``.tensors`` payloads and
    orbax shard files against their ``.meta.json`` sidecars, sharded
    checkpoints against their index sidecar's shard count, and
    ``.sha256``-sidecar'd pytrees (utils/checkpoint.py)."""
    problems: list[tuple[Path, str]] = []
    if not any(d.iterdir()):
        return [(d, "empty checkpoint set")]
    for p in sorted(d.glob("*.tensors")):
        why = _payload_problem(ctx, p, d / (p.name + ".meta.json"))
        if why:
            problems.append((p, why))
    shards: dict[str, set] = {}
    for p in sorted(d.iterdir()):
        m = _SHARD_FILE_RE.match(p.name)
        if not m:
            continue
        shards.setdefault(m.group(1), set()).add(
            (int(m.group(2)), int(m.group(3))))
        why = _payload_problem(ctx, p, d / (p.name + ".meta.json"))
        if why:
            problems.append((p, why))
    for side in sorted(d.glob("*.tensors.meta.json")):
        base = side.name[:-len(".meta.json")]
        if (d / base).exists():
            continue  # a plain payload's sidecar, checked above
        raw = ctx.read_quiet(side)[0]
        try:
            n = int(json.loads(raw)["shards"]) if raw is not None else None
        except (ValueError, KeyError, TypeError):
            n = None
        if n is None:
            problems.append((side, "sidecar with no payload, or an "
                                   "unreadable shard index"))
            continue
        missing = [m for m in range(n) if (m, n) not in shards.get(base, ())]
        if missing:
            problems.append((side, f"sharded checkpoint lacks shard(s) "
                                   f"{missing} of {n}"))
    for side in sorted(d.glob("*.sha256")):
        p = d / side.name[:-len(".sha256")]
        if not p.exists():
            problems.append((side, "digest sidecar with no payload"))
            continue
        raw = ctx.read_quiet(p)[0]
        want = (ctx.read_quiet(side)[0] or b"").decode(errors="replace")
        if raw is None or bytes_sha256(raw) != want.strip():
            problems.append((p, "payload does not match its .sha256 "
                                "sidecar"))
    return problems


@checker
def check_checkpoints(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """The retention invariant (train/sweep.py): ``ckpt/`` is the live
    set, ``ckpt_prev/`` the retained last-good fallback, ``ckpt_staging/``
    transient. Classification depends on BOTH sets and on whether the
    sweep already completed (a ``final/`` artifact): after completion the
    sets are dormant — damage is unregenerable and fatal; before it, a
    corrupt live set with a sound fallback is exactly what the fallback
    exists for (repair: drop the live set, resume replays from prev)."""
    if not ({"ckpt", "ckpt_prev", "ckpt_staging"} & dirs):
        return
    final_done = ("final" in dirs
                  and any((d / "final").glob("*.pkl")))
    if "ckpt_staging" in dirs:
        ctx.add(d / "ckpt_staging", "checkpoint", ORPHAN,
                "staging leftovers from an interrupted checkpoint swap "
                "(the resuming sweep discards them)",
                repair="ckpt.drop_staging")
    live = _ckpt_set_problems(ctx, d / "ckpt") if "ckpt" in dirs else None
    prev = (_ckpt_set_problems(ctx, d / "ckpt_prev")
            if "ckpt_prev" in dirs else None)
    for probs, which in ((live, "ckpt"), (prev, "ckpt_prev")):
        if not probs:
            continue
        for path, why in probs:
            if final_done:
                ctx.add(path, "checkpoint", INCONSISTENT,
                        f"{why} — retained checkpoint damaged after sweep "
                        "completion; nothing regenerates it", fatal=True)
            elif which == "ckpt" and prev == []:
                ctx.add(path, "checkpoint", CORRUPT,
                        f"{why} — live set corrupt but ckpt_prev/ is sound "
                        "(resume replays from the last-good set)",
                        repair="ckpt.fallback_prev")
            elif which == "ckpt_prev" and live == []:
                ctx.add(path, "checkpoint", STALE,
                        f"{why} — last-good fallback damaged but the live "
                        "set is sound; the next checkpoint swap replaces "
                        "it")
            else:
                ctx.add(path, "checkpoint", INCONSISTENT,
                        f"{why} — no sound checkpoint set remains",
                        fatal=True)


# -- guardian incident ledger -------------------------------------------------

@checker
def check_guardian(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    if "guardian.json" not in files:
        return
    path = d / "guardian.json"
    data = ctx.read_bytes(path, "guardian_ledger")
    if data is None:
        return
    try:
        raw = json.loads(data)
    except ValueError as e:
        ctx.add(path, "guardian_ledger", INCONSISTENT,
                f"unparseable incident ledger: {e} — a resume would "
                "silently forget quarantines and spent rollback budget",
                fatal=True)
        return
    state = check_payload_digest(raw)
    if state == "mismatch":
        ctx.add(path, "guardian_ledger", INCONSISTENT,
                "payload digest mismatch — recorded incidents cannot be "
                "trusted (LedgerCorruptionError on load)", fatal=True)
    elif state == "absent":
        ctx.add(path, "guardian_ledger", STALE,
                "digest-less legacy ledger (loads unverified; rewritten "
                "with a digest on its next incident)")


# -- the capture cache's warmup manifest -------------------------------------

@checker
def check_xcache(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """``warmup.json`` (xcache/manifest.py) records every program a
    serving process captured, keyed by its descriptor's canonical JSON.
    Bookkeeping, never ground truth: an unreadable manifest costs a cold
    warm start; keys that drifted from their descriptors are rewritten."""
    if "warmup.json" not in files:
        return
    path = d / "warmup.json"
    data = ctx.read_bytes(path, "xcache")
    if data is None:
        return
    try:
        parsed = json.loads(data)
        if not isinstance(parsed, dict):
            raise ValueError("not a dict")
    except ValueError as e:
        ctx.add(path, "xcache", CORRUPT,
                f"unparseable warmup manifest: {e} (warm starts degrade "
                "to cold captures)")
        return
    drifted = [k for k, v in parsed.items()
               if not isinstance(v, dict)
               or k != json.dumps(v, sort_keys=True, default=str)]
    if drifted:
        ctx.add(path, "xcache", STALE,
                f"{len(drifted)} warmup entr(ies) whose key is not their "
                "descriptor's canonical JSON", repair="xcache.reconcile")


# -- group assignment ---------------------------------------------------------

@checker
def check_groups(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """``groups.json`` (kind ``group_assignment``) is the group build's
    completion marker, written LAST: its self-digest must hold, every
    file it certifies (``similarity.npy``, each pooled
    ``group-<g>/manifest.json``) must exist and match, and every shard a
    group references must be listed by the sibling store manifest — a
    marker steering tenants at shards the store does not carry would
    train the wrong pool silently. ``group-<g>/`` dirs no group names
    are orphans (a rebuild at a smaller G leaves them behind)."""
    if "groups.json" not in files:
        return
    path = d / "groups.json"
    data = ctx.read_bytes(path, "groups")
    if data is None:
        return
    try:
        payload = json.loads(data)
    except ValueError as e:
        ctx.add(path, "groups", CORRUPT,
                f"unparseable group-assignment marker: {e}", fatal=True)
        return
    if not isinstance(payload, dict) \
            or payload.get("kind") != "group_assignment":
        return  # some other subsystem's groups.json
    state = check_payload_digest(payload)
    if state == "mismatch":
        ctx.add(path, "groups", INCONSISTENT,
                "payload digest mismatch — the group assignment cannot "
                "be trusted (GroupBuildError on load; rebuild via the "
                "group step)", fatal=True)
    elif state == "absent":
        ctx.add(path, "groups", STALE,
                "digest-less group-assignment marker (loads unverified)")
    fmap = payload.get("files", {})
    if isinstance(fmap, dict):
        for name in sorted(fmap):
            p = d / name
            if not p.exists():
                ctx.add(p, "groups", MISSING,
                        "file certified by groups.json is absent",
                        fatal=True)
                continue
            raw = ctx.read_bytes(p, "groups")
            if raw is None:
                continue
            if bytes_sha256(raw) != str(fmap[name]):
                ctx.add(p, "groups", INCONSISTENT,
                        "file bytes do not match the digest groups.json "
                        "recorded at finalize", fatal=True)
    # cross-check against the sibling store manifest: every shard a
    # group pools must exist in the store the marker sits in
    listed: Optional[set] = None
    if "manifest.json" in files:
        mdata = ctx.read_quiet(d / "manifest.json")[0]
        try:
            manifest = json.loads(mdata) if mdata is not None else None
        except ValueError:
            manifest = None  # shard_store checker owns that finding
        if isinstance(manifest, dict) \
                and manifest.get("kind") == "sharded_chunk_store":
            listed = {str(s.get("name", ""))
                      for s in manifest.get("shards", [])}
    named = set()
    for g in (payload.get("groups") or []):
        if not isinstance(g, dict):
            continue
        named.add(str(g.get("name", "")))
        if listed is None:
            continue
        for shard in (g.get("shards") or []):
            if str(shard) not in listed:
                ctx.add(path, "groups", INCONSISTENT,
                        f"group {g.get('name')!r} references shard "
                        f"{shard!r} absent from the store manifest — "
                        "tenants would train the wrong pool", fatal=True)
    for name in sorted(dirs):
        if _GROUP_RE.match(name) and name not in named:
            ctx.add(d / name, "groups", ORPHAN,
                    "group dir absent from groups.json (a rebuild at a "
                    "smaller G leaves stale pools behind)",
                    repair="groups.drop_pool")


# -- catalog ------------------------------------------------------------------

@checker
def check_catalog(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    if "index.json" not in files:
        return
    path = d / "index.json"
    data = ctx.read_bytes(path, "catalog")
    if data is None:
        return
    try:
        idx = json.loads(data)
        fmap = idx.get("files")
    except (ValueError, AttributeError) as e:
        ctx.add(path, "catalog", CORRUPT,
                f"unparseable completion marker index.json: {e}",
                fatal=True)
        return
    if not isinstance(fmap, dict) or "version" not in idx:
        return  # some other subsystem's index.json
    for name in sorted(fmap):
        p = d / name
        if not p.exists():
            ctx.add(p, "catalog", MISSING,
                    "file certified by the catalog index is absent",
                    fatal=True)
            continue
        raw = ctx.read_bytes(p, "catalog")
        if raw is None:
            continue
        if bytes_sha256(raw) != str(fmap[name]):
            ctx.add(p, "catalog", INCONSISTENT,
                    "file bytes do not match the digest the catalog "
                    "index recorded at finalize", fatal=True)
    for p in sorted(d.glob("*.npy")):
        if p.name not in fmap:
            ctx.add(p, "catalog", ORPHAN,
                    "array file absent from the catalog index")


# -- supervisor run dir -------------------------------------------------------

def _marker_table(config: dict) -> dict[str, tuple[Path, str]]:
    """step name -> (completion artifact, verifier) — mirrors the done()
    markers pipeline/supervisor.py's builders construct, so the journal
    cross-check and the supervisor can never disagree about what "done"
    means. Verifiers: "json" (must parse), "pickle" (pickletools-scan)."""

    def anchor(p) -> Path:
        p = Path(p)
        return p if p.is_absolute() else REPO_ROOT / p

    out: dict[str, tuple[Path, str]] = {}
    try:
        harvest = config.get("harvest", {})
        if "dataset_folder" in harvest:
            dataset = anchor(harvest["dataset_folder"])
            if "n_shards" in harvest or "layers" in harvest:
                # sharded or group (multi-tap) data plane: the store-
                # level manifest is the aggregate completion marker
                out["manifest"] = (dataset / "manifest.json", "json")
            else:
                out["harvest"] = (dataset / "meta.json", "json")
            if "group" in config:
                out["group"] = (dataset / "groups.json", "json")
        if "sweep" in config:
            sweep_out = anchor(config["sweep"]["ensemble"]["output_folder"])
            name = config["sweep"].get("experiment", "dense_l1_range")
            out["sweep"] = (sweep_out / "final"
                            / f"{name}_learned_dicts.pkl", "pickle")
        if "eval" in config:
            out["eval"] = (anchor(config["eval"]["output_folder"])
                           / "eval.json", "json")
        if "catalog" in config:
            out["catalog"] = (anchor(config["catalog"]["output_folder"])
                              / "index.json", "json")
    except (KeyError, TypeError):
        pass  # partial configs cross-check what they can
    return out


def _verify_marker(ctx: ScanCtx, path: Path, how: str) -> Optional[str]:
    """None when the artifact verifies, else the failure reason."""
    raw = ctx.read_quiet(path)[0]
    if raw is None:
        return "unreadable"
    if how == "json":
        try:
            json.loads(raw)
            return None
        except ValueError as e:
            return f"does not parse as JSON ({e})"
    if how == "pickle":
        import pickletools

        try:
            for _ in pickletools.genops(raw):
                pass
            return None
        except Exception as e:
            return f"not a complete pickle stream ({e})"
    return None


@checker
def check_leases(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """Any ``leases/`` dir (supervisor run dirs, fleet dirs): a lease
    whose owner pid is dead — or an unreadable one — is exactly the
    state ``lease_state()`` already authorizes takeover over; dropping
    it is the same decision made cold."""
    if d.name != "leases":
        return
    for name in sorted(files):
        if not name.endswith(".json"):
            continue
        p = d / name
        info = read_lease(p)
        if info is None:
            ctx.add(p, "lease", STALE,
                    "unreadable lease (pre-takeover debris — no valid "
                    "claim)", repair="lease.drop")
        elif not pid_alive(info.pid):
            ctx.add(p, "lease", STALE,
                    f"lease held by dead pid {info.pid} (crashed owner — "
                    "safe takeover)", repair="lease.drop")


@checker
def check_run_dir(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """A supervisor run dir: strict-scan the journal (torn-tail
    contract), then cross-check — journal says a step completed ⇒ its
    completion artifact exists AND verifies. A missing artifact is
    benign (steps are resumable by contract and re-run); an artifact
    that EXISTS but no longer verifies would be silently trusted by the
    supervisor's done() probe — that is the fatal case."""
    if "journal.jsonl" not in files:
        return
    jpath = d / "journal.jsonl"
    data = ctx.read_bytes(jpath, "journal")
    if data is None:
        return
    records, skipped, torn = _scan_jsonl(data)
    if torn:
        ctx.add(jpath, "journal", TORN,
                "unterminated final line (crash mid-append) — a "
                "truncated line can still parse as JSON and poison a "
                "fold", repair="journal.trim_tail")
    if skipped:
        ctx.add(jpath, "journal", STALE,
                f"{skipped} malformed interior line(s) skipped by the "
                "strict reader (operator edit?)")
    config = None
    if "pipeline.json" in files:
        cdata = ctx.read_bytes(d / "pipeline.json", "journal")
        if cdata is not None:
            try:
                config = json.loads(cdata)
            except ValueError as e:
                ctx.add(d / "pipeline.json", "journal", CORRUPT,
                        f"unparseable persisted pipeline config: {e} "
                        "(operators cannot rebuild this run's DAG)")
    if not isinstance(config, dict):
        return
    done = {r.get("step", "") for r in records
            if r.get("event") == "step.done"}
    for step, (marker, how) in sorted(_marker_table(config).items()):
        if step not in done:
            continue
        if not marker.exists():
            ctx.add(marker, "journal", STALE,
                    f"journal records step {step!r} done but its "
                    "completion artifact is absent (artifacts beat the "
                    "journal: the step re-runs on resume)")
            continue
        reason = _verify_marker(ctx, marker, how)
        if reason is not None:
            ctx.add(marker, "journal", INCONSISTENT,
                    f"journal records step {step!r} done and its "
                    f"completion artifact exists but {reason} — the "
                    "supervisor's done() probe would trust it and skip "
                    "the step", fatal=True)


@checker
def check_fleet(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """Fleet dir: queue replay ⇔ ``runs/<name>/`` dirs. The queue fold
    itself is torn-tail safe (pipeline/fleet_queue.py); fsck adds the
    tail finding + the existence cross-check."""
    if "fleet_queue.jsonl" not in files:
        return
    from sparse_coding_tpu_torch.pipeline.fleet_queue import FleetQueue
    from sparse_coding_tpu_torch.pipeline.placement import QUEUED

    qpath = d / "fleet_queue.jsonl"
    data = ctx.read_bytes(qpath, "fleet_queue")
    if data is None:
        return
    _, skipped, torn = _scan_jsonl(data)
    if torn:
        ctx.add(qpath, "fleet_queue", TORN,
                "unterminated final line (crash mid-append) — the "
                "replay fold skips it by contract",
                repair="journal.trim_tail")
    if skipped:
        ctx.add(qpath, "fleet_queue", STALE,
                f"{skipped} malformed interior line(s) skipped by the "
                "replay fold")
    state = FleetQueue(qpath).replay()
    runs_dir = d / "runs"
    for name, run in sorted(state.runs.items()):
        if run.state == QUEUED:
            continue  # never placed — no run dir expected yet
        if not (runs_dir / name).is_dir():
            ctx.add(runs_dir / name, "fleet_queue", MISSING,
                    f"queue replay says run {name!r} is {run.state} but "
                    "its run dir is absent")
    if runs_dir.is_dir():
        for sub in sorted(p for p in runs_dir.iterdir() if p.is_dir()):
            if sub.name not in state.runs:
                ctx.add(sub, "fleet_queue", ORPHAN,
                        "run dir with no fleet queue record")


# -- generic event / ledger JSONL tails ---------------------------------------

@checker
def check_event_tails(ctx: ScanCtx, d: Path, files: set, dirs: set) -> None:
    """obs event files and perf_ledger.jsonl: readers already skip a
    torn tail (obs/sink.py contract); fsck makes the tear visible and
    trims it. Journal/queue files have their own richer checkers."""
    for name in sorted(files):
        if not name.endswith(".jsonl"):
            continue
        if name in ("journal.jsonl", "fleet_queue.jsonl"):
            continue
        path = d / name
        data, err = ctx.read_quiet(path)
        if data is None:
            ctx.add(path, "events", CORRUPT, f"unreadable: {err}")
            continue
        if data and not data.endswith(b"\n"):
            ctx.add(path, "events", TORN,
                    "unterminated final line (crash mid-append; readers "
                    "skip it by contract)", repair="journal.trim_tail")
