"""Store scrub: re-verify chunk digests, quarantine or repair, emit a
re-harvest worklist (the JAX package's ``data/scrub.py``).

Digests are verified on read (``ChunkStore``), so a chunk that rotted on
disk is otherwise found only when a sweep trips over it. The scrub moves
that discovery to a restartable step between harvest and sweep: it
re-reads every chunk against the digests in ``meta.json``, records
failures in the durable quarantine ledger (data/ledger.py), with
``repair=True`` moves each corrupt file into ``quarantine/`` (readers
then yield a positional None instead of re-reading it), and writes
``scrub/reharvest.json``, the worklist naming which shard, chunk and
rows a re-harvest must regenerate.

Crash-only: every output is idempotent and byte-deterministic (no
timestamps, no absolute paths); the ledger entry is durable before the
repair move (crash barrier ``scrub.repair`` between them), and a re-run
over a half-repaired store converges to the same bytes.
``scrub/scrub_report.json`` is written last: its presence marks the step
done. Pure host I/O: it touches no device.

CLI::

    python -m sparse_coding_tpu_torch.data.scrub <store_dir> [--repair] [--out DIR]
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.data.ledger import (
    clear_quarantine,
    load_quarantine,
    record_quarantine,
)
from sparse_coding_tpu_torch.data.shard_store import read_store_manifest
from sparse_coding_tpu_torch.resilience import lease
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text, fsync_dir
from sparse_coding_tpu_torch.resilience.crash import crash_barrier, register_crash_site
from sparse_coding_tpu_torch.resilience.faults import fault_point, register_fault_site
from sparse_coding_tpu_torch.resilience.manifest import array_sha256, bytes_sha256
from sparse_coding_tpu_torch.resilience.retry import retry_io

QUARANTINE_DIR = "quarantine"
REPORT_NAME = "scrub_report.json"
WORKLIST_NAME = "reharvest.json"

register_fault_site("shard.scrub",
                    "scrub's per-chunk verify read (data/scrub.py — "
                    "transient errors get a bounded retry; structural "
                    "damage quarantines the chunk)")
register_crash_site("scrub.repair",
                    "scrub: quarantine ledger entry durable, the corrupt "
                    "chunk file not yet moved aside (data/scrub.py)")


def _chunk_rows(path: Path) -> Optional[int]:
    """Row count from the .npy header alone (no payload read); None when
    even the header is unreadable."""
    from sparse_coding_tpu_torch.data.native_io import _npy_header

    try:
        _dtype, shape, _off = _npy_header(path)
        return int(shape[0]) if shape else None
    except (OSError, ValueError, EOFError):
        return None


def _verify_chunk(path: Path, expected: Optional[str],
                  io_retries: int = 3) -> Optional[str]:
    """Re-read one chunk and check its content digest; returns the
    failure reason, or None when the chunk is sound. Transient I/O gets
    the bounded retry; persistent I/O failure propagates (a flaky disk
    must not quarantine good data) — only structural damage and digest
    mismatches quarantine."""

    def _read():
        fault_point("shard.scrub")
        return np.load(path)

    try:
        arr = retry_io(_read, attempts=io_retries)
    except (ValueError, EOFError) as e:
        return f"unreadable npy: {e}"
    if expected is not None:
        got = array_sha256(arr)
        if got != expected:
            return (f"content digest mismatch ({got[:12]}… != "
                    f"{expected[:12]}…)")
    return None


def scrub_folder(folder: str | Path, repair: bool = False,
                 io_retries: int = 3) -> dict:
    """Scrub one finalized chunk folder (a shard, or a flat store).

    Returns ``{"checked", "ok", "quarantined": [i...], "worklist":
    [{"chunk", "rows"}...]}``. Chunks already repaired (file in
    ``quarantine/`` or missing with a ledger entry) are treated as
    quarantined without re-verification — the resume path after a kill
    anywhere in a previous scrub. A ledger-listed chunk whose live file
    verifies sound HEALED (re-harvested per the worklist): its stale
    ledger entry is cleared so readers deliver it again. With
    ``repair=True`` a corrupt chunk's
    file moves to ``quarantine/<i>.npy`` (rename — the original bytes are
    preserved for forensics) so later readers pay a positional ``None``
    instead of a read+digest of known garbage."""
    folder = Path(folder)
    if (any(folder.glob("*.pt"))
            and not any(folder.glob("*.npy"))
            and not any((folder / QUARANTINE_DIR).glob("*.npy"))):
        # reference pt stores (utils/ref_interop.py) carry no raw-chunk
        # digests and their chunks are not .npy files — scrubbing one
        # would land every healthy chunk in the missing-file branch and
        # durably quarantine the whole store. Refuse loudly instead.
        raise ValueError(
            f"{folder} is a pt-format reference store: scrub verifies raw "
            ".npy chunk digests only — convert via ref_interop, or skip")
    meta = json.loads((folder / "meta.json").read_text())
    digests = meta.get("chunk_digests") or {}
    n_chunks = int(meta.get("n_chunks", 0))
    qdir = folder / QUARANTINE_DIR
    ok = 0
    quarantined: list[int] = []
    worklist: list[dict] = []
    # the ledger is loaded ONCE and rewritten only for entries that
    # actually change: a re-scrub over Q already-quarantined chunks must
    # not pay Q ledger parses and Q durable fsync+rename cycles for zero
    # state change (idempotence stays — an unchanged entry's rewrite
    # would be byte-identical anyway)
    ledger = load_quarantine(folder)

    def _ledger_add(i: int, reason: str) -> None:
        entry = {"reason": str(reason), "file": f"{i}.npy"}
        if ledger.get(i) != entry:
            ledger.update(record_quarantine(folder, i, reason, f"{i}.npy"))

    for i in range(n_chunks):
        path = folder / f"{i}.npy"
        qpath = qdir / f"{i}.npy"
        if not path.exists():
            # missing from the live set: either a previous scrub already
            # repaired it (qpath/ledger) or the store lost a file —
            # both are quarantine-worklist outcomes, never a crash
            already = ledger.get(i)
            reason = (already or {}).get("reason") or "chunk file missing"
            _ledger_add(i, reason)
            quarantined.append(i)
            worklist.append({"chunk": i, "rows": _chunk_rows(qpath)})
            lease.beat()
            continue
        reason = _verify_chunk(path, digests.get(str(i)),
                               io_retries=io_retries)
        if reason is None:
            ok += 1
            if i in ledger:
                # the chunk HEALED: a re-harvest (scrub/reharvest.json
                # worklist) put a sound file back at this position — a
                # stale ledger entry would make readers skip it forever
                # while the report claims the store is clean. The
                # quarantine/ forensics copy (if any) stays: it records
                # what the rotted bytes were, and nothing consults it
                # while the live file exists.
                ledger = clear_quarantine(folder, i)
        else:
            rows = _chunk_rows(path)
            # ledger FIRST (durable knowledge), repair second: a kill
            # between them leaves a store that readers already skip
            # correctly and a re-run completes identically
            _ledger_add(i, reason)
            crash_barrier("scrub.repair")
            if repair:
                qdir.mkdir(parents=True, exist_ok=True)
                os.replace(path, qpath)
                fsync_dir(folder)
            quarantined.append(i)
            worklist.append({"chunk": i, "rows": rows})
        lease.beat()
    return {"checked": n_chunks, "ok": ok,
            "quarantined": sorted(quarantined), "worklist": worklist}


def scrub_store(root: str | Path, repair: bool = False,
                out_dir: Optional[str | Path] = None,
                io_retries: int = 3) -> dict:
    """Scrub a whole store — sharded (``manifest.json``) or flat — and
    write the two outputs under ``<root>/scrub/`` (or ``out_dir``):
    ``reharvest.json`` (the worklist) then ``scrub_report.json`` (the
    completion marker, LAST). Re-running over an unchanged store rewrites
    identical bytes. Returns the report dict."""
    root = Path(root)
    out = Path(out_dir) if out_dir is not None else root / "scrub"
    t0 = obs.monotime()
    manifest = read_store_manifest(root)
    shard_reports: dict[str, dict] = {}
    worklist: list[dict] = []
    if manifest is not None:
        for s in manifest["shards"]:
            d = root / s["name"]
            t_shard = obs.monotime()
            meta_path = d / "meta.json"
            sealed = str(s.get("meta_sha256", ""))
            if (not meta_path.exists()
                    or bytes_sha256(meta_path.read_bytes()) != sealed):
                # the shard's META itself is damaged: its digests can't
                # be trusted chunk-by-chunk — the whole shard goes on
                # the worklist
                rep = {"checked": 0, "ok": 0, "quarantined": [],
                       "worklist": [], "meta_damaged": True}
                worklist.append({"shard": s["name"], "chunk": None,
                                 "rows": None, "whole_shard": True})
            else:
                rep = scrub_folder(d, repair=repair, io_retries=io_retries)
                worklist.extend({"shard": s["name"], **w}
                                for w in rep["worklist"])
            shard_reports[s["name"]] = {k: v for k, v in rep.items()
                                        if k != "worklist"}
            obs.record_span("scrub.shard", obs.monotime() - t_shard,
                            shard=s["name"], checked=rep["checked"],
                            quarantined=len(rep["quarantined"]))
            obs.counter("scrub.chunks_checked").inc(rep["checked"])
            obs.counter("scrub.chunks_quarantined").inc(
                len(rep["quarantined"]))
    else:
        rep = scrub_folder(root, repair=repair, io_retries=io_retries)
        worklist = [{"shard": "", **w} for w in rep["worklist"]]
        shard_reports[""] = {k: v for k, v in rep.items() if k != "worklist"}
        obs.counter("scrub.chunks_checked").inc(rep["checked"])
        obs.counter("scrub.chunks_quarantined").inc(len(rep["quarantined"]))
    report = {"version": 1, "store": "sharded" if manifest else "flat",
              "repair": bool(repair),
              "checked": sum(r["checked"] for r in shard_reports.values()),
              "ok": sum(r["ok"] for r in shard_reports.values()),
              "quarantined": sum(len(r["quarantined"])
                                 for r in shard_reports.values()),
              "shards": shard_reports,
              "reharvest_entries": len(worklist)}
    out.mkdir(parents=True, exist_ok=True)
    atomic_write_text(out / WORKLIST_NAME,
                      json.dumps(worklist, indent=2, sort_keys=True))
    # report LAST: its presence is the supervisor step's done() marker
    atomic_write_text(out / REPORT_NAME,
                      json.dumps(report, indent=2, sort_keys=True))
    obs.record_span("scrub.store", obs.monotime() - t0,
                    checked=report["checked"],
                    quarantined=report["quarantined"])
    return report


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="re-verify a chunk store's digests; quarantine (and "
                    "with --repair, move aside) corrupt chunks; emit a "
                    "re-harvest worklist. Pure host I/O.")
    parser.add_argument("store", help="store root (sharded or flat)")
    parser.add_argument("--repair", action="store_true",
                        help="move corrupt chunks into quarantine/ so "
                             "readers skip them without re-reading")
    parser.add_argument("--out", default=None,
                        help="output dir (default: <store>/scrub)")
    ns = parser.parse_args(argv)
    report = scrub_store(ns.store, repair=ns.repair, out_dir=ns.out)
    json.dump(report, sys.stdout, indent=2, sort_keys=True)
    print()


if __name__ == "__main__":
    main()
