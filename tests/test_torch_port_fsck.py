"""The port's fsck (sparse_coding_tpu_torch/fsck/) against the JAX
package's, on the CPU.

Trees are built through the JAX package's own write-side primitives
(chunk digests, shard seals, payload-digest ledgers, journal appends,
leases), as the JAX package's tests/test_fsck.py builds them, then rotted
in controlled ways; both fscks scan the same tree and must report the
same findings — kind, path, artifact class, fatal, repair — and their
repairs must leave bitwise-equal trees. The comparison is exact: the
findings are a deterministic function of the tree's bytes.

The port's own formats get the same cases with no JAX oracle: its
checkpoint sets (``.tensors`` payloads, ``.meta.json`` sidecars, orbax
shard files, ``.sha256`` pytrees) under the JAX package's live/prev
retention rules, and its capture cache's warmup manifest. Group
assignments (built by the JAX package's ``build_groups``, whose bytes the
port's equal) and fleet dirs (a queue written by the JAX package's
``FleetQueue``) are trees of the parity table too.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sparse_coding_tpu.fsck import run_fsck as jrun_fsck
from sparse_coding_tpu.pipeline.journal import RunJournal as JRunJournal
from sparse_coding_tpu.resilience.lease import seed_lease as jseed_lease
from sparse_coding_tpu.resilience.manifest import (
    array_sha256,
    bytes_sha256,
    embed_payload_digest,
)
from sparse_coding_tpu_torch.fsck import Finding, run_fsck, scan_tree
from sparse_coding_tpu_torch.fsck.findings import (
    CORRUPT,
    INCONSISTENT,
    ORPHAN,
    STALE,
)
from sparse_coding_tpu_torch.fsck.repair import repair_findings

REPO = Path(__file__).resolve().parents[1]
DEAD_PID = 4999999  # beyond kernel.pid_max defaults: never a live process


# -- tree builders: the JAX package's write-side formats ------------------------


def _chunk_store(d: Path, n: int = 3, dim: int = 4) -> dict:
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    digests = {}
    for i in range(n):
        arr = rng.normal(size=(8, dim)).astype(np.float32)
        np.save(d / f"{i}.npy", arr)
        digests[str(i)] = array_sha256(arr)
    meta = {"n_chunks": n, "activation_dim": dim, "chunk_digests": digests}
    (d / "meta.json").write_text(json.dumps(meta, indent=2, sort_keys=True))
    return meta


def _catalog(d: Path) -> None:
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "mcs.npy", np.arange(6, dtype=np.float32))
    files = {"mcs.npy": bytes_sha256((d / "mcs.npy").read_bytes())}
    (d / "index.json").write_text(json.dumps(
        {"version": 1, "files": files}, indent=2, sort_keys=True))


def _shard_store(d: Path, n_shards: int = 2) -> None:
    d.mkdir(parents=True, exist_ok=True)
    shards, total = [], 0
    for i in range(n_shards):
        name = f"shard-{i:03d}"
        meta = _chunk_store(d / name, n=2)
        total += meta["n_chunks"]
        meta_digest = bytes_sha256((d / name / "meta.json").read_bytes())
        (d / name / "shard.digest").write_text(
            json.dumps({"meta_sha256": meta_digest}, sort_keys=True) + "\n")
        shards.append({"name": name, "n_chunks": meta["n_chunks"],
                       "meta_sha256": meta_digest})
    (d / "manifest.json").write_text(json.dumps(
        {"version": 1, "kind": "sharded_chunk_store", "n_shards": n_shards,
         "n_chunks": total, "shards": shards}, indent=2, sort_keys=True))


def _guardian(d: Path) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / "guardian.json").write_text(json.dumps(
        embed_payload_digest({"version": 1, "members": {}, "rollbacks": {}}),
        indent=2, sort_keys=True))


def _run_dir(d: Path, eval_dir: Path) -> JRunJournal:
    d.mkdir(parents=True, exist_ok=True)
    eval_dir.mkdir(parents=True, exist_ok=True)
    (eval_dir / "eval.json").write_text(json.dumps({"fvu": 0.5}))
    (d / "pipeline.json").write_text(json.dumps(
        {"eval": {"output_folder": str(eval_dir)}}, indent=2,
        sort_keys=True))
    j = JRunJournal(d / "journal.jsonl", clock=lambda: 0.0)
    j.append("run.start")
    j.append("step.done", "eval")
    return j


def _flip_last_byte(p: Path) -> None:
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0x01
    p.write_bytes(bytes(raw))


def _sound(r: Path):
    _chunk_store(r / "chunks")
    _guardian(r / "sweep")
    _shard_store(r / "shards")
    _catalog(r / "catalog")
    _run_dir(r / "run", r / "eval")


def _chunk_rot(r: Path):
    store = r / "chunks"
    _chunk_store(store, n=3)
    _flip_last_byte(store / "1.npy")
    (store / "2.npy").unlink()
    np.save(store / "9.npy", np.zeros(2, dtype=np.float32))


def _quarantine_hole(r: Path):
    from sparse_coding_tpu.data.ledger import record_quarantine

    store = r / "chunks"
    _chunk_store(store, n=3)
    (store / "1.npy").write_bytes(b"poison")
    record_quarantine(store, 1, "digest mismatch", "1.npy")


def _quarantine_forged(r: Path):
    store = r / "chunks"
    _chunk_store(store, n=2)
    payload = embed_payload_digest(
        {"version": 1, "chunks": {"1": {"reason": "r", "file": "1.npy"}}})
    payload["chunks"]["0"] = {"reason": "forged", "file": "0.npy"}
    (store / "quarantine.json").write_text(json.dumps(payload))


def _guardian_forged(r: Path):
    _guardian(r / "sweep")
    raw = json.loads((r / "sweep" / "guardian.json").read_text())
    raw["rollbacks"] = {"forged": {"count": 3}}
    (r / "sweep" / "guardian.json").write_text(json.dumps(raw))


def _guardian_legacy(r: Path):
    (r / "sweep").mkdir(parents=True)
    (r / "sweep" / "guardian.json").write_text(json.dumps(
        {"version": 1, "members": {}, "rollbacks": {}}))


def _shard_cross(r: Path):
    store = r / "shards"
    _shard_store(store, n_shards=2)
    meta_p = store / "shard-001" / "meta.json"
    meta = json.loads(meta_p.read_text())
    meta["activation_dim"] = 999
    meta_p.write_text(json.dumps(meta, indent=2, sort_keys=True))
    _chunk_store(store / "shard-777", n=1)


def _catalog_cross(r: Path):
    _catalog(r / "catalog")
    _flip_last_byte(r / "catalog" / "mcs.npy")
    np.save(r / "catalog" / "extra.npy", np.zeros(2))


def _journal_vanished(r: Path):
    _run_dir(r / "run", r / "eval")
    (r / "eval" / "eval.json").unlink()


def _journal_unverifiable(r: Path):
    _run_dir(r / "run", r / "eval")
    (r / "eval" / "eval.json").write_text('{"fvu": 0.')  # truncated


def _journal_torn(r: Path):
    j = _run_dir(r / "run", r / "eval")
    j.path.write_bytes(j.path.read_bytes()
                       + b'{"seq": 99, "event": "step.done"')


def _leases(r: Path):
    _run_dir(r / "run", r / "eval")
    leases = r / "run" / "leases"
    leases.mkdir()
    jseed_lease(leases / "dead.json", DEAD_PID, step="sweep")
    jseed_lease(leases / "live.json", os.getpid(), step="eval")
    (leases / "junk.json").write_text("{not a lease")


def _debris(r: Path):
    _chunk_store(r / "chunks")
    (r / "chunks" / f".0.npy.tmp.{DEAD_PID}").write_bytes(b"x")
    (r / f".x.tmp.{os.getpid()}").write_bytes(b"in-flight")


def _event_tails(r: Path):
    (r / "obs").mkdir()
    (r / "obs" / "sweep-1.jsonl").write_bytes(b'{"a":1}\n{"torn')
    (r / "perf_ledger.jsonl").write_bytes(b'{"kind": "run"}\n')


def _group_store(d: Path) -> dict:
    """A sound grouped multi-tap store: 3 layer shards built through the
    hand primitives, then the JAX package's ``build_groups`` over them —
    similarity, pooled views and the digest-sealed ``groups.json``."""
    from sparse_coding_tpu.groups.assign import build_groups

    d.mkdir(parents=True, exist_ok=True)
    shards, total = [], 0
    for i in range(3):
        name = f"shard-{i:03d}"
        meta = _chunk_store(d / name, n=2)
        meta.update({"tap": f"residual.{i}", "layer": i,
                     "layer_loc": "residual"})
        (d / name / "meta.json").write_text(
            json.dumps(meta, indent=2, sort_keys=True))
        total += meta["n_chunks"]
        meta_digest = bytes_sha256((d / name / "meta.json").read_bytes())
        (d / name / "shard.digest").write_text(
            json.dumps({"meta_sha256": meta_digest}, sort_keys=True) + "\n")
        shards.append({"name": name, "n_chunks": meta["n_chunks"],
                       "meta_sha256": meta_digest})
    (d / "manifest.json").write_text(json.dumps(
        {"version": 1, "kind": "sharded_chunk_store", "n_shards": 3,
         "n_chunks": total, "activation_dim": 4, "dtype": "float32",
         "shards": shards}, indent=2, sort_keys=True))
    return build_groups(d, n_groups=2, n_sample_chunks=1, n_sample_rows=8)


def _groups_sound(r: Path):
    _group_store(r / "gstore")


def _groups_digest(r: Path):
    """The payload rotted in place, still parseable: only the embedded
    digest tells (fatal)."""
    _group_store(r / "gstore")
    marker = r / "gstore" / "groups.json"
    marker.write_bytes(marker.read_bytes().replace(b'"n_layers": 3',
                                                   b'"n_layers": 4'))


def _groups_files(r: Path):
    """A certified file deleted (MISSING) and one bit-flipped
    (INCONSISTENT), both fatal."""
    _group_store(r / "gstore")
    (r / "gstore" / "similarity.npy").unlink()
    pooled = r / "gstore" / "group-000" / "manifest.json"
    raw = bytearray(pooled.read_bytes())
    raw[-2] ^= 0x01
    pooled.write_bytes(bytes(raw))


def _groups_shard_ref(r: Path):
    """A digest-valid marker naming a shard the store does not list."""
    payload = _group_store(r / "gstore")
    del payload["payload_sha256"]
    payload["groups"][0]["shards"] = ["shard-999"]
    (r / "gstore" / "groups.json").write_text(json.dumps(
        embed_payload_digest(payload), indent=2, sort_keys=True))


def _groups_orphan(r: Path):
    """A pool dir no group names (repair: groups.drop_pool), a
    digest-less marker beside another subsystem's groups.json."""
    _group_store(r / "gstore")
    (r / "gstore" / "group-007").mkdir()
    (r / "gstore" / "group-007" / "manifest.json").write_text("{}")
    (r / "other").mkdir()
    (r / "other" / "groups.json").write_text(json.dumps({"kind": "x"}))
    (r / "legacy").mkdir()
    (r / "legacy" / "groups.json").write_text(json.dumps(
        {"kind": "group_assignment", "groups": []}))


def _fleet(r: Path):
    """A fleet dir: a placed run with no run dir, a run dir with no queue
    record, a done run with its dir, and a torn queue tail."""
    from sparse_coding_tpu.pipeline.fleet_queue import FleetQueue

    fleet = r / "fleet"
    q = FleetQueue(fleet / "fleet_queue.jsonl", clock=lambda: 0.0)
    for name in ("runa", "runb", "runc"):
        q.enqueue(name, {"kind": "command", "argv": ["true"],
                         "done_path": "d"}, 1)
    q.append("run.place", "runa")
    q.append("run.place", "runb")
    q.append("run.release", "runb", outcome="done")
    (fleet / "runs" / "runb").mkdir(parents=True)
    (fleet / "runs" / "ghost").mkdir()
    q.path.write_bytes(q.path.read_bytes() + b'{"seq": 9, "event": "run.p')


def _inconsistent_only(r: Path):
    _chunk_store(r / "chunks", n=2)
    _flip_last_byte(r / "chunks" / "0.npy")


TREES = {"sound": _sound, "chunk_rot": _chunk_rot,
         "quarantine_hole": _quarantine_hole,
         "quarantine_forged": _quarantine_forged,
         "guardian_forged": _guardian_forged,
         "guardian_legacy": _guardian_legacy, "shard_cross": _shard_cross,
         "catalog_cross": _catalog_cross,
         "journal_vanished": _journal_vanished,
         "journal_unverifiable": _journal_unverifiable,
         "journal_torn": _journal_torn, "leases": _leases,
         "debris": _debris, "event_tails": _event_tails,
         "inconsistent_only": _inconsistent_only,
         "groups_sound": _groups_sound, "groups_digest": _groups_digest,
         "groups_files": _groups_files,
         "groups_shard_ref": _groups_shard_ref,
         "groups_orphan": _groups_orphan, "fleet": _fleet}
# the scan root of the run-dir trees is the run dir: run_fsck expands it
# to the artifact roots its pipeline.json names
RUN_ROOTED = {"journal_vanished", "journal_unverifiable", "journal_torn",
              "leases"}


def _key(report, root: Path) -> list[tuple]:
    """The findings, a path outside the scan root (absolute) with its
    tree's root written as <root>."""
    return [(f.path.replace(str(root.resolve()), "<root>"),
             f.artifact_class, f.kind, f.repair, f.fatal)
            for f in report.findings]


def _tree_digests(root: Path) -> dict:
    """Every file's digest, its own root's path written as <root> (the
    run dirs' pipeline.json names absolute paths); a lease's by name only
    (it holds the time it was written)."""
    return {str(p.relative_to(root)): "lease" if p.parent.name == "leases"
            else hashlib.sha256(p.read_bytes().replace(
                str(root).encode(), b"<root>")).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "fsck" not in p.relative_to(root).parts}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_findings_and_repairs_match_jax(tmp_path, tree):
    roots = {}
    for side in ("jax", "port"):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        TREES[tree](roots[side])
    scan = {side: (roots[side] / "run" if tree in RUN_ROOTED
                   else roots[side]) for side in roots}
    j = jrun_fsck(scan["jax"], write_report=False)
    t = run_fsck(scan["port"], write_report=False)
    assert _key(t, roots["port"]) == _key(j, roots["jax"])
    assert [f.detail for f in t.findings] == [f.detail for f in j.findings]
    assert t.clean == (tree in ("sound", "quarantine_hole", "groups_sound"))
    jr = jrun_fsck(scan["jax"], repair=True, write_report=False)
    tr = run_fsck(scan["port"], repair=True, write_report=False)
    assert tr.repaired == jr.repaired
    assert _key(tr, roots["port"]) == _key(jr, roots["jax"])
    assert _tree_digests(roots["port"]) == _tree_digests(roots["jax"])


def test_report_bytes_are_deterministic_and_written_last(tmp_path):
    _chunk_rot(tmp_path)
    r1 = run_fsck(tmp_path)
    r2 = run_fsck(tmp_path)
    assert r1.to_json() == r2.to_json()
    assert (tmp_path / "fsck" / "report.json").read_text() == \
        r1.to_json() + "\n"
    assert not any(f.path.startswith("fsck") for f in r2.findings)


def test_unknown_repair_action_skips_loudly(tmp_path):
    out = repair_findings(tmp_path, [Finding(
        path="x", artifact_class="debris", kind=ORPHAN, detail="d",
        repair="not.an.action")])
    assert out == [{"action": "not.an.action", "path": "x",
                    "applied": False,
                    "note": "unknown repair action — skipped"}]


# -- the port's checkpoint sets (no JAX oracle) -------------------------------


def _ckpt(d: Path, seed: int = 0, name: str = "dense_l1_range_0",
          shards: int = 0) -> None:
    """One checkpoint set as the port's writers write it: a tensor file
    with its sidecar, or an orbax-sharded one (shard files + index)."""
    from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
    from sparse_coding_tpu_torch.utils import checkpoint as ck

    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.default_rng(seed)
    arrays = {"params/encoder": rs.normal(size=(4, 3)).astype(np.float32),
              "step": np.asarray(seed, np.int32)}
    path = d / f"{name}{ck.SUFFIX}"
    extra = {"chunks_done": seed}
    if not shards:
        ck._write_checkpoint(path, arrays, {"sig_name": "x"}, extra)
        return
    for m in range(shards):
        ck._write_checkpoint(ck.shard_path(path, m, shards), arrays,
                             {"sig_name": "x"}, extra)
    atomic_write_text(ck._meta_path(path), json.dumps(
        {"shards": shards, **extra}))


def _ckpt_findings(root: Path) -> list[tuple]:
    return [(f.kind, f.fatal, f.repair) for f in scan_tree(root).findings
            if f.artifact_class == "checkpoint"]


def _payload(d: Path) -> Path:
    return next(p for p in sorted(d.iterdir())
                if p.name.endswith(".tensors")
                or (".shard-" in p.name and not p.name.endswith(".json")))


@pytest.mark.parametrize("shards", [0, 2], ids=["tensors", "orbax"])
def test_port_checkpoint_sets_sound_and_live_corrupt(tmp_path, shards):
    out = tmp_path / "sweep"
    _ckpt(out / "ckpt", 2, shards=shards)
    _ckpt(out / "ckpt_prev", 1, shards=shards)
    from sparse_coding_tpu_torch.utils.checkpoint import save_pytree

    save_pytree({"a": np.arange(3, dtype=np.float32)},
                out / "ckpt" / "extra.tree")
    assert scan_tree(tmp_path).clean
    _flip_last_byte(_payload(out / "ckpt"))
    assert _ckpt_findings(tmp_path) == [(CORRUPT, False,
                                         "ckpt.fallback_prev")]
    report = run_fsck(tmp_path, repair=True, write_report=False)
    assert report.clean and not (out / "ckpt").exists()
    assert (out / "ckpt_prev").exists()


def test_port_checkpoint_retention_rules(tmp_path):
    """prev corrupt, live sound: STALE; damage after the sweep finished
    (final/ holds a pickle): INCONSISTENT, fatal, no repair; both sets
    corrupt: fatal; a missing orbax shard and an orphan sidecar are
    damage; staging leftovers are ORPHAN debris."""
    import pickle

    out = tmp_path / "sweep"
    _ckpt(out / "ckpt", 2)
    _ckpt(out / "ckpt_prev", 1)
    _flip_last_byte(_payload(out / "ckpt_prev"))
    assert _ckpt_findings(tmp_path) == [(STALE, False, "")]
    _flip_last_byte(_payload(out / "ckpt"))
    assert _ckpt_findings(tmp_path) == [(INCONSISTENT, True, "")] * 2
    shutil.rmtree(out)
    _ckpt(out / "ckpt", 2)
    _ckpt(out / "ckpt_staging", 3)
    (out / "final").mkdir()
    (out / "final" / "x_learned_dicts.pkl").write_bytes(pickle.dumps([1]))
    _flip_last_byte(_payload(out / "ckpt"))
    assert sorted(_ckpt_findings(tmp_path)) == [
        (INCONSISTENT, True, ""), (ORPHAN, False, "ckpt.drop_staging")]
    shutil.rmtree(out)
    _ckpt(out / "ckpt", 2, shards=2)
    _ckpt(out / "ckpt_prev", 1)
    next((out / "ckpt").glob("*.shard-1-of-2")).unlink()
    next((out / "ckpt").glob("*.shard-1-of-2.meta.json")).unlink()
    got = scan_tree(tmp_path)
    assert [(f.kind, f.repair) for f in got.findings] == [
        (CORRUPT, "ckpt.fallback_prev")]
    assert "lacks shard(s) [1] of 2" in got.findings[0].detail


# -- the capture cache's warmup manifest ----------------------------------------


def test_warmup_manifest_checks_and_repair(tmp_path):
    from sparse_coding_tpu_torch.xcache.manifest import WarmupManifest

    cache = tmp_path / "xcache"
    man = WarmupManifest(cache / "warmup.json")
    for bucket in (8, 64):
        man.record({"kind": "serve", "model": "m", "op": "encode",
                    "bucket": bucket})
    assert scan_tree(tmp_path).clean
    raw = json.loads(man.path.read_text())
    raw["stale-key"] = next(iter(raw.values()))
    man.path.write_text(json.dumps(raw))
    report = scan_tree(tmp_path)
    assert [(f.kind, f.repair) for f in report.findings] == [
        (STALE, "xcache.reconcile")]
    assert run_fsck(tmp_path, repair=True, write_report=False).clean
    assert len(WarmupManifest(man.path)) == 2
    man.path.write_text("{torn")
    assert [f.kind for f in scan_tree(tmp_path).findings] == [CORRUPT]


# -- the fleet's own audit ----------------------------------------------------


def test_fleet_sweep_audits_the_tree_and_leaves_a_breadcrumb(tmp_path):
    from sparse_coding_tpu_torch.fsck.findings import MISSING
    from sparse_coding_tpu_torch.pipeline.fleet import FleetScheduler

    fleet = tmp_path / "fleet"
    sched = FleetScheduler(fleet, n_slices=1)
    sched.enqueue("runa", argv=["true"], done_path=str(fleet / "d.json"),
                  kind="command")
    sched.queue.append("run.place", "runa")  # placed, but no run dir
    (fleet / "runs" / "ghost").mkdir(parents=True)
    report = sched.fsck_sweep()
    kinds = {(f.kind, f.artifact_class) for f in report.findings}
    assert {(MISSING, "fleet_queue"), (ORPHAN, "fleet_queue")} <= kinds
    last = sched.queue.journal.records()[-1]
    assert last["event"] == "scheduler.fsck"
    assert last["detail"]["findings"] == len(report.findings)


# -- the supervisor's preflight and the CLI ----------------------------------


def test_preflight_halts_typed_on_fatal_rot(tmp_path, monkeypatch):
    from sparse_coding_tpu_torch.pipeline import (
        PreflightAuditError,
        Step,
        Supervisor,
    )

    monkeypatch.delenv("SPARSE_CODING_FSCK_PREFLIGHT", raising=False)
    run = tmp_path / "run"
    _run_dir(run, tmp_path / "eval")
    (tmp_path / "eval" / "eval.json").write_text('{"fvu": 0.')
    step = Step(name="noop", argv=["true"], done=lambda: True)
    sup = Supervisor(run, [step], heartbeat_stale_s=300.0)
    with pytest.raises(PreflightAuditError, match="eval.json") as e:
        sup.run()
    assert "sparse_coding_tpu_torch.fsck" in str(e.value)
    recs = [r for r in sup.journal.records() if r["event"] == "run.fsck"]
    assert recs and recs[-1]["detail"]["fatal"]
    monkeypatch.setenv("SPARSE_CODING_FSCK_PREFLIGHT", "0")
    assert Supervisor(run, [step], heartbeat_stale_s=300.0).run() == {
        "noop": "skipped"}


def test_cli_exit_codes_and_no_cuda(tmp_path):
    """The CLI prints one JSON line, exits 2 on a fatal finding, and
    leaves CUDA uninitialized and the kernels unloaded."""
    _chunk_rot(tmp_path / "tree")
    code = ("import sys, torch\n"
            "from sparse_coding_tpu_torch.fsck.__main__ import main\n"
            "rc = main([sys.argv[1], '--no-report'])\n"
            "print(torch.cuda.is_initialized(), "
            "'sparse_coding_tpu_torch.ops._build' in sys.modules)\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "tree")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2, out.stderr[-2000:]
    summary, flags = out.stdout.strip().splitlines()
    assert json.loads(summary)["fatal"] >= 1
    assert flags == "False False"
    assert "FATAL" in out.stderr
