"""The port's Group-SAE subsystem (sparse_coding_tpu_torch/groups/ and the
group steps of pipeline/) against the JAX package's, on the CPU.

Everything here is host numpy and JSON, so every check is exact:

- ``greedy_adjacent_groups`` gives the JAX assignment on seeded random
  matrices and on tied ones (strict ``>``: ties break to the lowest
  boundary), and raises on the same out-of-range targets;
- ``_layer_mixer`` (the synthetic multi-tap harvest's per-layer mix) is
  bitwise the JAX one;
- ``build_groups`` on one 4-layer store written with numpy, run by each
  package in its own copy, writes byte-identical ``groups.json``,
  ``similarity.npy`` and pooled manifests; the pooled view reads its
  member layers' chunks by reference;
- a tampered marker raises ``GroupBuildError`` on both sides, and the
  ``group`` step rebuilds it to the same bytes;
- a build SIGKILLed at the ``groups.finalize`` barrier rebuilds bitwise;
- the whole path: the group DAG under a CPU ``Supervisor`` (4 layers →
  G=2), a resumed supervisor that skips every step, then one fleet
  tenant per group through real worker subprocesses, ``group-000``
  poisoned: ``{"group-000": "halted", "group-001": "done"}``.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sparse_coding_tpu.groups import assign as jassign
from sparse_coding_tpu.groups import similarity as jsim
from sparse_coding_tpu.pipeline import steps as jsteps
from sparse_coding_tpu_torch.data.chunk_store import ChunkStore, ChunkWriter
from sparse_coding_tpu_torch.data.shard_store import (
    build_store_manifest,
    open_store,
    shard_name,
    write_shard_digest,
)
from sparse_coding_tpu_torch.groups import assign as tassign
from sparse_coding_tpu_torch.groups import similarity as tsim
from sparse_coding_tpu_torch.pipeline import steps as tsteps
from sparse_coding_tpu_torch.resilience import crash as tcrash
from sparse_coding_tpu_torch.resilience import lease as tlease

REPO = Path(__file__).resolve().parents[1]
FILES = ("groups.json", "similarity.npy", "group-000/manifest.json",
         "group-001/manifest.json")
CPU_ENV = {tsteps.ENV_DEVICE: "cpu", "CUDA_VISIBLE_DEVICES": ""}
POISON = {"SPARSE_CODING_FAULT_PLAN": "sweep.anomaly:nth=1,count=0,mode=nan"}


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for var in (tcrash.ENV_VAR, "SPARSE_CODING_FAULT_PLAN", tlease.ENV_PATH,
                tsteps.ENV_DEVICE, "SPARSE_CODING_XCACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the step children's
    yield
    tlease.configure(None)


# -- the assignment (pure) ----------------------------------------------------


def _matrices():
    rng = np.random.default_rng(0)
    out = []
    for n in (2, 4, 7):
        a = rng.random((n, n))
        m = (a + a.T) / 2
        np.fill_diagonal(m, 1.0)
        out.append(m)
    # ties: every adjacent pair scores the same, then two equal blocks
    out.append(np.full((5, 5), 0.5))
    tied = np.full((6, 6), 0.2)
    for i in range(0, 6, 2):
        tied[i, i + 1] = tied[i + 1, i] = 0.9
    np.fill_diagonal(tied, 1.0)
    out.append(tied)
    return out


@pytest.mark.parametrize("m", _matrices(), ids=lambda m: f"L{m.shape[0]}")
def test_greedy_adjacent_groups_matches_jax(m):
    n = m.shape[0]
    for g in range(1, n + 1):
        assert tassign.greedy_adjacent_groups(m, g) == \
            jassign.greedy_adjacent_groups(m, g)
    for bad in (0, n + 1):
        with pytest.raises(tassign.GroupBuildError, match="out of range"):
            tassign.greedy_adjacent_groups(m, bad)
        with pytest.raises(jassign.GroupBuildError, match="out of range"):
            jassign.greedy_adjacent_groups(m, bad)
    assert tassign.group_name(7) == jassign.group_name(7) == "group-007"


@pytest.mark.parametrize("layer", [0, 1, 3])
def test_layer_mixer_is_bitwise_jax(layer):
    rows = np.random.default_rng(layer).standard_normal(
        (33, 24)).astype(np.float16)
    got = tsteps._layer_mixer(24, layer, 5, 0.35)(rows)
    want = jsteps._layer_mixer(24, layer, 5, 0.35)(rows)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


# -- the durable build --------------------------------------------------------


def _write_store(root: Path, n_layers: int = 4, n_chunks: int = 3,
                 rows: int = 96, dim: int = 16) -> Path:
    """A multi-tap store written from numpy: shard ``i`` is layer ``i``,
    its rows a mix of one shared stream, stamped with its tap."""
    base = np.random.default_rng(11).standard_normal(
        (n_chunks * rows, dim)).astype(np.float32)
    for i in range(n_layers):
        d = root / shard_name(i)
        w = ChunkWriter(d, dim, chunk_size_gb=rows * dim * 2 / 2**30,
                        dtype="float16")
        w.add(tsteps._layer_mixer(dim, i, 0, 0.35)(base))
        w.finalize({"tap": f"residual.{i}", "layer": i,
                    "layer_loc": "residual"})
        write_shard_digest(d)
    build_store_manifest(root, expect_shards=n_layers)
    return root


def _build(mod, store: Path) -> dict:
    return mod.build_groups(store, n_groups=2, n_sample_chunks=2,
                            n_sample_rows=64, seed=3)


def test_build_groups_writes_the_jax_bytes(tmp_path):
    store = _write_store(tmp_path / "jax")
    shutil.copytree(store, tmp_path / "port")
    want = _build(jassign, tmp_path / "jax")
    got = _build(tassign, tmp_path / "port")
    assert got == want
    for rel in FILES:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    assert [g["layers"] for g in got["groups"]] == [[0, 1], [2, 3]]
    # the pass itself: the same taps and the same matrix, bit for bit
    t, j = tsim.layer_similarity(store, seed=3), jsim.layer_similarity(
        store, seed=3)
    assert t["matrix"].tobytes() == j["matrix"].tobytes()
    assert {k: v for k, v in t.items() if k != "matrix"} == \
        {k: v for k, v in j.items() if k != "matrix"}
    assert tsim.layer_taps(store) == jsim.layer_taps(store)
    # a rebuild over the same store rewrites every file bit for bit
    before = {rel: (tmp_path / "port" / rel).read_bytes() for rel in FILES}
    _build(tassign, tmp_path / "port")
    assert {rel: (tmp_path / "port" / rel).read_bytes()
            for rel in FILES} == before


def test_pooled_view_reads_member_chunks_by_reference(tmp_path):
    store = _write_store(tmp_path / "s")
    payload = _build(tassign, store)
    g1 = payload["groups"][1]
    pooled = open_store(store / g1["name"])
    assert pooled.n_chunks == g1["n_chunks"] == 6
    assert np.array_equal(pooled.load_chunk(0),
                          ChunkStore(store / "shard-002").load_chunk(0))
    assert np.array_equal(pooled.load_chunk(4),
                          ChunkStore(store / "shard-003").load_chunk(1))


def test_store_errors_match_jax(tmp_path):
    for mod in (tsim, jsim):
        with pytest.raises(mod.GroupStoreError, match="manifest"):
            mod.layer_taps(tmp_path)
        tap = {"shard": "shard-000", "tap": "t", "layer": 0,
               "layer_loc": "residual", "n_chunks": 2}
        with pytest.raises(mod.GroupStoreError, match="at least two"):
            mod.layer_similarity(tmp_path, taps=[tap])
        with pytest.raises(mod.GroupStoreError, match="chunk count"):
            mod.layer_similarity(tmp_path, taps=[tap, {**tap,
                                                       "n_chunks": 3}])


def test_tampered_marker_raises_and_the_step_rebuilds(tmp_path):
    store = _write_store(tmp_path / "s")
    cfg = {"harvest": {"dataset_folder": str(store), "layers": [0, 1, 2, 3]},
           "group": {"n_groups": 2, "n_sample_chunks": 2,
                     "n_sample_rows": 64, "seed": 3}}
    tsteps.run_group(cfg)
    marker = store / "groups.json"
    first = marker.read_bytes()
    tsteps.run_group(cfg)  # a sound marker: an idempotent skip
    assert marker.read_bytes() == first
    marker.write_bytes(first.replace(b'"n_groups": 2', b'"n_groups": 3'))
    for mod in (tassign, jassign):
        with pytest.raises(mod.GroupBuildError, match="digest"):
            mod.load_groups(store)
    assert tassign.load_groups(store, verify=False)["n_groups"] == 3
    tsteps.run_group(cfg)  # a rotted marker is rebuilt, to the same bytes
    assert marker.read_bytes() == first
    marker.unlink()
    with pytest.raises(FileNotFoundError):
        tassign.load_groups(store)


def test_finalize_kill_rebuilds_bitwise(tmp_path):
    ref = _write_store(tmp_path / "ref")
    shutil.copytree(ref, tmp_path / "kill")
    _build(tassign, ref)
    code = ("import sys; from pathlib import Path; "
            "from sparse_coding_tpu_torch.groups.assign import build_groups; "
            "build_groups(Path(sys.argv[1]), n_groups=2, n_sample_chunks=2, "
            "n_sample_rows=64, seed=3)")
    env = {**os.environ, tcrash.ENV_VAR: "groups.finalize:nth=1",
           "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "kill")],
                         cwd=REPO, env=env, capture_output=True, timeout=120)
    assert out.returncode == -9, out.stderr[-2000:]
    killed = tmp_path / "kill"
    # every file before the marker is durable, the marker is not
    assert not (killed / "groups.json").exists()
    for rel in FILES[1:]:
        assert (killed / rel).read_bytes() == (ref / rel).read_bytes()
    _build(tassign, killed)
    for rel in FILES:
        assert (killed / rel).read_bytes() == (ref / rel).read_bytes(), rel


# -- the whole path: the DAG, then one fleet tenant per group -----------------


def _group_config(base: Path) -> dict:
    return {
        "harvest": {"mode": "synthetic",
                    "dataset_folder": str(base / "store"),
                    "layers": [0, 1, 2, 3],
                    "activation_dim": 16, "n_ground_truth_features": 24,
                    "feature_num_nonzero": 5, "feature_prob_decay": 0.99,
                    "dataset_size": 1024, "n_chunks": 4, "batch_rows": 256,
                    "seed": 0, "phase_step": 0.35},
        "group": {"n_groups": 2, "n_sample_chunks": 2,
                  "n_sample_rows": 128, "seed": 0},
    }


def test_group_dag_then_tenants_halt_contained(tmp_path):
    """The group DAG (multi-tap writers → manifest → scrub → group) under a
    CPU supervisor reaches G=2 over 4 layers; a resumed supervisor skips
    every step; the similarity matrix is bitwise a fresh pass over the
    store; then ``enqueue_group_tenants`` with ``group-000`` poisoned (every
    batch NaN, guardian rollback budget 1) runs both tenants through real
    workers: the halt stays in group-000's run, group-001 finishes."""
    from sparse_coding_tpu_torch.groups import enqueue_group_tenants
    from sparse_coding_tpu_torch.pipeline import (
        FleetScheduler,
        Supervisor,
        build_group_pipeline,
    )

    cfg = _group_config(tmp_path / "data")
    store = Path(cfg["harvest"]["dataset_folder"])
    run = tmp_path / "group_run"
    summary = Supervisor(run, build_group_pipeline(run, cfg), cpu_only=True,
                         heartbeat_stale_s=60.0).run()
    assert summary == {**{f"harvest-{i}": "done" for i in range(4)},
                       "manifest": "done", "scrub": "done", "group": "done"}
    payload = tassign.load_groups(store)
    assert [g["layers"] for g in payload["groups"]] == [[0, 1], [2, 3]]
    meta = json.loads((store / "shard-002" / "meta.json").read_text())
    assert (meta["tap"], meta["layer"], meta["layer_loc"]) == (
        "residual.2", 2, "residual")
    sim = tsim.layer_similarity(store, n_sample_chunks=2,
                                n_sample_rows=128, seed=0)
    assert np.load(store / "similarity.npy").tobytes() == \
        sim["matrix"].tobytes()
    assert sim["matrix"][0, 1] > sim["matrix"][0, 2] > sim["matrix"][0, 3]
    again = Supervisor(run, build_group_pipeline(run, cfg), cpu_only=True,
                       heartbeat_stale_s=60.0).run()
    assert set(again.values()) == {"skipped"}

    base = {"sweep": {"experiment": "dense_l1_range", "log_every": 1000,
                      "ensemble": {"batch_size": 128,
                                   "learned_dict_ratio": 2.0,
                                   "tied_ae": True, "seed": 0,
                                   "checkpoint_every_chunks": 2,
                                   "guardian_rollback_budget": 1}},
            "eval": {"n_eval_rows": 512, "seed": 0}}
    out = tmp_path / "tenants"
    sched = FleetScheduler(tmp_path / "fleet", n_slices=2, max_concurrent=2,
                           max_run_attempts=1, poll_s=0.05, max_wall_s=120.0)
    names = enqueue_group_tenants(sched, store, base, out, max_attempts=1,
                                  env=CPU_ENV,
                                  env_overrides={"group-000": POISON})
    assert names == ["group-000", "group-001"]
    assert sched.run() == {"group-000": "halted", "group-001": "done"}
    assert "halt" in json.loads(
        (out / "group-000" / "sweep" / "guardian.json").read_text())
    g1 = out / "group-001" / "sweep" / "guardian.json"
    assert not g1.exists() or "halt" not in json.loads(g1.read_text())
    ev = json.loads((out / "group-001" / "eval" / "eval.json").read_text())
    assert ev["dicts"] and all(np.isfinite(r["fvu"]) for r in ev["dicts"])
    assert not (out / "group-000" / "sweep" / "final").exists()
    spec = json.loads((tmp_path / "fleet" / "runs" / "group-001"
                       / "pipeline.json").read_text())
    assert spec["sweep"]["ensemble"]["n_chunks"] == 8
    assert spec["sweep"]["group"] == "group-001"
