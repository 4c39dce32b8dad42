"""The port's sharded chunk store (sparse_coding_tpu_torch/data/shard_store.py)
against the JAX package's, following tests/test_shard_store.py: the
shard-major positional space, seals and the manifest (byte-equal to the
JAX one for the same shards), shard-local quarantine, ``open_store``'s
dispatch, and stores one package writes opened by the other with equal
chunks. Then the sweep over a 2-shard store: bitwise the port's sweep
over the flat store with the same chunks, and within the JAX package's
fused-vs-autodiff bound (rtol 2e-4) of the JAX sweep over the same
sharded store (the JAX init carried across, as in
tests/test_torch_port_full_sweep.py)."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding_tpu.data import chunk_store as jcs
from sparse_coding_tpu.data import shard_store as jss
from sparse_coding_tpu.data.scrub import scrub_store
from sparse_coding_tpu.train import sweep as jsweep
from sparse_coding_tpu_torch.data import chunk_store as tcs
from sparse_coding_tpu_torch.data import ledger as tledger
from sparse_coding_tpu_torch.data import shard_store as tss
from sparse_coding_tpu_torch.resilience import crash, faults
from sparse_coding_tpu_torch.train import sweep as tsweep
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts
from test_torch_port_full_sweep import (
    assert_dicts_close,
    configs,
    jax_build,
    port_build,
    write_store,
)

DIM = 8
ROWS_PER_CHUNK = 16
SIDES = {"port": (tcs, tss), "jax": (jcs, jss)}


@pytest.fixture(autouse=True)
def no_plans():
    prev = faults.install_plan(None), crash.install_crash_plan(None)
    yield
    faults.install_plan(prev[0])
    crash.install_crash_plan(prev[1])


def _write_folder(cs, folder: Path, rows: int, seed: int) -> np.ndarray:
    """One flat folder of 16-row float16 chunks written by ``cs``'s
    writer; returns the f32 rows a reader must give back."""
    w = cs.ChunkWriter(folder, DIM,
                       chunk_size_gb=DIM * ROWS_PER_CHUNK * 2 / 2**30,
                       dtype="float16")
    data = np.random.default_rng(seed).normal(
        size=(rows, DIM)).astype(np.float16).astype(np.float32)
    w.add(data)
    w.finalize({"tag": "shard-tests"})
    return data


def _mk_sharded(root: Path, side: str = "port", n_shards: int = 2,
                chunks_per_shard: int = 2) -> np.ndarray:
    """A sealed, manifested store made by one side's writer and tools;
    returns the shard-major rows the global index space must read."""
    cs, ss = SIDES[side]
    parts = []
    for si in range(n_shards):
        d = root / ss.shard_name(si)
        parts.append(_write_folder(cs, d, ROWS_PER_CHUNK * chunks_per_shard,
                                   seed=si))
        ss.write_shard_digest(d)
    ss.build_store_manifest(root, expect_shards=n_shards)
    return np.concatenate(parts)


def _corrupt(path: Path) -> None:
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0x01  # payload bit flip: loads fine, the digest catches it
    path.write_bytes(bytes(blob))


def _rows(i: int) -> slice:
    return slice(i * ROWS_PER_CHUNK, (i + 1) * ROWS_PER_CHUNK)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_store(tmp_path, writer):
    """A store sealed and manifested by either package opens in both with
    the same positional space (the shard-major concatenation), the same
    chunks byte for byte, and the same reader order."""
    data = _mk_sharded(tmp_path, writer)
    port = tss.ShardedChunkStore(tmp_path)
    ref = jss.ShardedChunkStore(tmp_path)
    assert port.n_chunks == ref.n_chunks == 4
    assert port.activation_dim == DIM
    for i in range(4):
        got = port.load_chunk(i)
        assert got.tobytes() == np.asarray(ref.load_chunk(i)).tobytes()
        np.testing.assert_array_equal(got, data[_rows(i)])
    order = [3, 0, 2, 1, 0]
    out = list(port.chunk_reader(order))
    for pos, ci in enumerate(order):
        np.testing.assert_array_equal(out[pos], data[_rows(ci)])
    assert port.center is None
    assert port.chunk_mean(1).tobytes() == data[_rows(1)].mean(0).tobytes()


def test_manifest_and_seals_are_byte_equal_to_jax(tmp_path):
    """For the same shards both packages write byte-identical seals and
    manifests; a rebuild converges bitwise; a meta changed after sealing
    fails on either side."""
    port_root, jax_root = tmp_path / "p", tmp_path / "j"
    _mk_sharded(port_root, "port")
    shutil.copytree(port_root, jax_root)
    for si in range(2):
        jss.write_shard_digest(jax_root / jss.shard_name(si))
    jss.build_store_manifest(jax_root, expect_shards=2)
    for rel in ("manifest.json", "shard-000/shard.digest",
                "shard-001/shard.digest", "shard-000/meta.json"):
        assert (port_root / rel).read_bytes() == (jax_root / rel).read_bytes()
    once = (port_root / "manifest.json").read_bytes()
    assert tss.build_store_manifest(port_root, expect_shards=2) == \
        tss.read_store_manifest(port_root)
    assert (port_root / "manifest.json").read_bytes() == once
    m = tss.read_store_manifest(port_root)
    assert m["n_shards"] == 2 and m["n_chunks"] == 4
    meta = port_root / tss.shard_name(0) / "meta.json"
    meta.write_text(meta.read_text().replace("shard-tests", "tampered"))
    with pytest.raises(tss.ShardLayoutError, match="changed after sealing"):
        tss.build_store_manifest(port_root)


def test_quarantine_routes_to_the_owning_shard(tmp_path):
    _mk_sharded(tmp_path)
    _corrupt(tmp_path / tss.shard_name(1) / "0.npy")  # global index 2
    store = tss.ShardedChunkStore(tmp_path, quarantine_corrupt=True)
    out = list(store.chunk_reader([0, 1, 2, 3]))
    assert [c is None for c in out] == [False, False, True, False]
    assert store.quarantined == {2}
    # the owning shard's ledger, in the shard's own coordinates
    assert set(tledger.load_quarantine(tmp_path / tss.shard_name(1))) == {0}
    assert tledger.load_quarantine(tmp_path / tss.shard_name(0)) == {}
    assert set(store.shard_quarantine_ledgers()[tss.shard_name(1)]) == {0}
    # the JAX reader opens the store knowing the same quarantine
    assert jss.ShardedChunkStore(tmp_path).quarantined == {2}
    strict = tss.ShardedChunkStore(tmp_path)
    with pytest.raises(tcs.ChunkCorruptionError) as e:
        strict.load_chunk(2)
    assert e.value.chunk_index == 2 and e.value.path.parent.name == \
        tss.shard_name(1)


def test_unsealed_shard_rejected(tmp_path):
    _write_folder(tcs, tmp_path / tss.shard_name(0), 32, seed=0)
    with pytest.raises(tss.ShardLayoutError, match="not sealed"):
        tss.build_store_manifest(tmp_path)
    with pytest.raises(tss.ShardLayoutError, match="no meta.json"):
        tss.write_shard_digest(tmp_path / "nonexistent")
    with pytest.raises(FileNotFoundError):
        tss.ShardedChunkStore(tmp_path)


def test_write_shard_digest_idempotent(tmp_path):
    d = tmp_path / tss.shard_name(0)
    _write_folder(tcs, d, 32, seed=0)
    first = tss.write_shard_digest(d)
    blob = (d / "shard.digest").read_bytes()
    assert tss.write_shard_digest(d) == first == tss.read_shard_digest(d)
    assert (d / "shard.digest").read_bytes() == blob


def test_open_store_dispatches_on_layout(tmp_path):
    flat = tmp_path / "flat"
    _write_folder(tcs, flat, 32, seed=0)
    assert isinstance(tss.open_store(flat), tcs.ChunkStore)
    sharded = tmp_path / "sharded"
    _mk_sharded(sharded)
    store = tss.open_store(sharded, quarantine_corrupt=True)
    assert isinstance(store, tss.ShardedChunkStore)
    assert store.quarantine_corrupt


def test_manifest_rebuilt_when_shard_count_changes(tmp_path):
    """A manifest of 2 shards must not stand for a store that now has 4:
    asked for 4 it is rebuilt, and a reader sees every shard; a rebuild at
    the matching count rewrites identical bytes."""
    _mk_sharded(tmp_path, n_shards=2)
    for si in (2, 3):
        d = tmp_path / tss.shard_name(si)
        _write_folder(tcs, d, ROWS_PER_CHUNK * 2, seed=si)
        tss.write_shard_digest(d)
    assert tss.open_store(tmp_path).n_chunks == 4  # the stale manifest
    with pytest.raises(tss.ShardLayoutError, match="expected 2"):
        tss.build_store_manifest(tmp_path, expect_shards=2)
    m = tss.build_store_manifest(tmp_path, expect_shards=4)
    assert m["n_shards"] == 4 and m["n_chunks"] == 8
    assert tss.open_store(tmp_path).n_chunks == 8
    once = (tmp_path / "manifest.json").read_bytes()
    tss.build_store_manifest(tmp_path, expect_shards=4)
    assert (tmp_path / "manifest.json").read_bytes() == once


def test_shard_dirs_order_numerically_past_the_padding(tmp_path):
    for i in (0, 2, 999, 1000, 1001):
        (tmp_path / tss.shard_name(i)).mkdir()
    (tmp_path / "shard-extra").mkdir()  # a non-numeric suffix sorts first
    names = [p.name for p in tss.shard_dirs(tmp_path)]
    assert names == ["shard-extra", "shard-000", "shard-002", "shard-999",
                     "shard-1000", "shard-1001"]
    assert names == [p.name for p in jss.shard_dirs(tmp_path)]


def test_fully_repaired_store_opens_and_yields_nones(tmp_path):
    """The JAX scrub moves every corrupt chunk of shard 0 aside: the port
    still opens the store (a flat folder with no live chunk file, too)
    and reads its positions as Nones."""
    data = _mk_sharded(tmp_path)
    for i in range(2):
        _corrupt(tmp_path / tss.shard_name(0) / f"{i}.npy")
    scrub_store(tmp_path, repair=True)
    shard0 = tmp_path / tss.shard_name(0)
    assert not list(shard0.glob("*.npy"))
    flat = tcs.ChunkStore(shard0, quarantine_corrupt=True)
    assert flat.n_chunks == 2 and flat.activation_dim == DIM
    assert list(flat.chunk_reader([0, 1])) == [None, None]
    sharded = tss.ShardedChunkStore(tmp_path, quarantine_corrupt=True)
    out = list(sharded.chunk_reader([0, 1, 2, 3]))
    assert [c is None for c in out] == [True, True, False, False]
    np.testing.assert_array_equal(out[2], data[_rows(2)])
    assert tss.first_sound_chunk(sharded) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tcs.ChunkStore(empty)


def test_shard_write_retried_and_finalize_barrier(tmp_path, monkeypatch):
    killed = []
    monkeypatch.setattr(crash, "_kill_self", killed.append)
    crash.install_crash_plan(crash.parse_crash_plan("shard.finalize:nth=2"))
    with faults.inject(site="shard.write", nth=1, error="OSError") as plan:
        _mk_sharded(tmp_path)
    assert killed == ["shard.finalize"]
    assert plan.fired == [("shard.write", 1)]
    assert plan.hits["shard.write"] == 4  # two seals, a retry, the manifest
    with faults.inject(site="shard.write", count=0, error="OSError"):
        with pytest.raises(OSError):
            tss.build_store_manifest(tmp_path)


# -- the sweep over a sharded store -------------------------------------------


def reshard(flat: Path, root: Path, sizes) -> Path:
    """The flat store's chunks, in order, as a sealed sharded store of
    ``sizes`` chunks a shard: the chunk files are copied, each shard's
    meta.json keeps the flat meta's fields with the digests renumbered."""
    meta = json.loads((flat / "meta.json").read_text())
    start = 0
    for si, n in enumerate(sizes):
        d = root / tss.shard_name(si)
        d.mkdir(parents=True)
        for li in range(n):
            shutil.copyfile(flat / f"{start + li}.npy", d / f"{li}.npy")
        shard_meta = dict(meta, n_chunks=n, chunk_digests={
            str(li): meta["chunk_digests"][str(start + li)]
            for li in range(n)})
        (d / "meta.json").write_text(json.dumps(shard_meta, indent=2))
        tss.write_shard_digest(d)
        start += n
    tss.build_store_manifest(root, expect_shards=len(sizes))
    return root


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharded_sweep")
    flat = write_store(base / "flat")
    return flat, reshard(flat, base / "sharded", (2, 2))


def test_sweep_over_a_sharded_store(stores, tmp_path):
    """The port's sweep over the 2-shard store is bitwise its sweep over
    the flat store (learned dicts, evals and the final checkpoint set),
    and within rtol 2e-4 of the JAX sweep over the same sharded store."""
    flat, sharded = stores
    jcfg, tcfg = configs(sharded, tmp_path, tied_ae=True,
                         center_activations=True)
    jres = jsweep.sweep(jax_build("dense_l1_range"), jcfg, log_every=5,
                        image_metrics_every=None)
    tres = tsweep.sweep(port_build("dense_l1_range", jcfg), tcfg,
                        log_every=5, image_metrics_every=None, device="cpu")
    assert_dicts_close(jres, tres)
    ref_out = tmp_path / "flat"
    ref = tsweep.sweep(port_build("dense_l1_range", jcfg),
                       tcfg.replace(dataset_folder=str(flat),
                                    output_folder=str(ref_out)),
                       log_every=5, image_metrics_every=None, device="cpu")
    for (a, ha), (b, hb) in zip(tres["dense_l1_range"],
                                ref["dense_l1_range"]):
        assert ha == hb
        for f in ("dictionary", "encoder_bias"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    out = tmp_path / "torch"
    for rel in ("_3/dense_l1_range_eval.json",
                "ckpt/dense_l1_range_0.tensors",
                "ckpt/dense_l1_range_0.tensors.meta.json"):
        assert (out / rel).read_bytes() == (ref_out / rel).read_bytes(), rel
    assert len(load_learned_dicts(
        out / "_3/dense_l1_range_learned_dicts.pkl")) == 3
