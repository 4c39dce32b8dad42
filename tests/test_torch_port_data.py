"""The port's data layer and artifacts against the JAX package's: the chunk
store format (each side reads what the other wrote, byte for byte), the
epoch batch sequence, and learned-dict artifacts that cross-load in both
directions. Files, decoded chunks and batches are compared exactly (the
same numpy data through the same formats and the same numpy RNG draws);
only values that recompute a row norm (normalized dictionaries, predict)
carry an ulp-level tolerance."""

import json

import jax
import numpy as np
import pytest
import torch

from sparse_coding_tpu.data import chunk_store as jcs
from sparse_coding_tpu.utils import artifacts as jart
from sparse_coding_tpu_torch.data import chunk_store as tcs
from sparse_coding_tpu_torch.data.shard_store import open_store
from sparse_coding_tpu_torch.models import learned_dict as tld
from sparse_coding_tpu_torch.utils import artifacts as tart

D = 24
ROWS = 1000  # 3 chunks of 300 rows and a 100-row tail


def _data(seed=0):
    return np.random.default_rng(seed).normal(size=(ROWS, D)).astype(
        np.float32)


def _write(mod, folder, dtype, center):
    itemsize = 4 if dtype == "float32" else 2
    w = mod.ChunkWriter(folder, D, chunk_size_gb=300 * D * itemsize / 2**30,
                        dtype=dtype, center=center)
    data = _data()
    for lo in range(0, ROWS, 128):  # slabs that straddle chunk boundaries
        w.add(data[lo:lo + 128])
    return w.finalize()


@pytest.mark.parametrize("dtype,center", [("bfloat16", False),
                                          ("float16", True),
                                          ("float32", False)])
def test_chunk_writers_write_identical_stores(tmp_path, dtype, center):
    """Both writers turn the same rows into byte-identical files (chunks,
    center.npy, meta.json with its sha256 digests), and each side's reader
    decodes the other's store to the same arrays."""
    a, b = tmp_path / "jax", tmp_path / "torch"
    assert _write(jcs, a, dtype, center) == _write(tcs, b, dtype, center) == 4
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    meta = json.loads((b / "meta.json").read_text())
    assert meta["dtype"] == dtype and meta["centered"] == center
    js, ts = jcs.ChunkStore(b), tcs.ChunkStore(a)
    assert ts.n_chunks == js.n_chunks and ts.activation_dim == D
    for i in range(ts.n_chunks):
        np.testing.assert_array_equal(ts.load_chunk(i), js.load_chunk(i))
    if center:
        np.testing.assert_array_equal(ts.center, js.center)


def test_epoch_batch_sequence_matches(tmp_path):
    """The same (batch_size, default_rng(seed)) yields the same batches,
    in the same order, over two repetitions."""
    _write(jcs, tmp_path, "bfloat16", False)
    got = list(tcs.ChunkStore(tmp_path).epoch(
        64, np.random.default_rng(7), n_repetitions=2))
    ref = list(jcs.ChunkStore(tmp_path).epoch(
        64, np.random.default_rng(7), n_repetitions=2))
    assert len(got) == len(ref) == 2 * (3 * (300 // 64) + 100 // 64)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    stacks = list(tcs.window_stacks(iter(got), 4))
    ref_stacks = list(jcs.window_stacks(iter(ref), 4))
    assert [s.shape for s in stacks] == [s.shape for s in ref_stacks]
    for g, r in zip(stacks, ref_stacks):
        np.testing.assert_array_equal(g, r)


def test_device_prefetch_on_the_cpu_yields_the_batches(tmp_path):
    batches = [np.full((4, D), i, np.float32) for i in range(5)]
    out = list(tcs.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 5
    for t, b in zip(out, batches):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), b)


def test_corrupt_chunk_is_a_typed_error(tmp_path):
    """A flipped byte fails the sha256 digest, as in the JAX store."""
    _write(tcs, tmp_path, "float16", False)
    raw = bytearray((tmp_path / "1.npy").read_bytes())
    raw[-3] ^= 0x40
    (tmp_path / "1.npy").write_bytes(bytes(raw))
    store = tcs.ChunkStore(tmp_path)
    store.load_chunk(0)
    with pytest.raises(tcs.ChunkCorruptionError, match="digest mismatch"):
        store.load_chunk(1)
    with pytest.raises(jcs.ChunkCorruptionError, match="digest mismatch"):
        jcs.ChunkStore(tmp_path).load_chunk(1)


@pytest.mark.parametrize("payload", [
    {"version": 1, "chunks": {"3": {"reason": "x", "file": "3.npy"}}},
    {"b": [1, 2.5, None], "a": {"z": "é", "y": True}},
    {"payload_sha256": "stale", "k": 0}], ids=["ledger", "mixed", "stale"])
def test_payload_digest_matches_jax(payload):
    """embed_payload_digest gives the JAX package's digest on the same
    payload, so a ledger written by either side verifies on the other."""
    from sparse_coding_tpu.resilience import manifest as jman
    from sparse_coding_tpu_torch.resilience import manifest as tman

    got, want = tman.embed_payload_digest(payload), jman.embed_payload_digest(
        payload)
    assert got == want and json.dumps(got) == json.dumps(want)
    assert tman.check_payload_digest(want) == jman.check_payload_digest(got)
    assert tman.check_payload_digest(got) == "ok"
    tampered = dict(got, extra=1)
    assert (tman.check_payload_digest(tampered)
            == jman.check_payload_digest(tampered) == "mismatch")
    body = {k: v for k, v in got.items() if k != tman.PAYLOAD_DIGEST_KEY}
    assert tman.check_payload_digest(body) == "absent"
    assert tman.check_payload_digest([1]) == "mismatch"


def test_open_store_takes_the_flat_layout_only(tmp_path):
    """A folder without manifest.json opens as a flat store; one with a
    manifest is taken for a sharded store (its reader's tests are in
    tests/test_torch_port_shard_store.py), so a manifest listing no
    shards raises the typed layout error."""
    from sparse_coding_tpu_torch.data.shard_store import ShardLayoutError

    _write(tcs, tmp_path, "float16", False)
    store = open_store(tmp_path)
    assert isinstance(store, tcs.ChunkStore) and store.n_chunks == 4
    (tmp_path / "manifest.json").write_text("{}")
    with pytest.raises(ShardLayoutError, match="sharded store"):
        open_store(tmp_path)


def _torch_dicts(n=3, seed=0):
    rs = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32))
    return [(tld.TiedSAE(dictionary=t(16, D), encoder_bias=t(16),
                         centering_rot=torch.eye(D), centering_trans=t(D),
                         centering_scale=None),
             {"l1_alpha": 10.0 ** -(i + 2), "dict_ratio": 16 / D})
            for i in range(n)]


def test_port_artifacts_load_in_jax(tmp_path):
    """learned_dicts.pkl written by the port loads with the JAX package's
    load_learned_dicts: same class, fields, None-valued statics and
    hyperparams; the two sides' predict agrees."""
    dicts = _torch_dicts()
    tart.save_learned_dicts(dicts, tmp_path / "learned_dicts.pkl")
    loaded = jart.load_learned_dicts(tmp_path / "learned_dicts.pkl")
    x = np.random.default_rng(1).normal(size=(8, D)).astype(np.float32)
    for (td, th), (jd, jh) in zip(dicts, loaded):
        assert type(jd).__name__ == "TiedSAE" and jh == th
        assert jd.centering_scale is None
        np.testing.assert_array_equal(np.asarray(jd.dictionary),
                                      td.dictionary.numpy())
        np.testing.assert_allclose(np.asarray(jd.predict(x)),
                                   td.predict(torch.from_numpy(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_jax_artifacts_load_in_the_port(tmp_path):
    from sparse_coding_tpu.models.learned_dict import TiedSAE, UntiedSAE

    rs = np.random.default_rng(2)
    j = lambda *s: jax.numpy.asarray(rs.normal(size=s).astype(np.float32))
    dicts = [(TiedSAE(dictionary=j(16, D), encoder_bias=j(16)),
              {"l1_alpha": 1e-3}),
             (UntiedSAE(encoder=j(16, D), encoder_bias=j(16),
                        dictionary=j(16, D)), {"l1_alpha": 1e-2,
                                               "diverged": True})]
    jart.save_learned_dicts(dicts, tmp_path / "learned_dicts.pkl")
    loaded = tart.load_learned_dicts(tmp_path / "learned_dicts.pkl")
    assert [type(d).__name__ for d, _ in loaded] == ["TiedSAE", "UntiedSAE"]
    for (jd, jh), (td, th) in zip(dicts, loaded):
        assert th == jh
        np.testing.assert_array_equal(td.dictionary.numpy(),
                                      np.asarray(jd.dictionary))
        # the row norms round differently on the two sides: a few ulps
        np.testing.assert_allclose(td.get_learned_dict().numpy(),
                                   np.asarray(jd.get_learned_dict()),
                                   rtol=1e-6, atol=1e-7)
    assert len(tart.load_learned_dicts(tmp_path / "learned_dicts.pkl",
                                       skip_diverged=True)) == 1
    kept = tart.load_learned_dicts(tmp_path / "learned_dicts.pkl",
                                   select=lambda h: h["l1_alpha"] > 5e-3)
    assert [h["l1_alpha"] for _, h in kept] == [1e-2]
