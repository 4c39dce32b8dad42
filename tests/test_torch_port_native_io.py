"""The port's native chunk reads (sparse_coding_tpu_torch/data/native_io.py,
its own build of native/chunkio.cpp) against np.load and the JAX
package's bindings, and the port's chunk store reading through them.

Reads are compared bitwise: the native path must hand back the bytes
np.load returns, for float32, float16 and bfloat16-as-uint16 chunks.
"""

import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_coding_tpu.data import chunk_store as jcs
from sparse_coding_tpu.data import native_io as jnio
from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.data import chunk_store as tcs
from sparse_coding_tpu_torch.data import ledger as tledger
from sparse_coding_tpu_torch.data import native_io as tnio
from sparse_coding_tpu_torch.ops._build import BUILD_ROOT
from sparse_coding_tpu_torch.resilience.errors import ChunkCorruptionError

D, ROWS = 16, 64


@pytest.fixture(autouse=True)
def lib():
    if tnio.get_lib() is None:
        pytest.skip("no g++ here: the port's readers take np.load")


@pytest.fixture
def registry():
    prev = obs.set_registry(obs.Registry())
    yield obs.get_registry()
    obs.set_registry(prev)


def _write_store(folder, dtype="float16", n_chunks=3, seed=0):
    w = tcs.ChunkWriter(folder, D, dtype=dtype,
                        chunk_size_gb=ROWS * D * 2 / 2**30)
    w.add(np.random.default_rng(seed).normal(size=(n_chunks * ROWS, D))
          .astype(np.float32))
    w.finalize()
    return folder


def _reads(registry) -> dict:
    counters = registry.snapshot()["counters"]
    return {k.split("path=")[1].rstrip("}"): v for k, v in counters.items()
            if k.startswith("data.chunk_reads")}


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16-bits"])
def test_read_npy_native_equals_np_load(tmp_path, monkeypatch, dtype):
    """The port's reader against np.load and the JAX package's reader,
    bitwise. The JAX reader runs on the library the port built from the
    same native/chunkio.cpp: its own loader compiles straight into
    native/libchunkio.so, which another test process may be writing at
    the same moment, and a half-written library leaves that process
    without a reader for good. Pointed at a finished build, the JAX
    module's get_lib loads it with its own argtypes and builds nothing."""
    monkeypatch.setattr(jnio, "_LIB_PATH", tnio.library_path())
    monkeypatch.setattr(jnio, "_lib", None)
    monkeypatch.setattr(jnio, "_lib_failed", False)
    x = np.random.default_rng(1).normal(size=(1000, 24)).astype(np.float32)
    arr = (tcs._to_bf16_bits(x) if dtype == "bfloat16-bits"
           else x.astype(dtype))
    path = tmp_path / "c.npy"
    np.save(path, arr)
    got = tnio.read_npy_native(path)
    ref = np.load(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    assert jnio.get_lib() is not None
    assert got.tobytes() == jnio.read_npy_native(path).tobytes()


def test_library_builds_in_the_ports_build_directory(tmp_path, monkeypatch):
    """The library compiles from native/chunkio.cpp into the port's build
    directory (listed in .gitignore), never into native/, and the port
    loads that build, not native/libchunkio.so."""
    native = tnio.SOURCE.parent
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    monkeypatch.setattr(tnio, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(tnio, "_lib", None)
    monkeypatch.setattr(tnio, "_lib_failed", False)
    lib = tnio.get_lib()
    built = tnio.library_path()
    assert lib is not None and lib._name == str(built) and built.exists()
    assert built.parent.parent == tmp_path / "_build"
    assert built.parent.name.startswith("chunkio-")
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before
    monkeypatch.undo()
    # the default build directory is the port's, and git ignores it
    assert tnio.library_path().parent.parent == BUILD_ROOT
    assert tnio.get_lib()._name == str(tnio.library_path())
    assert subprocess.run(["git", "check-ignore", "-q",
                           str(tnio.library_path())],
                          cwd=BUILD_ROOT.parents[2]).returncode == 0


def test_prefetcher_start_poll_wait_cancel(tmp_path):
    """As tests/test_native_io.py asserts of the JAX prefetcher: start
    reads into a buffer the prefetcher owns, poll reports readiness (None
    with nothing in flight), wait hands the array over; cancel abandons a
    read, after which wait has nothing."""
    import time

    a = np.arange(4096, dtype=np.float32).reshape(64, 64)
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", a * 2)
    pf = tnio.NativePrefetcher()
    assert pf.poll() is None and pf.wait() is None
    assert pf.start(tmp_path / "a.npy")
    assert not pf.start(tmp_path / "b.npy")  # one read in flight
    deadline = time.monotonic() + 10.0
    while not pf.poll() and time.monotonic() < deadline:
        time.sleep(0.001)
    assert pf.poll() is True
    np.testing.assert_array_equal(pf.wait(), a)
    assert pf.poll() is None
    assert pf.start(tmp_path / "b.npy")
    np.testing.assert_array_equal(pf.wait(), a * 2)
    assert pf.start(tmp_path / "a.npy")
    pf.cancel()
    assert pf.poll() is None and pf.wait() is None


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("damage", ["payload", "header"])
def test_truncated_chunk_is_typed_corruption_on_both_paths(
        tmp_path, monkeypatch, path, damage):
    """A truncated chunk raises ChunkCorruptionError from load_chunk and
    from the serial reader (whose prefetch degrades to the foreground
    read), with the library and without it, as the JAX store does; under
    quarantine_corrupt the reader yields None in its position and ledgers
    it."""
    folder = _write_store(tmp_path / "s")
    raw = (folder / "1.npy").read_bytes()
    (folder / "1.npy").write_bytes(raw[:-40] if damage == "payload"
                                   else raw[:20])
    if path == "native":
        monkeypatch.setattr(tcs, "DEFAULT_THREADS", 4)
    else:
        monkeypatch.setattr(tnio, "_lib", None)
        monkeypatch.setattr(tnio, "_lib_failed", True)
    store = tcs.ChunkStore(folder)
    with pytest.raises(ChunkCorruptionError, match="unreadable npy") as e:
        store.load_chunk(1)
    assert e.value.chunk_index == 1
    with pytest.raises(ChunkCorruptionError):
        list(store.chunk_reader([0, 1, 2]))
    with pytest.raises(jcs.ChunkCorruptionError):
        jcs.ChunkStore(folder).load_chunk(1)
    q = tcs.ChunkStore(folder, quarantine_corrupt=True)
    assert [c is None for c in q.chunk_reader([0, 1, 2])] == [False, True,
                                                              False]
    assert list(tledger.load_quarantine(folder)) == [1]


@pytest.mark.parametrize("case", ["float16", "bfloat16", "float32",
                                  "readonly", "strided", "to-float16"])
def test_fast_astype_matches_jax(case):
    x = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    dtype = np.float16 if case == "to-float16" else np.float32
    if case == "bfloat16":
        raw = np.asarray(x, dtype=jnp.bfloat16)
    elif case in ("float32", "to-float16"):
        raw = x
    else:
        raw = x.astype(np.float16)
    if case == "readonly":
        raw.setflags(write=False)
    elif case == "strided":
        raw = raw[::2]
    got, ref = tnio.fast_astype(raw, dtype), jnio.fast_astype(raw, dtype)
    assert got.dtype == ref.dtype == np.dtype(dtype)
    assert got.tobytes() == ref.tobytes()
    assert got.tobytes() == raw.astype(dtype).tobytes()


def test_reads_report_their_path_and_deliver_the_same_bytes(
        tmp_path, monkeypatch, registry):
    """load_chunk reads through the threaded pread, the serial reader
    through the background prefetch, and both through np.load without
    the library: data.chunk_reads counts each path, and every path (and
    the JAX store) yields the same epoch."""
    folder = _write_store(tmp_path / "s", dtype="bfloat16")
    monkeypatch.setattr(tcs, "DEFAULT_THREADS", 4)
    store = tcs.ChunkStore(folder)
    store.load_chunk(0)
    assert _reads(registry) == {"native": 1}
    native = list(store.epoch(16, np.random.default_rng(5)))
    assert _reads(registry) == {"native": 1, "prefetch": 3}
    ref = list(jcs.ChunkStore(folder).epoch(16, np.random.default_rng(5)))
    monkeypatch.setattr(tnio, "_lib", None)
    monkeypatch.setattr(tnio, "_lib_failed", True)
    plain = list(tcs.ChunkStore(folder).epoch(16, np.random.default_rng(5)))
    assert _reads(registry) == {"native": 1, "prefetch": 3, "numpy": 3}
    assert len(native) == len(plain) == len(ref) == 12
    for a, b, c in zip(native, plain, ref):
        assert a.tobytes() == b.tobytes() == np.asarray(c).tobytes()


def test_reader_never_prefetches_a_ledger_known_chunk(tmp_path,
                                                      monkeypatch):
    folder = _write_store(tmp_path / "s")
    tledger.record_quarantine(folder, 1, "known bad", "1.npy")
    started = []
    real = tnio.NativePrefetcher.start
    monkeypatch.setattr(tnio.NativePrefetcher, "start",
                        lambda self, p: started.append(p.name)
                        or real(self, p))
    store = tcs.ChunkStore(folder, quarantine_corrupt=True)
    out = list(store.chunk_reader([0, 1, 2, 1]))
    assert [c is None for c in out] == [False, True, False, True]
    assert started == ["0.npy", "2.npy"]
    np.testing.assert_array_equal(out[2], jcs.ChunkStore(folder).load_chunk(2))
    meta = json.loads((folder / "meta.json").read_text())
    assert meta["n_chunks"] == 3
