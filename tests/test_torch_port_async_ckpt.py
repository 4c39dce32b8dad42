"""The port's asynchronous checkpoint backend (``checkpoint_backend=
"orbax"``: sparse_coding_tpu_torch/utils/orbax_ckpt.py and the sweep's
deferred swap) on the CPU.

Against the JAX package's orbax backend, on the same store and the JAX
init carried across: an uninterrupted ``dense_l1_range`` sweep ends with
final dicts within rtol 2e-4 (the JAX package's fused-vs-autodiff bound,
as in tests/test_torch_port_full_sweep.py), and after the same crash (the
third chunk decode raises) both sides' ``resume_sweep_state`` return the
same ``chunks_done`` and each resumed run is bitwise its own uninterrupted
run. Inside the port, bitwise: the two backends write byte-equal sets; a
kill while a set is being written, a preemption, a corrupt set and a
guardian rollback each end as the uninterrupted run does; a ``ckpt.save``
failure in a worker thread surfaces from the sweep and its set is never
swapped in.
"""

import json
import shutil
import signal
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding_tpu.data import chunk_store as jcs
from sparse_coding_tpu.train import sweep as jsweep
from sparse_coding_tpu_torch.config import EnsembleArgs
from sparse_coding_tpu_torch.data import chunk_store as tcs
from sparse_coding_tpu_torch.resilience import crash, faults
from sparse_coding_tpu_torch.resilience.errors import (
    CheckpointCorruptionError,
)
from sparse_coding_tpu_torch.resilience.preempt import (
    PreemptionGuard,
    SweepPreempted,
)
from sparse_coding_tpu_torch.train import experiments as texp
from sparse_coding_tpu_torch.train import sweep as tsweep
from sparse_coding_tpu_torch.utils import orbax_ckpt
from sparse_coding_tpu_torch.utils.checkpoint import save_ensemble
from test_torch_port_full_sweep import (
    assert_artifacts_match,
    assert_dicts_close,
    configs,
    jax_build,
    port_build,
    write_store,
)
from test_torch_port_resilience import (
    _assert_runs_equal,
    _cli,
    _ensemble,
    _preempting_store,
    _run,
    _states_equal,
)

ORBAX = ("--checkpoint_backend", "orbax")
SET_FILES = ("dense_l1_range_0.tensors", "dense_l1_range_0.tensors.meta.json")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("async_ckpt") / "store")


@pytest.fixture(autouse=True)
def no_plans():
    prev = faults.install_plan(None), crash.install_crash_plan(None)
    yield
    faults.install_plan(prev[0])
    crash.install_crash_plan(prev[1])


@pytest.fixture(scope="module")
def uninterrupted(store, tmp_path_factory):
    """The msgpack run of the CLI sweep that every orbax run must equal."""
    out = tmp_path_factory.mktemp("runs") / "msgpack"
    tsweep.main(_cli(store, out))
    return out


def _cfg(store, out, *extra):
    return EnsembleArgs.from_cli(_cli(store, out, *extra)[4:])


def _chunks_done(ckpt_dir: Path) -> int:
    return json.loads((ckpt_dir / SET_FILES[1]).read_text())["chunks_done"]


# -- the checkpointer ---------------------------------------------------------


def test_async_save_writes_the_msgpack_files(tmp_path):
    ens = _ensemble(seed=3)
    save_ensemble(ens, tmp_path / "sync.tensors", extra={"chunks_done": 2})
    ckptr = orbax_ckpt.AsyncEnsembleCheckpointer()
    path = orbax_ckpt.checkpoint_path(tmp_path / "async", "e_0")
    assert path.name == "e_0.tensors"
    ckptr.save(ens, path, extra={"chunks_done": 2})
    ckptr.close()
    for suffix in ("", ".meta.json"):
        assert (tmp_path / f"sync.tensors{suffix}").read_bytes() == \
            Path(f"{path}{suffix}").read_bytes()
    one_shot = tmp_path / "one.tensors"
    orbax_ckpt.save_ensemble_orbax(ens, one_shot, extra={"chunks_done": 2})
    assert one_shot.read_bytes() == path.read_bytes()
    fresh = _ensemble(seed=9)
    meta = orbax_ckpt.restore_ensemble_orbax(fresh, one_shot)
    assert meta["chunks_done"] == 2
    _states_equal(fresh.state, ens.state)


def test_save_snapshots_then_writes_in_the_background(tmp_path,
                                                      monkeypatch):
    """save returns with the write still held back; a state changed in
    place after save does not reach the file; saves to two paths are in
    their writes at once; a save to the same path waits for the one
    before it."""
    gate, entered = threading.Event(), []
    real = orbax_ckpt._write_checkpoint

    def held(path, *a):
        entered.append(path.name)
        assert gate.wait(30)
        return real(path, *a)

    ens, other = _ensemble(seed=1), _ensemble(seed=2)
    save_ensemble(ens, tmp_path / "ens.tensors")
    save_ensemble(other, tmp_path / "other.tensors")
    monkeypatch.setattr(orbax_ckpt, "_write_checkpoint", held)
    ckptr = orbax_ckpt.AsyncEnsembleCheckpointer()
    try:
        ckptr.save(ens, tmp_path / "a.tensors")
        ckptr.save(other, tmp_path / "b.tensors")
        for t in ens.state.params.values():
            t.add_(1.0)  # after the snapshot: must not reach a.tensors
        for _ in range(3000):
            if len(entered) == 2:
                break
            threading.Event().wait(0.01)
        assert sorted(entered) == ["a.tensors", "b.tensors"]
        assert not (tmp_path / "a.tensors").exists()
        again = threading.Thread(target=ckptr.save,
                                 args=(other, tmp_path / "b.tensors"))
        again.start()
        again.join(0.3)
        assert again.is_alive()  # held behind b.tensors' first write
        gate.set()
        again.join(30)
        assert not again.is_alive()
        ckptr.wait()
    finally:
        gate.set()
        ckptr.close()
    assert (tmp_path / "a.tensors").read_bytes() == \
        (tmp_path / "ens.tensors").read_bytes()
    assert (tmp_path / "b.tensors").read_bytes() == \
        (tmp_path / "other.tensors").read_bytes()


@pytest.mark.parametrize("collect", ["wait", "close"])
def test_a_worker_error_surfaces_typed(tmp_path, collect):
    ckptr = orbax_ckpt.AsyncEnsembleCheckpointer()
    with faults.inject(site="ckpt.save", nth=2, error="OSError") as plan:
        ckptr.save(_ensemble(), tmp_path / "a.tensors")
        ckptr.wait()
        ckptr.save(_ensemble(), tmp_path / "b.tensors")  # fails, later
        with pytest.raises(OSError, match="site=ckpt.save") as e:
            getattr(ckptr, collect)()
    assert isinstance(e.value, faults.InjectedFault)
    assert plan.fired == [("ckpt.save", 2)]
    assert (tmp_path / "a.tensors").exists()
    assert not (tmp_path / "b.tensors").exists()
    ckptr.close()  # raised once: nothing left to report


# -- against the JAX orbax backend --------------------------------------------


def test_uninterrupted_sweep_matches_jax_orbax(store, tmp_path):
    jcfg, tcfg = configs(store, tmp_path, tied_ae=True,
                         checkpoint_backend="orbax")
    jres = jsweep.sweep(jax_build("dense_l1_range"), jcfg, log_every=5,
                        image_metrics_every=None)
    tres = tsweep.sweep(port_build("dense_l1_range", jcfg), tcfg,
                        log_every=5, image_metrics_every=None, device="cpu")
    assert_dicts_close(jres, tres)
    assert_artifacts_match(tmp_path)
    assert not (tmp_path / "torch" / "ckpt_staging").exists()
    assert _chunks_done(tmp_path / "torch" / "ckpt") == 4


def test_same_crash_resumes_like_jax(store, tmp_path, monkeypatch):
    """The third chunk decode raises on both sides (one stream, so chunks
    decode in order): both sweeps crash at chunk 2 with the chunk-2 set
    swapped in by the finally, both resume_sweep_state return the same
    chunks_done, and each resumed run is bitwise its own uninterrupted
    run."""
    full = {}
    for side in ("jax", "torch"):
        jcfg, tcfg = configs(store, tmp_path / f"full_{side}", tied_ae=True,
                             checkpoint_backend="orbax", ingest_streams=1)
        full[side] = (jsweep.sweep(jax_build("dense_l1_range"), jcfg,
                                   log_every=5, image_metrics_every=None)
                      if side == "jax" else
                      tsweep.sweep(port_build("dense_l1_range", jcfg), tcfg,
                                   log_every=5, image_metrics_every=None,
                                   device="cpu"))
    jcfg, tcfg = configs(store, tmp_path / "crash", tied_ae=True,
                         checkpoint_backend="orbax", ingest_streams=1)
    calls = {"jax": 0, "torch": 0}

    def flaky(side, real):
        def finish(self, *a):
            calls[side] += 1
            if calls[side] >= 3:  # persistent: a degrade retry fails too
                raise RuntimeError("simulated crash")
            return real(self, *a)
        return finish

    monkeypatch.setattr(jcs.ChunkStore, "_finish_raw",
                        flaky("jax", jcs.ChunkStore._finish_raw))
    monkeypatch.setattr(tcs.ChunkStore, "_finish_raw",
                        flaky("torch", tcs.ChunkStore._finish_raw))
    with pytest.raises(RuntimeError, match="simulated crash"):
        jsweep.sweep(jax_build("dense_l1_range"), jcfg, log_every=5,
                     image_metrics_every=None)
    build = port_build("dense_l1_range", jcfg)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tsweep.sweep(build, tcfg, log_every=5, image_metrics_every=None,
                     device="cpu")
    monkeypatch.undo()
    done_jax, _ = jsweep.resume_sweep_state(
        jax_build("dense_l1_range")(jcfg, None), tmp_path / "crash" / "jax")
    done_port, _ = tsweep.resume_sweep_state(
        build(tcfg, None, device="cpu"), tmp_path / "crash" / "torch")
    assert done_port == done_jax == 2
    for side in ("jax", "torch"):
        assert not (tmp_path / "crash" / side / "ckpt_staging").exists()
    jres = jsweep.sweep(jax_build("dense_l1_range"), jcfg, log_every=5,
                        image_metrics_every=None, resume=True)
    tres = tsweep.sweep(build, tcfg, log_every=5, image_metrics_every=None,
                        device="cpu", resume=True)
    for side, res in (("jax", jres), ("torch", tres)):
        for (a, ha), (b, hb) in zip(full[side]["dense_l1_range"],
                                    res["dense_l1_range"]):
            assert ha == hb
            for f in ("dictionary", "encoder_bias"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                    err_msg=f"{side} {f}")
    assert_dicts_close(jres, tres)


# -- inside the port, bitwise -------------------------------------------------


def test_backends_write_byte_equal_sets(store, tmp_path, uninterrupted):
    out = tmp_path / "orbax"
    tsweep.main(_cli(store, out, *ORBAX))
    _assert_runs_equal(out, uninterrupted)
    for name in SET_FILES:
        assert (out / "ckpt_prev" / name).read_bytes() == \
            (uninterrupted / "ckpt_prev" / name).read_bytes()
    assert not (out / "ckpt_staging").exists()


@pytest.mark.parametrize("site", ["sweep.chunk", "ckpt.swap"])
def test_kill_while_a_set_is_written_resumes_bitwise(store, tmp_path,
                                                     uninterrupted, site):
    """SIGKILL at the 3rd hit: at sweep.chunk the chunk-3 set has been
    issued (its writes may be running) but not swapped in, so ckpt/ holds
    the chunk-2 set; at ckpt.swap (the chunk-3 set's swap, at the next
    round) only ckpt_prev/ is left. Both resume from chunk 2 and end
    bitwise."""
    out = tmp_path / "killed"
    killed = _run(_cli(store, out, *ORBAX), crash_plan=f"{site}:nth=3")
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-3000:]
    assert f"SIGKILL at site {site!r}" in killed.stderr
    if site == "sweep.chunk":
        assert _chunks_done(out / "ckpt") == 2
        assert (out / "ckpt_staging").exists()
    else:
        assert not (out / "ckpt").exists()
        assert _chunks_done(out / "ckpt_prev") == 2
    entries = texp.dense_l1_range_experiment(_cfg(store, out), device="cpu")
    assert tsweep.resume_sweep_state(entries, out)[0] == 2
    tsweep.main(_cli(store, out, *ORBAX, "--resume", "true"))
    _assert_runs_equal(out, uninterrupted)


def test_preemption_swaps_the_pending_set_and_resumes_bitwise(
        store, tmp_path, uninterrupted, monkeypatch):
    out = tmp_path / "pre"
    cfg = _cfg(store, out, *ORBAX).replace(ingest_streams=1)
    guard = PreemptionGuard()
    monkeypatch.setattr(tsweep, "PreemptionGuard", lambda: guard)
    with pytest.raises(SweepPreempted) as exc:
        tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                     store=_preempting_store(store, guard.request),
                     image_metrics_every=None, log_every=4)
    monkeypatch.undo()
    assert 0 < exc.value.chunks_done < 4
    # the set issued at the preempted boundary was swapped in on the way out
    assert _chunks_done(out / "ckpt") == exc.value.chunks_done
    assert not (out / "ckpt_staging").exists()
    tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                 resume=True, image_metrics_every=None, log_every=4)
    _assert_runs_equal(out, uninterrupted)


def test_corrupt_newest_set_falls_back_to_the_previous(store, tmp_path):
    out = tmp_path / "c"
    cfg = _cfg(store, out, *ORBAX).replace(n_chunks=2)
    tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                 image_metrics_every=None)
    path = out / "ckpt" / SET_FILES[0]
    blob = bytearray(path.read_bytes())
    blob[-7] ^= 0x01
    path.write_bytes(bytes(blob))
    entries = texp.dense_l1_range_experiment(cfg, device="cpu")
    with pytest.raises(CheckpointCorruptionError):
        orbax_ckpt.restore_ensemble_orbax(entries[0][0], path)
    done, rng_state = tsweep.resume_sweep_state(entries, out)
    assert done == 1 and rng_state is not None  # ckpt_prev/: one chunk


def test_guardian_rollback_under_orbax_equals_msgpack(store, tmp_path):
    """A NaN batch in chunk position 1 rolls back to the last-good set
    (under orbax: the issued set is swapped in first) and quarantines the
    chunk; guardian.json, the final dicts and the final set equal the
    msgpack run's."""
    runs = {}
    for backend in ("msgpack", "orbax"):
        folder = tmp_path / f"store_{backend}"
        shutil.copytree(store, folder)
        out = tmp_path / backend
        cfg = _cfg(folder, out, "--checkpoint_backend", backend)
        with faults.inject(site="sweep.anomaly", nth=7, mode="nan"):
            runs[backend] = tsweep.sweep(
                texp.dense_l1_range_experiment, cfg, device="cpu",
                image_metrics_every=None, log_every=4)
    a, b = tmp_path / "msgpack", tmp_path / "orbax"
    ledger = json.loads((b / "guardian.json").read_text())
    assert list(ledger["rollbacks"]) == ["chunk[1]"]
    assert (a / "guardian.json").read_bytes() == \
        (b / "guardian.json").read_bytes()
    _assert_runs_equal(b, a)
    for (x, _), (y, _) in zip(runs["msgpack"]["dense_l1_range"],
                              runs["orbax"]["dense_l1_range"]):
        assert torch.equal(x.dictionary, y.dictionary)


@pytest.mark.parametrize("nth", [2, 4], ids=["next-round", "finally"])
def test_a_failed_write_surfaces_from_the_sweep(store, tmp_path, nth):
    """ckpt.save fails in the worker writing set ``nth`` (one ensemble, so
    one save a set): the sweep raises the typed error — at the next
    round's wait, or from the finally for the last set — and ckpt/ keeps
    the set before; the failed set is never swapped in."""
    out = tmp_path / "f"
    cfg = _cfg(store, out, *ORBAX)
    with faults.inject(site="ckpt.save", nth=nth, error="OSError") as plan:
        with pytest.raises(OSError, match="site=ckpt.save") as e:
            tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                         image_metrics_every=None, log_every=4)
    assert isinstance(e.value, faults.InjectedFault)
    assert plan.fired == [("ckpt.save", nth)]
    assert _chunks_done(out / "ckpt") == nth - 1
    assert not (out / "ckpt_staging" / SET_FILES[0]).exists()
