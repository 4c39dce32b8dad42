"""The port's resilience layer on the sweep path: fault and crash plans
(against the JAX parsers), full-state checkpoints, kill-and-resume and
preemption (bitwise inside the port), the training guardian (its
decisions against the JAX guardian's on the same drills), the chunk
store's fault sites and multi-stream ingest, the obs sink and probe, and
the metrics the image panels use (against the JAX versions).

Sweeps here run the port on the CPU (its kernels' plain versions). A
guardian comparison feeds both sides the same numpy store (each side its
own copy: a drill writes the store's quarantine ledger) and the JAX
experiment's init members carried into the port.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding_tpu.resilience import crash as jcrash
from sparse_coding_tpu.resilience import faults as jfaults
from sparse_coding_tpu.resilience.errors import (
    DivergenceHaltError as JaxDivergenceHaltError,
)
from sparse_coding_tpu.train import sweep as jsweep
from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.config import EnsembleArgs
from sparse_coding_tpu_torch.data import chunk_store as tcs
from sparse_coding_tpu_torch.data import ledger as tledger
from sparse_coding_tpu_torch.data.ingest import chunk_stream
from sparse_coding_tpu_torch.resilience import crash, faults, lease
from sparse_coding_tpu_torch.resilience.errors import (
    CheckpointCorruptionError,
    ChunkCorruptionError,
    DivergenceHaltError,
    UnknownFaultSiteError,
)
from sparse_coding_tpu_torch.resilience.preempt import (
    PreemptionGuard,
    SweepPreempted,
)
from sparse_coding_tpu_torch.resilience.retry import retry_io
from sparse_coding_tpu_torch.train import experiments as texp
from sparse_coding_tpu_torch.train import sweep as tsweep
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts
from sparse_coding_tpu_torch.utils.checkpoint import (
    restore_ensemble,
    save_ensemble,
)
from test_torch_port_full_sweep import (
    BATCH,
    D,
    configs,
    write_store,
)

REPO = Path(__file__).resolve().parents[1]
PLANS = [
    "chunk.read:nth=3,mode=error,error=OSError",
    "chunk.read:nth=2,count=0,mode=corrupt,seed=5;ckpt.save:nth=1",
    "sweep.anomaly:nth=7,mode=nan;sweep.anomaly:nth=3,error=RuntimeError,"
    "message=member=1",
    '[{"site": "ingest.decode", "nth": 2, "mode": "nan", "seed": 9}, '
    '{"site": "ledger.write"}]',
    '{"site": "ckpt.restore", "count": 4, "error": "TimeoutError"}',
]
CRASH_PLANS = ["sweep.chunk:nth=3", "ckpt.swap:nth=2,count=0;chunk.flushed",
               '[{"site": "guardian.rollback", "nth": 1}]',
               '{"site": "store.finalize", "count": 2}']


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("resilience") / "store")


@pytest.fixture(autouse=True)
def no_plans():
    """Every test starts and ends with no fault or crash plan installed."""
    prev = faults.install_plan(None), crash.install_crash_plan(None)
    yield
    faults.install_plan(prev[0])
    crash.install_crash_plan(prev[1])


def _spec_fields(spec, names):
    return tuple(getattr(spec, n) for n in names)


# -- plans -------------------------------------------------------------------


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parses_like_jax(text):
    names = ("site", "nth", "count", "mode", "error", "message", "seed")
    ours = [_spec_fields(s, names) for s in faults.parse_fault_plan(text).specs]
    theirs = [_spec_fields(s, names)
              for s in jfaults.parse_fault_plan(text).specs]
    assert ours == theirs and ours


@pytest.mark.parametrize("text", CRASH_PLANS)
def test_crash_plan_parses_like_jax(text):
    ours = [_spec_fields(s, ("site", "nth", "count"))
            for s in crash.parse_crash_plan(text).specs]
    theirs = [_spec_fields(s, ("site", "nth", "count"))
              for s in jcrash.parse_crash_plan(text).specs]
    assert ours == theirs and ours


@pytest.mark.parametrize("text, parse", [
    ("chunk.raed:nth=1", faults.parse_fault_plan),
    ("sweep.chnk:nth=1", crash.parse_crash_plan),
    ("chunk.read:nht=1", faults.parse_fault_plan),
    ("chunk.read:mode=melt", faults.parse_fault_plan),
])
def test_bad_plans_raise_at_parse(text, parse):
    with pytest.raises(ValueError):
        parse(text)
    if "raed" in text or "chnk" in text:
        with pytest.raises(UnknownFaultSiteError):
            parse(text)


def test_env_plans_load_once(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "chunk.read:nth=2")
    monkeypatch.setenv(crash.ENV_VAR, "sweep.chunk:nth=2")
    faults.install_plan(None)
    faults._env_checked = False
    crash.install_crash_plan(None)
    crash._env_checked = False
    assert faults.active_plan().specs[0].nth == 2
    assert crash.active_crash_plan().specs[0].site == "sweep.chunk"


def test_fault_modes_on_arrays_and_bf16_tensors():
    arr = np.arange(8, dtype=np.float32)
    bf = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
    with faults.inject(site="chunk.read", nth=2, count=2, mode="nan",
                       seed=3) as plan:
        assert faults.fault_point("chunk.read", arr) is arr
        out = faults.fault_point("chunk.read", arr)
        tout = faults.fault_point("chunk.read", bf)
        assert faults.fault_point("chunk.read", arr) is arr
    assert np.isnan(out[3]) and np.isfinite(arr).all()
    assert tout.dtype == torch.bfloat16 and torch.isnan(tout[3])
    assert torch.isfinite(bf).all()
    assert plan.fired == [("chunk.read", 2), ("chunk.read", 3)]
    with faults.inject(site="chunk.read", mode="corrupt", seed=1):
        flipped = faults.fault_point("chunk.read", arr)
    assert (flipped.view(np.uint8) != arr.view(np.uint8)).sum() == 1
    with faults.inject(site="chunk.read", mode="nan"):
        with pytest.raises(ValueError, match="NaN"):
            faults.fault_point("chunk.read", np.arange(3))
    with faults.inject(site="ckpt.save", error="TimeoutError"):
        with pytest.raises(TimeoutError) as e:
            faults.fault_point("ckpt.save")
    assert isinstance(e.value, faults.InjectedFault)


def test_crash_barrier_fires_on_its_hit(monkeypatch):
    killed = []
    monkeypatch.setattr(crash, "_kill_self", killed.append)
    crash.install_crash_plan(crash.parse_crash_plan("sweep.chunk:nth=2"))
    for _ in range(3):
        crash.crash_barrier("sweep.chunk")
        crash.crash_barrier("ckpt.swap")
    assert killed == ["sweep.chunk"]


def test_retry_io_is_bounded():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_io(flaky, attempts=3, sleep=lambda s: None) == "ok"
    calls.clear()
    with pytest.raises(OSError):
        retry_io(lambda: flaky() and (_ for _ in ()).throw(OSError("x")),
                 attempts=2, sleep=lambda s: None)
    with pytest.raises(ChunkCorruptionError):  # corruption is never retried
        retry_io(lambda: (_ for _ in ()).throw(
            ChunkCorruptionError(0, "x", "bad")), attempts=5)


# -- the chunk store's sites and ingest --------------------------------------


def test_chunk_read_corruption_caught_by_digest(store, tmp_path):
    folder = tmp_path / "s"
    shutil.copytree(store, folder)
    with faults.inject(site="chunk.read", nth=1, mode="corrupt", seed=11):
        with pytest.raises(ChunkCorruptionError, match="digest mismatch"):
            tcs.ChunkStore(folder).load_chunk(0)
    with faults.inject(site="chunk.read", nth=1, count=2, error="OSError"):
        assert tcs.ChunkStore(folder).load_chunk(1).shape == (256, D)
    with faults.inject(site="chunk.read", count=0, error="OSError"):
        with pytest.raises(OSError):
            tcs.ChunkStore(folder).load_chunk(1)


def test_chunk_write_retried_and_crash_barriers(tmp_path, monkeypatch):
    killed = []
    monkeypatch.setattr(crash, "_kill_self", killed.append)
    crash.install_crash_plan(crash.parse_crash_plan(
        "chunk.flushed:nth=2;store.finalize"))
    w = tcs.ChunkWriter(tmp_path / "w", 4, chunk_size_gb=8 * 4 * 4 / 2**30,
                        dtype="float32")
    with faults.inject(site="chunk.write", nth=1, error="OSError"):
        w.add(np.ones((24, 4), np.float32))
        w.finalize()
    assert killed == ["chunk.flushed", "store.finalize"]
    assert tcs.ChunkStore(tmp_path / "w").n_chunks == 3
    with faults.inject(site="chunk.write", count=0, error="OSError"):
        with pytest.raises(OSError):
            tcs.ChunkWriter(tmp_path / "v", 4, dtype="float32",
                            chunk_size_gb=8 * 4 * 4 / 2**30).add(
                np.ones((8, 4), np.float32))


def test_ledger_write_fault_degrades_to_memory(store, tmp_path):
    folder = tmp_path / "s"
    shutil.copytree(store, folder)
    raw = bytearray((folder / "2.npy").read_bytes())
    raw[-5] ^= 0x40
    (folder / "2.npy").write_bytes(bytes(raw))
    s = tcs.ChunkStore(folder, quarantine_corrupt=True)
    with faults.inject(site="ledger.write", error="OSError"):
        got = list(s.chunk_reader([0, 2, 1]))
    assert got[1] is None and got[0] is not None and s.quarantined == {2}
    assert tledger.load_quarantine(folder) == {}


@pytest.mark.parametrize("streams", [1, 3])
def test_chunk_stream_delivers_the_serial_data(store, streams):
    s = tcs.ChunkStore(store)
    order = [3, 0, 2, 1, 0]
    got = list(chunk_stream(s, order, streams=streams))
    for ci, chunk in zip(order, got):
        np.testing.assert_array_equal(chunk, s.load_chunk(ci))
    bf = list(chunk_stream(s, order[:2], dtype=torch.bfloat16,
                           streams=streams))
    assert bf[0].dtype == torch.bfloat16
    torch.testing.assert_close(bf[0].float(),
                               torch.from_numpy(s.load_chunk(3)),
                               rtol=2**-8, atol=0)


def test_ingest_decode_death_degrades_with_identical_data(store):
    s = tcs.ChunkStore(store)
    order = [1, 3, 0, 2]
    before = obs.counter("ingest.degraded").value
    with faults.inject(site="ingest.decode", nth=2, error="RuntimeError"):
        got = list(chunk_stream(s, order, streams=2))
    assert obs.counter("ingest.degraded").value == before + 1
    for ci, chunk in zip(order, got):
        np.testing.assert_array_equal(chunk, s.load_chunk(ci))


def test_ingest_decode_nan_is_quarantined_positionally(store, tmp_path):
    folder = tmp_path / "s"
    shutil.copytree(store, folder)
    s = tcs.ChunkStore(folder, quarantine_corrupt=True)
    with faults.inject(site="ingest.decode", nth=1, mode="nan"):
        got = list(chunk_stream(s, [2, 0], streams=2))
    # hit 1 is whichever decode ran first; exactly one position is a hole
    assert sum(c is None for c in got) == 1 and len(got) == 2
    assert set(tledger.load_quarantine(folder)) == s.quarantined


# -- checkpoints ---------------------------------------------------------------


def _ensemble(seed=0, n=3, device="cpu"):
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import FunctionalSAE

    g = torch.Generator().manual_seed(seed)
    members = [FunctionalSAE.init(g, D, 64, l1_alpha=1e-3 * (i + 1))
               for i in range(n)]
    return Ensemble(members, FunctionalSAE, lr=1e-3, device=device)


def _states_equal(a, b):
    for tree in ("params", "buffers", "mu", "nu"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        assert ta.keys() == tb.keys()
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (tree, k)
    for f in ("count", "lrs", "step", "live"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_checkpoint_roundtrip_is_exact_and_deterministic(tmp_path):
    ens = _ensemble()
    x = torch.randn(64, D, generator=torch.Generator().manual_seed(1))
    ens.step_batch(x)
    ens.freeze_members([1])
    save_ensemble(ens, tmp_path / "a.tensors", extra={"chunks_done": 3})
    save_ensemble(ens, tmp_path / "b.tensors", extra={"chunks_done": 3})
    assert (tmp_path / "a.tensors").read_bytes() == \
        (tmp_path / "b.tensors").read_bytes()
    fresh = _ensemble(seed=5)
    meta = restore_ensemble(fresh, tmp_path / "a.tensors")
    assert meta["chunks_done"] == 3
    _states_equal(fresh.state, ens.state)
    assert list(fresh.live_mask()) == [True, False, True]
    ens.step_batch(x)
    fresh.step_batch(x)
    _states_equal(fresh.state, ens.state)


def test_checkpoint_faults_and_corruption(tmp_path):
    ens = _ensemble()
    path = tmp_path / "c.tensors"
    save_ensemble(ens, path)
    before = path.read_bytes()
    with faults.inject(site="ckpt.save", error="OSError"):
        with pytest.raises(OSError):
            save_ensemble(_ensemble(seed=9), path)
    assert path.read_bytes() == before  # the previous checkpoint intact
    with faults.inject(site="ckpt.restore", error="OSError"):
        with pytest.raises(OSError):
            restore_ensemble(_ensemble(), path)
    blob = bytearray(before)
    blob[len(blob) // 2] ^= 0x01
    path.write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorruptionError, match="sha256"):
        restore_ensemble(_ensemble(), path)
    # a payload that is not a tensor file, with no digest to catch it
    path.write_bytes(b"garbage")
    path.with_suffix(".tensors.meta.json").write_text("{}")
    with pytest.raises(CheckpointCorruptionError, match="does not load"):
        restore_ensemble(_ensemble(), path)
    # a state of another shape does not load into this ensemble
    save_ensemble(_ensemble(n=2), path)
    with pytest.raises(CheckpointCorruptionError, match="does not load"):
        restore_ensemble(_ensemble(), path)


# -- kill, resume, preemption --------------------------------------------------


def _cli(store, out, *extra):
    return ["--experiment", "dense_l1_range", "--device", "cpu",
            "--dataset_folder", str(store), "--output_folder", str(out),
            "--batch_size", str(BATCH), "--learned_dict_ratio", "2",
            "--n_chunks", "4", "--image_metrics_every", "none",
            "--log_every", "4", *extra]


def _run(args, crash_plan=None):
    from conftest import stripped_cpu_subprocess_env

    env = stripped_cpu_subprocess_env()
    env.pop(faults.ENV_VAR, None)
    env.pop(crash.ENV_VAR, None)
    if crash_plan:
        env[crash.ENV_VAR] = crash_plan
    return subprocess.run(
        [sys.executable, "-m", "sparse_coding_tpu_torch.train.sweep", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def _assert_runs_equal(a: Path, b: Path):
    """Final learned dicts, evals and checkpoint set bitwise equal."""
    for rel in ("_3/dense_l1_range_learned_dicts.pkl",):
        for (la, ha), (lb, hb) in zip(load_learned_dicts(a / rel),
                                      load_learned_dicts(b / rel)):
            assert ha == hb
            for f in ("encoder", "encoder_bias", "dictionary"):
                assert torch.equal(getattr(la, f), getattr(lb, f)), f
    assert (a / "_3/dense_l1_range_eval.json").read_text() == \
        (b / "_3/dense_l1_range_eval.json").read_text()
    for name in ("dense_l1_range_0.tensors",
                 "dense_l1_range_0.tensors.meta.json"):
        assert (a / "ckpt" / name).read_bytes() == \
            (b / "ckpt" / name).read_bytes(), name


@pytest.fixture(scope="module")
def uninterrupted(store, tmp_path_factory):
    out = tmp_path_factory.mktemp("runs") / "full"
    done = _run(_cli(store, out))
    assert done.returncode == 0, done.stderr[-3000:]
    return out


@pytest.mark.parametrize("site", ["sweep.chunk", "ckpt.swap"])
def test_sigkill_then_resume_is_bitwise(store, tmp_path, uninterrupted,
                                        site):
    out = tmp_path / "killed"
    killed = _run(_cli(store, out), crash_plan=f"{site}:nth=3")
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-3000:]
    assert f"SIGKILL at site {site!r}" in killed.stderr
    if site == "ckpt.swap":
        # killed between the renames: only the previous set survives
        assert not (out / "ckpt").exists() and (out / "ckpt_prev").exists()
    resumed = _run(_cli(store, out, "--resume", "true"))
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    _assert_runs_equal(out, uninterrupted)


def _preempting_store(folder, on_load, at=2):
    """A store whose ``at``-th chunk decode calls ``on_load`` (the chunk is
    then in flight, as a signal landing mid-chunk would find it).
    ``_finish_raw`` is the gate every read goes through: foreground or
    prefetched, native or np.load."""
    s = tcs.ChunkStore(folder, quarantine_corrupt=True)
    real, calls = s._finish_raw, []

    def finish_raw(i, raw, dtype, path):
        calls.append(i)
        if len(calls) == at:
            on_load()
        return real(i, raw, dtype, path)

    s._finish_raw = finish_raw
    return s


@pytest.mark.parametrize("how", ["request", "sigterm"])
def test_preemption_checkpoints_and_resumes_bitwise(store, tmp_path,
                                                    uninterrupted, how,
                                                    monkeypatch):
    """SIGTERM — or ``PreemptionGuard.request`` on the sweep's guard —
    while chunk 2 is in flight: the chunk finishes, a set is written,
    SweepPreempted propagates, and resume=True ends bitwise."""
    out = tmp_path / "pre"
    cfg = EnsembleArgs.from_cli(_cli(store, out)[4:])
    cfg = cfg.replace(ingest_streams=1)  # loads in order, one at a time
    if how == "request":
        guard = PreemptionGuard()
        monkeypatch.setattr(tsweep, "PreemptionGuard", lambda: guard)
        on_load = guard.request
    else:
        on_load = lambda: os.kill(os.getpid(), signal.SIGTERM)
    with pytest.raises(SweepPreempted) as exc:
        tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                     store=_preempting_store(store, on_load),
                     image_metrics_every=None, log_every=4)
    monkeypatch.undo()
    assert 0 < exc.value.chunks_done < 4
    assert (out / "ckpt").exists() and not (out / "ckpt_staging").exists()
    tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                 resume=True, image_metrics_every=None, log_every=4)
    _assert_runs_equal(out, uninterrupted)


def test_corrupt_checkpoint_falls_back_to_the_previous_set(store, tmp_path):
    out = tmp_path / "c"
    cfg = EnsembleArgs.from_cli(_cli(store, out)[4:]).replace(n_chunks=2)
    tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                 image_metrics_every=None)
    path = out / "ckpt" / "dense_l1_range_0.tensors"
    blob = bytearray(path.read_bytes())
    blob[-7] ^= 0x01
    path.write_bytes(bytes(blob))
    entries = texp.dense_l1_range_experiment(cfg, device="cpu")
    with pytest.raises(CheckpointCorruptionError):
        restore_ensemble(entries[0][0], path)
    done, rng_state = tsweep.resume_sweep_state(entries, out)
    assert done == 1 and rng_state is not None  # ckpt_prev/: one chunk
    prev = out / "ckpt_prev" / "dense_l1_range_0.tensors"
    prev.write_bytes(prev.read_bytes()[:-3])
    with pytest.raises(CheckpointCorruptionError):
        tsweep.resume_sweep_state(entries, out)


# -- the guardian against the JAX guardian -------------------------------------


def _guardian_runs(store, tmp_path, l1s, fault, **over):
    """The same drill on both sides, each over its own copy of the store;
    returns ((jax result or error), (port result or error), the two
    output folders)."""
    outs = []
    for side in ("jax", "torch"):
        folder = tmp_path / f"store_{side}"
        shutil.copytree(store, folder)
        outs.append(folder)
    jcfg, tcfg = configs(outs[0], tmp_path, tied_ae=True, **over)
    tcfg = tcfg.replace(dataset_folder=str(outs[1]))
    kw = dict(l1_range=list(l1s), activation_dim=D)
    jbuild = lambda c, m: jax_build_l1(c, m, **kw)
    inits = {n: e.unstack() for e, _, n in jbuild(jcfg, None)}
    tbuild = lambda c, m, device=None: texp.dense_l1_range_experiment(
        c, m, inits=inits, device=device, **kw)
    results = []
    for fmod, run in ((jfaults, lambda: jsweep.sweep(
            jbuild, jcfg, log_every=4, image_metrics_every=None)),
            (faults, lambda: tsweep.sweep(
                tbuild, tcfg, log_every=4, image_metrics_every=None,
                device="cpu"))):
        with fmod.inject(*[fmod.FaultSpec(**f) for f in fault]):
            try:
                results.append(run())
            except (DivergenceHaltError, JaxDivergenceHaltError) as e:
                results.append(e)
    ledgers = [json.loads((tmp_path / s / "guardian.json").read_text())
               for s in ("jax", "torch")]
    return results, ledgers, outs, tbuild, tcfg


def jax_build_l1(c, m, **kw):
    from sparse_coding_tpu.train.experiments import dense_l1_range_experiment

    return dense_l1_range_experiment(c, m, **kw)


def _strip_digest(ledger):
    return {k: v for k, v in ledger.items() if k != "payload_sha256"}


def test_guardian_member_drill_matches_jax(store, tmp_path):
    """member=1 poisoned at the 3rd batch: both sides quarantine member 1
    (the same ledger, no rollback) and tag it diverged; in the port every
    other member is bitwise the undrilled run's."""
    fault = [dict(site="sweep.anomaly", nth=3, error="RuntimeError",
                  message="member=1")]
    (jres, tres), (jl, tl), _, tbuild, tcfg = _guardian_runs(
        store, tmp_path, (1e-3, 2e-3, 4e-3), fault)
    assert _strip_digest(tl) == _strip_digest(jl)
    assert list(tl["members"]) == ["dense_l1_range/dense_l1_range/1"]
    assert tl["rollbacks"] == {}
    tags = [bool(h.get("diverged")) for _, h in tres["dense_l1_range"]]
    assert tags == [bool(h.get("diverged"))
                    for _, h in jres["dense_l1_range"]] == [False, True, False]
    clean = tsweep.sweep(tbuild, tcfg.replace(
        output_folder=str(tmp_path / "clean")), log_every=4,
        image_metrics_every=None, device="cpu")
    for i, ((a, _), (b, _)) in enumerate(zip(tres["dense_l1_range"],
                                             clean["dense_l1_range"])):
        if i != 1:
            assert torch.equal(a.dictionary, b.dictionary), i
    art = load_learned_dicts(tmp_path / "torch/_3/dense_l1_range_"
                             "learned_dicts.pkl", skip_diverged=True)
    assert len(art) == 2


def test_guardian_nan_drill_rolls_back_like_jax(store, tmp_path):
    """A NaN batch in chunk position 1: both sides roll back once and
    quarantine the same chunk; the port's final dicts are bitwise those of
    a port run over a store where that chunk was always quarantined."""
    fault = [dict(site="sweep.anomaly", nth=7, mode="nan")]
    (jres, tres), (jl, tl), (jstore, tstore), tbuild, tcfg = _guardian_runs(
        store, tmp_path, (1e-3, 2e-3), fault)
    assert _strip_digest(tl) == _strip_digest(jl)
    bad = list(tledger.load_quarantine(tstore))
    assert bad == list(tledger.load_quarantine(jstore)) and len(bad) == 1
    assert tl["rollbacks"] == {"chunk[1]": {"chunk": bad[0], "count": 1,
                                            "incident": "poisoned-data"}}
    gold = tmp_path / "store_gold"
    shutil.copytree(store, gold)
    tledger.record_quarantine(gold, bad[0], "pre-quarantined", f"{bad[0]}.npy")
    golden = tsweep.sweep(tbuild, tcfg.replace(
        dataset_folder=str(gold), output_folder=str(tmp_path / "gold")),
        log_every=4, image_metrics_every=None, device="cpu")
    for (a, ha), (b, _) in zip(tres["dense_l1_range"],
                               golden["dense_l1_range"]):
        assert not ha.get("diverged")
        assert torch.equal(a.dictionary, b.dictionary)
        assert torch.equal(a.encoder_bias, b.encoder_bias)


@pytest.mark.parametrize("drill, diagnosis", [
    (dict(site="sweep.anomaly", nth=1, count=0, mode="nan"), "poisoned-data"),
    (dict(site="sweep.anomaly", nth=3, error="RuntimeError",
          message="member=0"), "hyperparameter"),
], ids=["persistent-poison", "fraction-breach"])
def test_guardian_halts_like_jax(store, tmp_path, drill, diagnosis):
    (jerr, terr), (jl, tl), _, _, _ = _guardian_runs(
        store, tmp_path, (1e-3, 2e-3), [drill], guardian_rollback_budget=2)
    assert isinstance(jerr, JaxDivergenceHaltError)
    assert isinstance(terr, DivergenceHaltError)
    assert terr.diagnosis == jerr.diagnosis == diagnosis
    assert terr.site == jerr.site
    assert _strip_digest(tl) == _strip_digest(jl)
    assert tl["halt"]["diagnosis"] == diagnosis


def test_guardian_fresh_run_drops_a_stale_ledger(store, tmp_path):
    cfg = EnsembleArgs.from_cli(_cli(store, tmp_path / "o")[4:]).replace(
        n_chunks=2)
    with faults.inject(site="sweep.anomaly", nth=2, error="RuntimeError",
                       message="member=3"):
        first = tsweep.sweep(texp.dense_l1_range_experiment, cfg,
                             device="cpu", image_metrics_every=None)
    assert first["dense_l1_range"][3][1]["diverged"]
    second = tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                          image_metrics_every=None)
    assert not any(h.get("diverged") for _, h in second["dense_l1_range"])
    assert not (tmp_path / "o" / "guardian.json").exists()


# -- obs, lease, metrics --------------------------------------------------------


def test_sweep_spans_metrics_and_probe_reach_the_sink(store, tmp_path):
    sink = obs.EventSink(tmp_path / "obs" / "run.jsonl")
    prev_sink = obs.configure_sink(sink)
    prev_reg = obs.set_registry(obs.Registry())
    try:
        cfg = EnsembleArgs.from_cli(_cli(store, tmp_path / "o")[4:]).replace(
            perf_probe_every=2)
        tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                     image_metrics_every=None, log_every=100)
    finally:
        obs.set_registry(prev_reg)
        obs.configure_sink(prev_sink)
        sink.close()
    events, skipped = obs.scan_events(tmp_path / "obs" / "run.jsonl")
    assert skipped == 0
    chunks = [e for e in events if e.get("span") == "sweep.chunk"]
    assert [e["index"] for e in chunks] == [0, 1, 2, 3]
    assert all(e["rows"] == 256 and e["train_s"] > 0 for e in chunks)
    assert len([e for e in events if e.get("span") == "sweep.checkpoint"]) \
        == 4
    samples = [e for e in events if e["kind"] == "perf.sample"]
    # off the card: walls against the reference peak, labeled cpu
    assert samples and all(e["backend"] == "cpu" and "mfu" in e
                           for e in samples)
    gauges = [e for e in events if e["kind"] == "metrics"][-1]["registry"][
        "gauges"]
    assert gauges["train.mfu{backend=cpu,path=train_step_tiled}"]["value"] > 0
    # 4 steps a chunk, all inside the timer's warmup of 3 + 1
    assert gauges["sweep.measured_steps"]["value"] == 0


def test_event_sink_skips_a_torn_tail(tmp_path):
    sink = obs.EventSink(tmp_path / "e.jsonl")
    sink.emit({"kind": "a"})
    with faults.inject(site="obs.sink.write", error="OSError"):
        assert not sink.emit({"kind": "dropped"})
    sink.emit({"kind": "b"})
    sink.close()
    with open(tmp_path / "e.jsonl", "ab") as fh:
        fh.write(b'{"kind": "torn"')
    events, skipped = obs.scan_events(tmp_path / "e.jsonl")
    assert [e["kind"] for e in events] == ["a", "b"] and skipped == 1


def test_lease_beats_from_the_environment(tmp_path, monkeypatch):
    path = tmp_path / "lease.json"
    monkeypatch.setenv(lease.ENV_PATH, str(path))
    monkeypatch.setenv(lease.ENV_INTERVAL, "0")
    prev = lease.configure(None)
    lease._env_checked = False
    try:
        lease.beat()
        lease.beat()
        info = json.loads(path.read_text())
        assert info["pid"] == os.getpid() and info["seq"] >= 2
    finally:
        lease.configure(prev)


def test_metrics_match_jax():
    from sparse_coding_tpu.metrics import core as jm
    from sparse_coding_tpu.models.learned_dict import TiedSAE as JTied
    from sparse_coding_tpu_torch.metrics import core as tm
    from sparse_coding_tpu_torch.models.learned_dict import TiedSAE

    rs = np.random.default_rng(7)
    dicts = [(rs.normal(size=(48, D)).astype(np.float32),
              (rs.normal(size=48) * 0.3).astype(np.float32))
             for _ in range(4)]
    x = rs.normal(size=(512, D)).astype(np.float32)
    jd = [JTied(dictionary=w, encoder_bias=b) for w, b in dicts]
    td = [TiedSAE(dictionary=torch.from_numpy(w),
                  encoder_bias=torch.from_numpy(b)) for w, b in dicts]
    np.testing.assert_allclose(tm.mmcs_from_list(td).numpy(),
                               np.asarray(jm.mmcs_from_list(jd)), rtol=1e-6)
    np.testing.assert_allclose(
        tm.mean_nonzero_activations(td[0], torch.from_numpy(x)).numpy(),
        np.asarray(jm.mean_nonzero_activations(jd[0], x)), rtol=1e-6)


def test_dispatch_job_on_chunk_trains_every_ensemble(store):
    from sparse_coding_tpu_torch.train.dispatch import (
        collect_lite,
        dispatch_job_on_chunk,
        dispatch_lite,
    )

    chunk = tcs.ChunkStore(store).load_chunk(0)
    a, b = _ensemble(0), _ensemble(1)
    seen = []
    aux = dispatch_job_on_chunk([a, b], chunk, batch_size=64, seed=3,
                                progress=lambda i, n: seen.append((i, n)))
    assert seen[-1] == (4, 4) and set(aux) == {"0", "1"}
    assert int(a.state.step) == int(b.state.step) == 4
    collect_lite(dispatch_lite([a], chunk, batch_size=128))
    assert int(a.state.step) == 6
