"""The port's giant single SAE (``train/big_sae.py``, ``ops/fused_big_sae.py``)
against the JAX package's, on the CPU.

The JAX kernels run in Pallas interpret mode; the port's wrappers run their
plain PyTorch versions (CPU tensors). Inputs are seeded numpy arrays and
whole training states are carried across with ``big_state_from_numpy``, so
both sides start from the same numbers (their initializers draw different
ones). Tolerances: the forward rtol 1e-5 (the JAX
``test_fused_big_sae_forward_only`` bound); grads rtol 2e-4 / atol 1e-6
and losses rtol 1e-5 (the JAX fused-vs-autodiff bound); trajectories
rtol 1e-4 per step (20 Adam steps of f32 sums in other orders); the
trainer's loop against its own hand-written replay bitwise."""

import dataclasses
import json
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.config import BigSAEArgs as JaxBigSAEArgs
from sparse_coding_tpu.data import chunk_store as jcs
from sparse_coding_tpu.data import ledger as jledger
from sparse_coding_tpu.metrics.core import (
    fraction_variance_unexplained as jax_fvu,
)
from sparse_coding_tpu.ops import fused_big_sae as jfb
from sparse_coding_tpu.resilience.errors import (
    LedgerCorruptionError as JaxLedgerCorruptionError,
)
from sparse_coding_tpu.train import big_sae as jbs
from sparse_coding_tpu_torch.config import BigSAEArgs
from sparse_coding_tpu_torch.data import chunk_store as tcs
from sparse_coding_tpu_torch.data import ledger as tledger
from sparse_coding_tpu_torch.metrics.core import fraction_variance_unexplained
from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops import fused_big_sae as tfb
from sparse_coding_tpu_torch.resilience.errors import LedgerCorruptionError
from sparse_coding_tpu_torch.train import big_sae as tbs
from sparse_coding_tpu_torch.utils.carry import big_state_from_numpy

from torch_port_helpers import batches

B, N, D = 256, 256, 128
L1 = 1e-3
N_WORST = 32
N_STEPS = 20


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree: dict) -> dict:
    return {k: np.array(v) for k, v in tree.items()}


def _params(seed: int = 0, tied: bool = False) -> dict:
    """Raw big-SAE params (numpy): a unit dictionary, an encoder (its
    transpose when tied), small thresholds and a small centre."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dictionary = rs.normal(size=(N, D))
    dictionary /= np.linalg.norm(dictionary, axis=-1, keepdims=True)
    encoder = (dictionary.T if tied
               else rs.normal(size=(D, N)) / np.sqrt(D))
    return {"dict": f32(dictionary), "encoder": f32(encoder),
            "threshold": f32(rs.normal(size=N) * 0.05),
            "centering": f32(rs.normal(size=D) * 0.1)}


def _jax_state(tied: bool, seed: int = 0):
    state, optimizer, l1 = jbs.init_big_sae(jax.random.PRNGKey(seed), D, N,
                                            l1_alpha=L1, tied=tied,
                                            n_worst=N_WORST)
    return state, optimizer, l1


def _carry(js) -> tbs.BigSAEState:
    adam = js.opt_state[0]
    return big_state_from_numpy(
        params=_np(js.params), mu=_np(adam.mu), nu=_np(adam.nu),
        count=np.array(adam.count), c_totals=np.array(js.c_totals),
        worst_losses=np.array(js.worst_losses),
        worst_vectors=np.array(js.worst_vectors), step=np.array(js.step),
        tied=js.tied)


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# --- K8 / K9 plain versions vs the Pallas kernels ------------------------------

def test_big_sae_forward_plain_matches_jax():
    p = _params()
    xc = np.random.default_rng(1).normal(size=(B, D)).astype(np.float32)
    want = jfb.big_sae_forward(p, jnp.asarray(xc), batch_tile=128,
                               feat_tile=128, interpret=True)
    tp = {k: _t(v) for k, v in p.items()}
    got = tfb.big_sae_forward(tp, _t(xc), 128, 128)
    _close(got, want, 1e-5, 1e-5)
    _close(tfb.big_sae_forward_plain(tp, _t(xc)), want, 1e-5, 1e-5)


def test_big_sae_backward_plain_matches_jax():
    p = _params(2)
    rs = np.random.default_rng(3)
    xc = rs.normal(size=(B, D)).astype(np.float32)
    r = (rs.normal(size=(B, D)) * 0.3).astype(np.float32)
    alpha = np.float32(3e-3)
    want = jfb.big_sae_backward(p, jnp.asarray(alpha), jnp.asarray(xc),
                                jnp.asarray(r), batch_tile=64, feat_tile=128,
                                interpret=True)
    got = tfb.big_sae_backward({k: _t(v) for k, v in p.items()},
                               torch.tensor(alpha), _t(xc), _t(r), 64, 128)
    names = ("dE", "dWn", "dt", "dctr_enc", "c_totals", "l1_l0")
    for name, g, w in zip(names, got, want):
        if name == "c_totals":
            _close(g, w, 1e-4, msg=name)
        else:
            _close(g, w, 2e-4, 1e-6, msg=name)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fused_loss_and_grads_match_jax_and_autodiff(tied):
    p = _params(4, tied)
    x = np.random.default_rng(5).normal(size=(B, D)).astype(np.float32)
    jl, jaux, jg = jfb.fused_big_sae_loss_and_grads(
        p, jnp.asarray(x), jnp.float32(L1), tied, batch_tile=64,
        feat_tile=128, interpret=True)
    tp = {k: _t(v) for k, v in p.items()}
    tl, taux, tg = tfb.fused_big_sae_loss_and_grads(tp, _t(x), L1, tied)
    al, aaux, ag = tbs._autodiff_loss_and_grads(tp, _t(x), torch.tensor(L1),
                                                tied)
    for ref_l, ref_aux, ref_g in ((jl, jaux, jg), (al, aaux, ag)):
        _close(tl, ref_l, 1e-5)
        for k in ("mse", "sparsity", "l0_mean"):
            _close(taux[k], ref_aux[k], 1e-5, msg=k)
        _close(taux["mse_losses"], ref_aux["mse_losses"], 1e-4, 1e-7)
        _close(taux["c_totals_delta"], ref_aux["c_totals_delta"], 1e-4, 1e-5)
        for k in tbs.PARAM_NAMES:
            _close(tg[k], ref_g[k], 2e-4, 1e-6, msg=k)
    # autodiff's aux keys and values mirror the kernels' contract
    assert set(aaux) == set(taux) == set(jaux)


# --- the step ------------------------------------------------------------------

_JAX_RUNS: dict = {}


def _jax_trajectory(tied: bool):
    """The JAX fused step (interpret mode) over N_STEPS batches, from its own
    init: (initial state, batches, per-step metrics, final state)."""
    if tied not in _JAX_RUNS:
        state, optimizer, l1 = _jax_state(tied)
        start = _carry(state)
        step = jbs.make_big_sae_step(optimizer, l1, use_fused=True,
                                     fused_interpret=True)
        xs = batches(seed=6, n=N_STEPS, batch=B, d=D)
        metrics = []
        for x in xs:
            state, m = step(state, jnp.asarray(x))
            metrics.append({k: float(v) for k, v in m.items()})
        _JAX_RUNS[tied] = (start, xs, metrics, _carry(state))
    return _JAX_RUNS[tied]


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "autodiff"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_step_trajectory_matches_jax(tied, use_fused):
    start, xs, want_metrics, want = _jax_trajectory(tied)
    step = tbs.make_big_sae_step(tbs.BigSAEAdam(lr=1e-3), torch.tensor(L1),
                                 use_fused=use_fused)
    state = start
    for i, x in enumerate(xs):
        state, m = step(state, _t(x))
        for k, v in want_metrics[i].items():
            _close(float(m[k]), v, 1e-4, 1e-6, msg=f"step {i} {k}")
    for k in tbs.PARAM_NAMES:
        _close(state.params[k], want.params[k], 1e-4, 1e-6, msg=k)
        _close(state.mu[k], want.mu[k], 1e-3, 1e-8, msg=f"mu {k}")
    assert int(state.count) == int(want.count) == N_STEPS
    assert int(state.step) == N_STEPS
    _close(state.c_totals, want.c_totals, 1e-3, 1e-3)
    _close(state.worst_losses, want.worst_losses, 1e-4, 1e-7)
    _close(state.worst_vectors, want.worst_vectors, 0.0)


def test_resurrection_matches_jax():
    state, optimizer, l1 = _jax_state(False, seed=7)
    step = jbs.make_big_sae_step(optimizer, l1, use_fused=False)
    for x in batches(seed=8, n=2, batch=B, d=D):
        state, _ = step(state, jnp.asarray(x))
    dead = (np.arange(N) % 7 == 3) & (np.arange(N) < 140)  # 20 features
    assert dead.sum() == 20
    state = state.replace(c_totals=jnp.where(jnp.asarray(dead), 0.0,
                                             state.c_totals + 1.0))
    ported = _carry(state)
    want, want_dead = jbs.resurrect_dead_features(state)
    want = _carry(want)
    got, n_dead = tbs.resurrect_dead_features(ported)
    assert int(n_dead) == int(want_dead) == 20
    _close(got.params["encoder"], want.params["encoder"], 1e-6)
    for k in tbs.PARAM_NAMES:
        _close(got.mu[k], want.mu[k], 1e-6, msg=k)
        _close(got.nu[k], want.nu[k], 1e-6, msg=k)
        assert torch.equal(got.params[k], ported.params[k]) or k == "encoder"
    assert torch.equal(got.params["encoder"][:, ~torch.from_numpy(dead)],
                       ported.params["encoder"][:, ~torch.from_numpy(dead)])
    assert int(got.count) == int(ported.count)  # Adam's count is kept
    assert float(got.c_totals.abs().max()) == 0.0
    assert torch.isinf(got.worst_losses).all() and (got.worst_losses < 0).all()
    assert float(got.worst_vectors.abs().max()) == 0.0


# --- gating ---------------------------------------------------------------------

def test_gating(monkeypatch):
    """On the CPU "auto" runs autodiff and launches nothing; use_fused=True
    with a shape the kernels do not take raises ValueError (as the JAX
    step does); a mesh that is no Mesh raises, and so does a total_batch
    below the batch's rows; the auto rule and its constant are JAX's."""
    state = _carry(_jax_state(False)[0])
    x = _t(batches(seed=9, n=1, batch=B, d=D)[0])

    def refuse(*a, **k):
        raise AssertionError("auto took the kernels on the CPU")

    monkeypatch.setattr(tfb, "fused_big_sae_loss_and_grads", refuse)
    _build.reset_launches()
    _, m = tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3), L1)(state, x)
    assert np.isfinite(float(m["loss"]))
    assert not any(_build.LAUNCHES.values())
    monkeypatch.undo()

    with pytest.raises(ValueError, match="use_fused=True"):
        tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3), L1, use_fused=True)(
            state, x[:100])
    jstate, jopt, jl1 = _jax_state(False)
    with pytest.raises(ValueError, match="use_fused=True"):
        jbs.make_big_sae_step(jopt, jl1, use_fused=True)(
            jstate, jnp.asarray(x.numpy()))
    with pytest.raises(TypeError, match="Mesh"):
        tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3), L1, mesh=object())
    with pytest.raises(NotImplementedError):
        tfb.fused_big_sae_loss_and_grads(state.params, x, L1, False,
                                         compute_dtype="float16")
    with pytest.raises(ValueError, match="total_batch"):
        tfb.fused_big_sae_loss_and_grads(state.params, x, L1, False,
                                         total_batch=B // 2)
    assert tbs.FUSED_AUTO_CODES_BYTES == jbs.FUSED_AUTO_CODES_BYTES
    for case in [("auto", True, 16384, 16384), ("auto", True, 65536, 16384),
                 (True, True, 64, 128), (True, False, 65536, 16384),
                 ("auto", False, 65536, 16384), (False, True, 65536, 16384),
                 ("auto", True, 49152, 16384, 4),
                 ("auto", True, 49152, 16384, 2)]:
        assert tbs.fused_auto_choice(*case) == jbs.fused_auto_choice(*case)


@pytest.mark.parametrize("shape", [(65536, 16384, 1024), (256, 256, 128),
                                   (64, 32, 40), (96, 64, 1025),
                                   (100, 256, 128), (256, 48, 128)], ids=str)
def test_pick_tiles_admits_what_the_kernels_take(shape):
    tiles = tfb.pick_big_sae_tiles(*shape)
    try:
        _build.check_big_shape("big_sae_fwd", *shape)
        takes = True
    except ValueError:
        takes = False
    assert (tiles is not None) == takes
    if tiles is not None:
        assert shape[0] % tiles[0] == 0 and shape[1] % tiles[1] == 0


# --- the trainer ------------------------------------------------------------------

TD, TN, TB = 32, 64, 128  # the trainer's small store and SAE


def _store(folder, seed=0, chunks=4, rows=512):
    w = tcs.ChunkWriter(folder, TD, chunk_size_gb=rows * TD * 2 / 2**30,
                        dtype="float16")
    data = batches(seed=seed, n=chunks, batch=rows, d=TD)
    for c in data:
        w.add(c)
    assert w.finalize() == chunks
    return folder


def _cfg(folder, **kw) -> BigSAEArgs:
    base = dict(activation_dim=TD, n_feats=TN, l1_alpha=1e-3, lr=1e-3,
                batch_size=TB, dataset_folder=str(folder), n_epochs=1,
                resurrect_every=8, seed=3)
    base.update(kw)
    return BigSAEArgs(**base)


def _state_equal(a: tbs.BigSAEState, b: tbs.BigSAEState) -> None:
    for f in ("params", "mu", "nu"):
        for k in tbs.PARAM_NAMES:
            assert torch.equal(getattr(a, f)[k], getattr(b, f)[k]), (f, k)
    for f in ("count", "c_totals", "worst_losses", "worst_vectors", "step"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


class _Recorder:
    """A store that records the batches an epoch hands out."""

    def __init__(self, store):
        self.store, self.seen = store, []

    def epoch(self, batch_size, rng):
        for b in self.store.epoch(batch_size, rng):
            self.seen.append(np.array(b))
            yield b


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_train_big_sae_matches_its_replay(tmp_path, scan_steps):
    """train_big_sae equals init + epoch + step + resurrection called by
    hand at the same steps, bitwise; with scan_steps=4 too (resurrect_every
    8 falls on window boundaries)."""
    folder = _store(tmp_path / "store")
    cfg = _cfg(folder, scan_steps=scan_steps)
    got = tbs.train_big_sae(cfg, device="cpu")

    state, opt, l1 = tbs.init_big_sae(torch.Generator().manual_seed(3), TD,
                                      TN, 1e-3, lr=1e-3, device="cpu")
    step = tbs.make_big_sae_step(opt, l1)
    rng = np.random.default_rng(3)
    n = 0
    for x in tcs.ChunkStore(folder).epoch(TB, rng):
        state, _ = step(state, torch.from_numpy(x))
        n += 1
        if n % 8 == 0:
            state, _ = tbs.resurrect_dead_features(state)
    assert n == 16 and int(got.step) == 16
    _state_equal(got, state)


def test_train_big_sae_sees_the_jax_trainers_batches(tmp_path):
    """The same store and seed give the port's and the JAX trainer the same
    batches in the same order."""
    folder = _store(tmp_path / "store")
    ours = _Recorder(tcs.ChunkStore(folder, quarantine_corrupt=True))
    theirs = _Recorder(jcs.ChunkStore(folder, quarantine_corrupt=True))
    tbs.train_big_sae(_cfg(folder), store=ours, device="cpu")
    jbs.train_big_sae(JaxBigSAEArgs(**dataclasses.asdict(_cfg(folder))),
                      store=theirs)
    assert len(ours.seen) == len(theirs.seen) == 16
    for a, b in zip(ours.seen, theirs.seen):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "autodiff"])
def test_big_sae_trains(use_fused):
    """The port's counterpart of the JAX ``test_big_sae_trains``: from the
    port's own init, 600 steps on synthetic data lower the loss and the
    export reaches FVU < 1 on held-out rows (the kernels' plain versions
    and autodiff alike)."""
    from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator

    state, opt, l1 = tbs.init_big_sae(torch.Generator().manual_seed(0), 32,
                                      64, 1e-4, lr=1e-2, n_worst=32,
                                      device="cpu")
    step = tbs.make_big_sae_step(opt, l1, use_fused=use_fused)
    g = torch.Generator().manual_seed(5)
    gen = RandomDatasetGenerator.create(g, 32, 48, 5, 0.99)
    first = None
    for _ in range(600):
        state, m = step(state, gen.batch(g, 256))
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first
    ld = tbs.to_learned_dict(state)
    assert ld.encode(gen.batch(g, 16)).shape == (16, 64)
    fvu = float(fraction_variance_unexplained(ld, gen.batch(g, 2048)))
    assert np.isfinite(fvu) and fvu < 1.0, fvu


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_export_fvu_matches_jax(tied):
    """BigSAEDict reproduces the training objective (tied adds the centre
    back, untied does not) and gives JAX's FVU on the same params."""
    p = _params(10, tied)
    x = batches(seed=11, n=1, batch=512, d=D)[0]
    state = tbs.BigSAEState(
        params={k: _t(v) for k, v in p.items()}, count=torch.tensor(0),
        mu={}, nu={}, c_totals=torch.zeros(N), worst_losses=torch.zeros(1),
        worst_vectors=torch.zeros(1, D), step=torch.tensor(0), tied=tied)
    ld = tbs.to_learned_dict(state)
    jld = jbs.BigSAEDict(dictionary=jnp.asarray(p["dict"]),
                         encoder=jnp.asarray(p["encoder"]),
                         threshold=jnp.asarray(p["threshold"]),
                         centering=jnp.asarray(p["centering"]),
                         add_center_back=tied)
    got = float(fraction_variance_unexplained(ld, _t(x)))
    _close(got, float(jax_fvu(jld, jnp.asarray(x))), 1e-5)
    _, aux, _ = tfb.fused_big_sae_loss_and_grads(state.params, _t(x), L1,
                                                 tied)
    total = float(torch.mean(torch.square(_t(x) - _t(x).mean(dim=0))))
    _close(got, float(aux["mse"]) / total, 1e-5)
    assert ld.add_center_back == tied


# --- the quarantine ledger ---------------------------------------------------------

def _corrupt(folder, index: int) -> None:
    path = folder / f"{index}.npy"
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0x40
    path.write_bytes(bytes(raw))


def test_quarantine_skips_a_corrupt_chunk_once(tmp_path, caplog):
    folder = _store(tmp_path / "store")
    _corrupt(folder, 1)
    jfolder = tmp_path / "jstore"
    shutil.copytree(folder, jfolder)

    with pytest.raises(tcs.ChunkCorruptionError, match="digest mismatch"):
        list(tcs.ChunkStore(folder).epoch(TB, np.random.default_rng(0)))
    assert not tledger.ledger_path(folder).exists()

    store = tcs.ChunkStore(folder, quarantine_corrupt=True)
    with caplog.at_level(logging.WARNING):
        got = list(store.epoch(TB, np.random.default_rng(0), n_repetitions=2))
    warned = [r for r in caplog.records if "quarantining" in r.getMessage()]
    assert len(warned) == 1 and store.quarantined == {1}
    want = list(jcs.ChunkStore(jfolder, quarantine_corrupt=True).epoch(
        TB, np.random.default_rng(0), n_repetitions=2))
    assert len(got) == len(want) == 2 * 3 * (512 // TB)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # each side's ledger is byte-identical and loads on the other
    assert (tledger.ledger_path(folder).read_bytes()
            == jledger.ledger_path(jfolder).read_bytes())
    assert set(jledger.load_quarantine(folder)) == {1}
    assert set(tledger.load_quarantine(jfolder)) == {1}
    # a fresh process knows at open, and load_chunk still raises
    reopened = tcs.ChunkStore(folder, quarantine_corrupt=True)
    assert reopened.quarantined == {1}
    with pytest.raises(tcs.ChunkCorruptionError):
        reopened.load_chunk(1)


def test_ledger_cross_loads_both_ways(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    a.mkdir()
    b.mkdir()
    for i, reason in ((3, "content digest mismatch"), (0, "unreadable npy")):
        tledger.record_quarantine(a, i, reason, f"{i}.npy")
        jledger.record_quarantine(b, i, reason, f"{i}.npy")
    assert (tledger.ledger_path(a).read_bytes()
            == jledger.ledger_path(b).read_bytes())
    assert tledger.load_quarantine(b) == jledger.load_quarantine(a) == {
        0: {"reason": "unreadable npy", "file": "0.npy"},
        3: {"reason": "content digest mismatch", "file": "3.npy"}}
    before = tledger.ledger_path(a).read_bytes()
    tledger.record_quarantine(a, 3, "content digest mismatch", "3.npy")
    assert tledger.ledger_path(a).read_bytes() == before  # idempotent
    assert set(tledger.clear_quarantine(a, 3)) == {0}
    assert set(jledger.load_quarantine(a)) == {0}
    tledger.clear_quarantine(a, 0)
    assert not tledger.ledger_path(a).exists()
    assert tledger.load_quarantine(a) == {}
    # a ledger whose payload no longer matches its digest raises on both
    doc = json.loads(jledger.ledger_path(b).read_text())
    doc["chunks"].pop("3")
    jledger.ledger_path(b).write_text(json.dumps(doc))
    with pytest.raises(LedgerCorruptionError):
        tledger.load_quarantine(b)
    with pytest.raises(JaxLedgerCorruptionError):
        jledger.load_quarantine(b)
