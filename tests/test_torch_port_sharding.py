"""The port on a mesh, against the JAX package's sharded runs and the port's
own single-process runs (the counterpart of tests/test_sharding.py,
tests/test_multihost.py and tests/test_fused_big_sae.py's sharded case).

The port's side runs in gloo worlds of 2-4 processes on the CPU
(tests/torch_port_world.py, started by ``torch_port_helpers.run_world``:
a FileStore rendezvous under tmp_path, a timeout on the world and on each
process, results written per rank). The JAX oracle runs here, on a 2 × 2
mesh of the fake CPU devices tests/conftest.py sets up, from the same
numpy inputs. Bounds:

- the ensemble, tied and untied, on train_step, train_step_tiled,
  two_stage_tiled and autodiff, 5 steps on 2 × 2: rtol 1e-5, atol 1e-6
  against the JAX sharded run and the port's single process
  (tests/test_sharding.py's bound);
- a model-only mesh (2 × 1): bitwise equal to the single process, since
  members never mix; two runs of one world: bitwise equal;
- the big SAE's fused step on 2 × 2 against JAX ``shard_big_sae`` +
  ``make_big_sae_step(mesh=...)``: metrics rtol 1e-4 / atol 1e-6, params
  rtol 5e-4 / atol 2e-5 (tests/test_fused_big_sae.py's bounds);
- the sweep on 2 × 2, with and without scan windows, against the port's
  single-process sweep: rtol 1e-4, atol 1e-5; a SIGTERM to one rank of a
  2-rank sweep preempts both, and the resume is bitwise the uninterrupted
  mesh run.
"""

import json
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ensemble import Ensemble as JaxEnsemble
from sparse_coding_tpu.models.sae import FunctionalSAE as JaxSAE
from sparse_coding_tpu.models.sae import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparse_coding_tpu.train import big_sae as jbs
from sparse_coding_tpu_torch.config import SyntheticEnsembleArgs
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.models import sae as tsae
from sparse_coding_tpu_torch.train import big_sae as tbs
from sparse_coding_tpu_torch.train import experiments as texp
from sparse_coding_tpu_torch.train import sweep as tsweep
from sparse_coding_tpu_torch.utils.carry import (
    big_state_from_numpy,
    members_from_numpy,
)
from torch_port_helpers import run_world

D, N_DICT, N_MEMBERS, BATCH, STEPS, LR = 16, 64, 4, 256, 5, 1e-3
PATHS = ["train_step", "train_step_tiled", "two_stage_tiled", None]
SIGS = {"tied_sae": (JaxTiedSAE, tsae.FunctionalTiedSAE, {}),
        "sae": (JaxSAE, tsae.FunctionalSAE, {"bias_decay": 0.01})}
CASES = {f"{sig}/{path or 'autodiff'}": (sig, path, None)
         for sig in SIGS for path in PATHS}
FROZEN = 2  # lives on the second model shard
ENS_TOL = dict(rtol=1e-5, atol=1e-6)
REPEAT_CASES = ("tied_sae/train_step_tiled", "sae/autodiff")
BIG_B, BIG_N, BIG_D, BIG_STEPS, BIG_L1 = 256, 256, 128, 3, 1e-3


def _members(sig_name: str):
    jsig, _, kw = SIGS[sig_name]
    keys = jax.random.split(jax.random.PRNGKey(0), N_MEMBERS)
    return [jax.device_get(jsig.init(k, D, N_DICT, l1_alpha=1e-3, **kw))
            for k in keys]


def _big_state(tied: bool) -> dict:
    state, _, _ = jbs.init_big_sae(jax.random.PRNGKey(3), BIG_D, BIG_N,
                                   BIG_L1, tied=tied, n_worst=64)
    adam = state.opt_state[0]
    np_ = lambda tree: {k: np.array(v) for k, v in tree.items()}
    return dict(params=np_(state.params), mu=np_(adam.mu), nu=np_(adam.nu),
                count=np.array(adam.count), c_totals=np.array(state.c_totals),
                worst_losses=np.array(state.worst_losses),
                worst_vectors=np.array(state.worst_vectors),
                step=np.array(state.step), tied=tied)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rs = np.random.default_rng(11)
    ens = {"members": {s: _members(s) for s in SIGS},
           "batches": rs.normal(size=(STEPS, BATCH, D)).astype(np.float32),
           "lr": LR,
           "cases": {**CASES, "frozen": ("tied_sae", "train_step", FROZEN)}}
    big = {"cases": {"untied": {"state": _big_state(False)},
                     "tied": {"state": _big_state(True)}},
           "batches": rs.normal(size=(BIG_STEPS, BIG_B, BIG_D)).astype(
               np.float32),
           "lr": 1e-3, "l1": BIG_L1}
    folder = tmp_path_factory.mktemp("inputs")
    with open(folder / "inputs.pkl", "wb") as f:
        pickle.dump({"ensemble": ens, "big_sae": big}, f)
    # the repeat: one case of each kind is enough to show determinism
    with open(folder / "repeat.pkl", "wb") as f:
        pickle.dump({"ensemble": dict(ens, cases={k: CASES[k] for k in
                                                  REPEAT_CASES}),
                     "big_sae": dict(big, cases={"tied": big["cases"]
                                                 ["tied"]})}, f)
    return {"path": folder / "inputs.pkl", "repeat": folder / "repeat.pkl",
            "ensemble": ens, "big_sae": big}


@pytest.fixture(scope="module")
def world_2x2(inputs, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("w22"), "train", 4, 2, 2,
                     inputs["path"])


@pytest.fixture(scope="module")
def world_2x2_again(inputs, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("w22b"), "train", 4, 2, 2,
                     inputs["repeat"])


@pytest.fixture(scope="module")
def world_2x1(inputs, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("w21"), "train", 2, 2, 1,
                     inputs["path"])


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process runs of every ensemble case."""
    ens = inputs["ensemble"]
    out = {}
    for key, (sig_name, path, _) in CASES.items():
        e = Ensemble(members_from_numpy(ens["members"][sig_name]),
                     SIGS[sig_name][1], lr=LR, device="cpu",
                     use_fused=path is not None, fused_path=path)
        for batch in torch.from_numpy(ens["batches"]):
            e.step_batch(batch)
        out[key] = e.state.params
    return out


def _jax_sharded(inputs, key):
    sig_name, path, _ = CASES[key]
    ens = JaxEnsemble(inputs["ensemble"]["members"][sig_name],
                      SIGS[sig_name][0], lr=LR, mesh=jax_make_mesh(2, 2),
                      donate=False, use_fused=path is not None,
                      fused_interpret=True, fused_path=path)
    for batch in inputs["ensemble"]["batches"]:
        ens.step_batch(batch)
    return jax.device_get(ens.state.params)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


# --- the ensemble ----------------------------------------------------------------

@pytest.mark.parametrize("key", list(CASES))
def test_ensemble_2x2_matches_jax_sharded(inputs, world_2x2, key):
    want = _jax_sharded(inputs, key)
    for rank, res in enumerate(world_2x2):
        rec = res["ensemble"][key]
        assert rec["path"] == CASES[key][1]
        assert rec["local_members"] == N_MEMBERS // 2
        for name in want:
            _close(rec["params"][name], want[name], ENS_TOL,
                   f"rank {rank} {key} {name}")


@pytest.mark.parametrize("key", list(CASES))
def test_ensemble_2x2_matches_single_process(world_2x2, single, key):
    rec = world_2x2[0]["ensemble"][key]
    for name, want in single[key].items():
        _close(rec["params"][name], want, ENS_TOL, f"{key} {name}")
    # every rank gathered the same whole state and aux
    for res in world_2x2[1:]:
        other = res["ensemble"][key]
        for name in rec["params"]:
            assert torch.equal(other["params"][name], rec["params"][name])
        assert torch.equal(other["losses"]["loss"], rec["losses"]["loss"])
        assert other["losses"]["loss"].shape == (N_MEMBERS,)
        assert bool(torch.all(other["finite"]))


@pytest.mark.parametrize("key", list(CASES))
def test_model_only_mesh_is_bitwise_single_process(world_2x1, single, key):
    """2 × 1: each rank trains its members on the whole batch, and the
    per-member results do not depend on the members beside them."""
    for res in world_2x1:
        rec = res["ensemble"][key]
        for name, want in single[key].items():
            assert torch.equal(rec["params"][name], want), f"{key} {name}"


def test_two_runs_of_one_world_are_bitwise_equal(world_2x2, world_2x2_again):
    for a, b in zip(world_2x2, world_2x2_again):
        for key in REPEAT_CASES:
            for name, v in a["ensemble"][key]["params"].items():
                assert torch.equal(v, b["ensemble"][key]["params"][name])
        for name, v in a["big_sae"]["tied"]["params"].items():
            assert torch.equal(v, b["big_sae"]["tied"]["params"][name])


def test_frozen_member_on_the_second_model_shard_is_unchanged(world_2x2):
    """A member frozen on the second model shard passes the whole-step
    mesh program bitwise unchanged while the others train; the live mask
    reads the same on every rank."""
    for res in world_2x2:
        rec = res["ensemble"]["frozen"]
        for name, before in rec["before"].items():
            after = rec["params"][name]
            assert torch.equal(after[FROZEN], before[FROZEN]), name
            other = (FROZEN + 1) % N_MEMBERS
            assert not torch.equal(after[other], before[other]), name
        for name, before in rec["before_mu"].items():
            assert torch.equal(rec["mu"][name][FROZEN], before[FROZEN])
        assert list(rec["live"]) == [True, True, False, True]


# --- the big SAE -----------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_big_sae_2x2_matches_jax_sharded(inputs, world_2x2, tied):
    big = inputs["big_sae"]
    key = "tied" if tied else "untied"
    js, opt, l1 = jbs.init_big_sae(jax.random.PRNGKey(3), BIG_D, BIG_N,
                                   BIG_L1, tied=tied, n_worst=64)
    mesh = jax_make_mesh(2, 2)
    js = jbs.shard_big_sae(js, mesh)
    step = jbs.make_big_sae_step(opt, l1, mesh=mesh, use_fused=True,
                                 fused_interpret=True)
    want = []
    for batch in big["batches"]:
        js, m = step(js, batch)
        want.append({k: float(v) for k, v in m.items()})
    _, jn_dead = jbs.resurrect_dead_features(js)
    for res in world_2x2:
        rec = res["big_sae"][key]
        for got_m, want_m in zip(rec["metrics"], want):
            for k, v in want_m.items():
                _close(got_m[k], v, dict(rtol=1e-4, atol=1e-6), k)
        for name, v in jax.device_get(js.params).items():
            _close(rec["params"][name], v, dict(rtol=5e-4, atol=2e-5), name)
        _close(rec["worst_losses"], jax.device_get(js.worst_losses),
               dict(rtol=1e-4, atol=1e-7), "worst_losses")
        assert rec["n_dead"] == int(jn_dead)


def test_big_sae_mesh_matches_single_process_and_resurrects_alike(
        inputs, world_2x2):
    """The mesh step tracks the port's single-process kernel step, and the
    mesh resurrection gives each dead feature the example a single device
    gives it."""
    big = inputs["big_sae"]
    for key, case in big["cases"].items():
        state = big_state_from_numpy(**case["state"])
        step = tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3),
                                     torch.tensor(BIG_L1), use_fused=True)
        for batch in torch.from_numpy(big["batches"]):
            state, m = step(state, batch)
        rec = world_2x2[0]["big_sae"][key]
        for name, v in state.params.items():
            _close(rec["params"][name], v, dict(rtol=5e-4, atol=2e-5), name)
        # resurrect the mesh run's own final state on one process
        full = big_state_from_numpy(
            params={k: v.numpy() for k, v in rec["params"].items()},
            mu={k: v.numpy() for k, v in state.mu.items()},
            nu={k: v.numpy() for k, v in state.nu.items()},
            count=state.count.numpy(), c_totals=rec["c_totals"].numpy(),
            worst_losses=rec["worst_losses"].numpy(),
            worst_vectors=state.worst_vectors.numpy(), tied=state.tied)
        _, n_dead = tbs.resurrect_dead_features(full)
        assert rec["n_dead"] == int(n_dead)


def test_big_sae_mesh_raises_for_a_shape_the_kernels_refuse():
    from sparse_coding_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(1, 1, "cpu")
    state, opt, l1 = tbs.init_big_sae(torch.Generator().manual_seed(0), 16,
                                      48, 1e-3, n_worst=4, device="cpu")
    step = tbs.make_big_sae_step(opt, l1, mesh=mesh)
    with pytest.raises(ValueError, match="n_feats=48"):
        step(state, torch.zeros(64, 16))
    with pytest.raises(ValueError, match="GSPMD autodiff"):
        tbs.make_big_sae_step(opt, l1, mesh=mesh, use_fused=False)


# --- the sweep -------------------------------------------------------------------

def _store(folder, n_chunks: int, size: int):
    cfg = SyntheticEnsembleArgs(output_folder=str(folder / "unused"),
                                dataset_folder=str(folder), n_chunks=n_chunks,
                                activation_dim=16,
                                n_ground_truth_features=32, dataset_size=size)
    tsweep.init_synthetic_dataset(cfg)
    return str(folder)


def _spec(store, out, **over) -> dict:
    cfg = dict(output_folder=str(out), dataset_folder=store, batch_size=64,
               lr=3e-3, n_chunks=2, learned_dict_ratio=2.0, tied_ae=True)
    cfg.update(over)
    return {"cfg": cfg, "l1_range": [1e-4, 1e-3], "activation_dim": 16}


def _plain_sweep(spec) -> list:
    from sparse_coding_tpu_torch.config import EnsembleArgs

    cfg = dict(spec["cfg"], mesh_model=1, mesh_data=1)
    result = tsweep.sweep(
        lambda c, m, device=None: texp.dense_l1_range_experiment(
            c, m, l1_range=spec["l1_range"], activation_dim=16,
            device=device),
        EnsembleArgs(**cfg), device="cpu", image_metrics_every=None)
    return [ld.get_learned_dict() for ld, _ in result["dense_l1_range"]]


@pytest.fixture(scope="module")
def sweep_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    store = _store(root / "chunks", 2, 4000)
    specs = [_spec(store, root / "mesh", mesh_model=2, mesh_data=2),
             _spec(store, root / "scan", mesh_model=2, mesh_data=2,
                   scan_steps=4)]
    path = root / "specs.json"
    path.write_text(json.dumps(specs))
    world = run_world(root, "sweep", 4, "run", path)
    plain = _plain_sweep(_spec(store, root / "plain"))
    return specs, world, plain


@pytest.mark.parametrize("which", [0, 1], ids=["steps", "scan_windows"])
def test_sweep_on_a_2x2_mesh_matches_the_single_process_sweep(sweep_runs,
                                                              which):
    specs, world, plain = sweep_runs
    for res in world:
        dicts = res[which]["dicts"]["dense_l1_range"]
        assert len(dicts) == len(plain) == 2
        for got, want in zip(dicts, plain):
            _close(got, want, dict(rtol=1e-4, atol=1e-5))
    # rank 0 wrote the run's files: the last checkpoint set, the config
    # and the last chunk's artifacts
    out = Path(specs[which]["cfg"]["output_folder"])
    assert (out / "ckpt").is_dir() and (out / "config.json").exists()
    evals = json.loads((out / "_1" / "dense_l1_range_eval.json").read_text())
    assert len(evals) == 2 and all(np.isfinite(e["fvu"]) for e in evals)


@pytest.fixture(scope="module")
def preempted_runs(tmp_path_factory):
    """Three 2-rank worlds on a 2 × 1 mesh over a 3-chunk store: the
    uninterrupted msgpack sweep; the msgpack and the orbax sweeps, each
    preempted by a SIGTERM to rank 1 alone at the end of its first chunk;
    then both resumed."""
    root = tmp_path_factory.mktemp("preempt")
    store = _store(root / "chunks", 3, 3000)
    full = [_spec(store, root / "full", n_chunks=3, mesh_model=2)]
    cut = [_spec(store, root / "msgpack", n_chunks=3, mesh_model=2),
           _spec(store, root / "orbax", n_chunks=3, mesh_model=2,
                 checkpoint_backend="orbax")]
    (root / "full.json").write_text(json.dumps(full))
    (root / "cut.json").write_text(json.dumps(cut))
    return {"root": root, "cut": cut,
            "full": run_world(root, "sweep", 2, "run", root / "full.json"),
            "preempted": run_world(root, "sweep", 2, "preempt",
                                   root / "cut.json"),
            "resumed": run_world(root, "sweep", 2, "resume",
                                 root / "cut.json")}


def test_sigterm_to_one_rank_preempts_all_and_resumes_bitwise(
        preempted_runs):
    """Rank 1 alone takes a SIGTERM at the end of the first chunk; both
    ranks agree, checkpoint after the second and raise SweepPreempted;
    the resumed run equals the uninterrupted mesh run bitwise."""
    runs = preempted_runs
    for r in runs["preempted"]:
        assert r[0] == {"preempted": runs["preempted"][0][0]["preempted"]}
        assert "2" in r[0]["preempted"]
    for a, b in zip(runs["resumed"], runs["full"]):
        for got, want in zip(a[0]["dicts"]["dense_l1_range"],
                             b[0]["dicts"]["dense_l1_range"]):
            assert torch.equal(got, want)


def test_orbax_backend_on_a_mesh_writes_shards_and_resumes_bitwise(
        preempted_runs):
    """checkpoint_backend='orbax' on a 2 × 1 mesh: each model shard's rank
    writes its members (no gather), rank 0 the index; the run preempted on
    one rank resumes from those shards bitwise equal to the uninterrupted
    msgpack mesh run, and the last set restores on one process to the
    same dicts."""
    from sparse_coding_tpu_torch.config import EnsembleArgs
    from sparse_coding_tpu_torch.utils.checkpoint import (
        checkpoint_exists,
        restore_ensemble,
    )

    runs = preempted_runs
    assert all("preempted" in r[1] for r in runs["preempted"])
    for a, b in zip(runs["resumed"], runs["full"]):
        for got, ref in zip(a[1]["dicts"]["dense_l1_range"],
                            b[0]["dicts"]["dense_l1_range"]):
            assert torch.equal(got, ref)
    ckpt = runs["root"] / "orbax" / "ckpt"
    path = tsweep.checkpoint_path(ckpt, "dense_l1_range_0")
    assert not path.exists() and checkpoint_exists(path)
    assert sorted(p.name for p in ckpt.glob("*.shard-*-of-2")) == [
        f"{path.name}.shard-{m}-of-2" for m in range(2)]
    (ens, _, _), = texp.dense_l1_range_experiment(
        EnsembleArgs(**runs["cut"][1]["cfg"]), None, l1_range=[1e-4, 1e-3],
        activation_dim=16, device="cpu")
    meta = restore_ensemble(ens, path)
    assert meta["shards"] == 2 and meta["chunks_done"] == 3
    for got, ref in zip(ens.to_learned_dicts(),
                        runs["resumed"][0][1]["dicts"]["dense_l1_range"]):
        assert torch.equal(got.get_learned_dict(), ref)
