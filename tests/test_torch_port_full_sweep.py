"""The port's full sweep (sparse_coding_tpu_torch/train/sweep.py) against
the JAX package's ``train/sweep.py::sweep`` on one tiny store.

Both sides get the same inputs: a store written by numpy from a seed, the
JAX experiment's init members carried into the port (the port's
experiments take them through ``inits=``), and the chunk order and
batches drawn from the same ``np.random.default_rng(cfg.seed)``. The JAX
side runs on autodiff, or on its kernels (``train_step_tiled``, the masked
family ``two_stage_tiled``) in Pallas interpret mode; the port runs its
default kernel path, whose wrappers take their plain PyTorch versions on
the CPU.

Tolerances: the final learned dicts and eval.json's fvu/l0 within rtol
2e-4 (atol 1e-6 on dictionary elements) — the JAX package's own
fused-vs-autodiff bound over 16-32 Adam steps; the artifact chunk
indices, their hyperparameters and the save points exactly. The sweeps
run at the config's default lr (1e-3): Adam's first step moves an element
whose gradient lies within rounding of 0 (|g| ~ 1e-9, against eps 1e-8)
by lr·g/(|g| + eps), so two sides whose g differ by a rounding there
differ by a share of lr at once — at lr 3e-3 one element of 2048 moved
6.8e-5 apart (2.8e-4 relative) after the first step.
"""

import json
import sys

import numpy as np
import pytest
import torch

from sparse_coding_tpu.config import EnsembleArgs as JaxArgs
from sparse_coding_tpu.data.chunk_store import ChunkWriter as JaxChunkWriter
from sparse_coding_tpu.train import experiments as jexp
from sparse_coding_tpu.train import sweep as jsweep
from sparse_coding_tpu_torch.config import EnsembleArgs
from sparse_coding_tpu_torch.train import experiments as texp
from sparse_coding_tpu_torch.train import sweep as tsweep
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

D, RATIO, BATCH, N_CHUNKS, ROWS = 32, 2.0, 64, 4, 256
L1S = [1e-3, 4e-3, 1e-2]
DICT_TOL = dict(rtol=2e-4, atol=1e-6)
EVAL_RTOL = 2e-4
# the JAX kernel path of each experiment in interpret mode; the port's
# kernels block at fixed tiles, the JAX side takes these
JAX_TILED = {"dense_l1_range": "train_step_tiled",
             "tied_vs_not": "train_step_tiled",
             "dict_ratio": "two_stage_tiled"}
JAX_TILES = dict(fused_batch_tile=32, fused_feat_tile=16)


def write_store(folder, seed=0, n_chunks=N_CHUNKS, rows=ROWS, d=D):
    """Sparse nonnegative codes over a random unit dictionary, written by
    the JAX package's writer (float16 on disk)."""
    rs = np.random.default_rng(seed)
    feats = rs.normal(size=(2 * d, d))
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    w = JaxChunkWriter(folder, d, chunk_size_gb=rows * d * 2 / 2**30,
                       dtype="float16")
    for _ in range(n_chunks):
        codes = rs.uniform(size=(rows, 2 * d)) * (
            rs.uniform(size=(rows, 2 * d)) < 0.1)
        w.add((codes @ feats + 0.1).astype(np.float32))
    w.finalize()
    return folder


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("full_sweep") / "store")


def _kwargs(experiment):
    if experiment == "dict_ratio":
        return dict(ratios=(0.5, 1, 2), activation_dim=D)
    return dict(l1_range=L1S, activation_dim=D)


def jax_build(experiment):
    fn = jexp.EXPERIMENTS[experiment]
    return lambda c, m: fn(c, m, **_kwargs(experiment))


def port_build(experiment, jax_cfg, built=None):
    """The port's experiment on the JAX experiment's init members; the
    entries it builds are appended to ``built``."""
    inits = {name: ens.unstack() for ens, _, name in
             jax_build(experiment)(jax_cfg, None)}
    fn = texp.EXPERIMENTS[experiment]

    def build(c, m, device=None):
        entries = fn(c, m, inits=inits, device=device, **_kwargs(experiment))
        if built is not None:
            built.extend(entries)
        return entries

    return build


def configs(store, out, jax_path=None, **over):
    base = dict(dataset_folder=str(store), batch_size=BATCH, lr=1e-3,
                learned_dict_ratio=RATIO, n_chunks=N_CHUNKS, seed=0,
                perf_probe_every=4, **over)
    jax_eng = (dict(use_fused="off") if jax_path is None else
               dict(use_fused="on", fused_path=jax_path, fused_interpret=True,
                    **JAX_TILES))
    return (JaxArgs(output_folder=str(out / "jax"), **base, **jax_eng),
            EnsembleArgs(output_folder=str(out / "torch"), **base))


def assert_dicts_close(jres, tres):
    assert list(jres) == list(tres)
    for name in jres:
        assert len(jres[name]) == len(tres[name])
        for i, ((jd, jh), (td, th)) in enumerate(zip(jres[name],
                                                     tres[name])):
            assert th == jh, (name, i)
            assert type(td).__name__ == type(jd).__name__
            for field in ("dictionary", "encoder", "encoder_bias"):
                if hasattr(jd, field) and getattr(jd, field) is not None:
                    np.testing.assert_allclose(
                        getattr(td, field).numpy(),
                        np.asarray(getattr(jd, field)), **DICT_TOL,
                        err_msg=f"{name}[{i}].{field}")


def assert_artifacts_match(out):
    jdirs = sorted(p.name for p in (out / "jax").glob("_*"))
    tdirs = sorted(p.name for p in (out / "torch").glob("_*"))
    assert tdirs == jdirs and jdirs
    for sub in jdirs:
        for path in sorted((out / "jax" / sub).glob("*_eval.json")):
            je = json.loads(path.read_text())
            te = json.loads((out / "torch" / sub / path.name).read_text())
            assert [set(r) for r in te] == [set(r) for r in je]
            for j, t in zip(je, te):
                assert {k: v for k, v in t.items() if k not in ("fvu", "l0")} \
                    == {k: v for k, v in j.items() if k not in ("fvu", "l0")}
                for k in ("fvu", "l0"):
                    assert t[k] == pytest.approx(j[k], rel=EVAL_RTOL), (sub, k)
        for path in sorted((out / "jax" / sub).glob("*_learned_dicts.pkl")):
            port_side = load_learned_dicts(out / "torch" / sub / path.name)
            assert [h for _, h in port_side] == [
                h for _, h in load_learned_dicts(path)]


# (experiment, JAX path, tied_ae, extra config): each experiment on
# autodiff and on its kernel path; centering, two repetitions, scan
# windows, a save cadence and bfloat16 training each covered once
CASES = [
    ("dense_l1_range", None, True, {"center_activations": True}),
    ("dense_l1_range", "tiled", True, {"n_repetitions": 2}),
    ("dense_l1_range", None, False, {"scan_steps": 2}),
    ("dense_l1_range", "tiled", False, {"save_every_chunks": 2}),
    ("tied_vs_not", None, False, {"train_dtype": "bfloat16"}),
    ("tied_vs_not", "tiled", False, {}),
    ("dict_ratio", None, True, {}),
    ("dict_ratio", "tiled", True, {"center_activations": True}),
]


def _case_id(case):
    experiment, path, tied, extra = case
    label = f"{experiment}-{'tied' if tied else 'untied'}" \
        if experiment == "dense_l1_range" else experiment
    return "-".join([label, "kernels" if path else "autodiff", *extra])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sweep_matches_jax(store, tmp_path, case):
    experiment, path, tied, extra = case
    jcfg, tcfg = configs(store, tmp_path,
                         JAX_TILED[experiment] if path else None,
                         tied_ae=tied, **extra)
    jres = jsweep.sweep(jax_build(experiment), jcfg, log_every=5,
                        image_metrics_every=None)
    built = []
    tres = tsweep.sweep(port_build(experiment, jcfg, built), tcfg,
                        log_every=5, image_metrics_every=None, device="cpu")
    assert_dicts_close(jres, tres)
    assert_artifacts_match(tmp_path)
    # the port trained on its family's default kernel path (the plain
    # versions, on the CPU)
    want = "two_stage_tiled" if experiment == "dict_ratio" else \
        "train_step_tiled"
    assert [e.fused_path for e, _, _ in built] == [want] * len(tres)
    for tagged in tres.values():
        assert not any(h.get("diverged") for _, h in tagged)


def test_image_metrics_and_log_streams(store, tmp_path):
    """Image metrics write the MMCS grid (matching the JAX grid) and a
    sparsity histogram per member; metrics.jsonl carries the same keys as
    the JAX sweep's."""
    jcfg, tcfg = configs(store, tmp_path, tied_ae=True)
    jsweep.sweep(jax_build("dense_l1_range"), jcfg, log_every=8,
                 image_metrics_every=2)
    tsweep.sweep(port_build("dense_l1_range", jcfg), tcfg, log_every=8,
                 image_metrics_every=2, device="cpu")
    sub = "_3"
    grid = np.load(tmp_path / "torch" / sub / "dense_l1_range_mmcs_grid.npy")
    jgrid = np.load(tmp_path / "jax" / sub / "dense_l1_range_mmcs_grid.npy")
    np.testing.assert_allclose(grid, jgrid, rtol=1e-4, atol=1e-5)
    hists = sorted(p.name for p in (tmp_path / "torch" / sub).glob("*.png"))
    assert hists == [f"dense_l1_range_{i}_sparsity_hist.png"
                     for i in range(len(L1S))]
    read = lambda p: [json.loads(line) for line in
                      p.read_text().splitlines()]
    jrecs = read(tmp_path / "jax" / "metrics.jsonl")
    trecs = read(tmp_path / "torch" / "metrics.jsonl")
    assert [r.get("step") for r in trecs] == [r.get("step") for r in jrecs]
    assert [set(r) - {"ts"} for r in trecs] == [
        set(r) - {"ts", "_wall"} for r in jrecs]


def test_main_runs_on_the_cpu_when_asked(store, tmp_path, capsys):
    out = tmp_path / "cli"
    tsweep.main(["--experiment", "dense_l1_range", "--device", "cpu",
                 "--dataset_folder", str(store), "--output_folder", str(out),
                 "--batch_size", str(BATCH), "--learned_dict_ratio", "2",
                 "--image_metrics_every", "none"])
    assert "dense_l1_range: 16 dicts" in capsys.readouterr().out
    assert (out / "ckpt" / "dense_l1_range_0.tensors").exists()
    assert len(load_learned_dicts(out / "_3" / "dense_l1_range_learned_dicts.pkl")) == 16


def test_main_without_a_card_raises(store, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.main(["--experiment", "dense_l1_range",
                     "--dataset_folder", str(store),
                     "--output_folder", str(tmp_path / "x")])


@pytest.mark.parametrize("over, on_mesh, error, match", [
    ({"mesh_data": 2}, False, ValueError, "needs 2 ranks, have 1"),
    ({"checkpoint_backend": "msgpack"}, True, ValueError,
     "single-host only; use checkpoint_backend='orbax'"),
    ({"use_wandb": True, "batch_size": BATCH, "n_chunks": 1,
      "learned_dict_ratio": RATIO}, False, None, None),
], ids=["mesh", "orbax", "wandb"])
def test_deferred_options_raise_naming_their_item(store, tmp_path,
                                                  monkeypatch, over,
                                                  on_mesh, error, match):
    """What the sweep still lacks raises naming its ROADMAP item; a mesh
    larger than the world (no world here) raises before any training; a
    mesh across nodes needs the orbax backend's per-rank writes (msgpack
    gathers to one host), as the JAX sweep says. ``use_wandb`` is ported
    (``error`` None): where wandb does not import the sweep runs with
    metrics.jsonl alone, as the JAX sweep does."""
    from sparse_coding_tpu_torch.parallel.mesh import Mesh

    cfg = EnsembleArgs(output_folder=str(tmp_path / "o"),
                       dataset_folder=str(store), **over)
    mesh = None
    if on_mesh:
        mesh = Mesh(2, 1, "cpu")
        monkeypatch.setattr(tsweep, "local_world_is_world", lambda: False)
    if error is None:
        monkeypatch.setitem(sys.modules, "wandb", None)  # not importable
        tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                     log_every=1, image_metrics_every=None)
        assert (tmp_path / "o" / "metrics.jsonl").read_text()
        return
    with pytest.raises(error, match=match):
        tsweep.sweep(texp.dense_l1_range_experiment, cfg, device="cpu",
                     mesh=mesh)


def test_profile_steps_capture_one_trace_window(store, tmp_path):
    """``profile_steps > 0`` opens one managed trace window after the
    first steps: the capture lands whole in ``<output>/trace`` (the
    Chrome trace and the device-kernel table, empty on the CPU), counted
    once, and the trained dicts are bitwise a run without it."""
    from sparse_coding_tpu_torch import obs
    from sparse_coding_tpu_torch.obs.registry import Registry

    build = lambda c, m, device=None: texp.dense_l1_range_experiment(
        c, m, l1_range=L1S[:1], activation_dim=D, device=device)
    base = dict(dataset_folder=str(store), batch_size=BATCH, n_chunks=1,
                learned_dict_ratio=RATIO)
    prev = obs.set_registry(Registry())
    try:
        traced = tsweep.sweep(build, EnsembleArgs(
            output_folder=str(tmp_path / "traced"), profile_steps=1, **base),
            device="cpu", image_metrics_every=None)
        counters = obs.get_registry().snapshot()["counters"]
    finally:
        obs.set_registry(prev)
    plain = tsweep.sweep(build, EnsembleArgs(
        output_folder=str(tmp_path / "plain"), **base), device="cpu",
        image_metrics_every=None)
    trace = tmp_path / "traced" / "trace"
    events = json.loads((trace / "trace.json").read_text())
    assert events["traceEvents"]
    assert json.loads((trace / "kernels.json").read_text()) == {}
    assert counters.get("obs.trace.captured") == 1
    assert "obs.trace.skipped" not in counters
    assert not list((tmp_path / "traced").glob(".trace.tmp.*"))
    torch.testing.assert_close(traced["dense_l1_range"][0][0].dictionary,
                               plain["dense_l1_range"][0][0].dictionary,
                               rtol=0, atol=0)


def test_unported_experiments_and_sharded_stores_raise(store, tmp_path):
    """Every JAX experiment has a port counterpart, and a mesh the world
    cannot hold raises. Sharded stores open now
    (tests/test_torch_port_shard_store.py sweeps over one): a folder whose
    manifest.json lists no shards raises the typed layout error."""
    from sparse_coding_tpu_torch.data.shard_store import ShardLayoutError

    assert set(texp.EXPERIMENTS) == set(jexp.EXPERIMENTS)
    cfg = EnsembleArgs(output_folder=str(tmp_path / "o"),
                       dataset_folder=str(store))
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        tsweep.sweep(texp.EXPERIMENTS["topk"], cfg.replace(mesh_model=2),
                     device="cpu")
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    (sharded / "manifest.json").write_text("{}")
    with pytest.raises(ShardLayoutError, match="lists no shards"):
        tsweep.sweep(texp.dense_l1_range_experiment,
                     cfg.replace(dataset_folder=str(sharded)), device="cpu")


def test_synthetic_dataset_sweep(tmp_path):
    """SyntheticEnsembleArgs writes its store with the port's generator and
    trains on it; a second call reuses the store."""
    from sparse_coding_tpu_torch.config import SyntheticEnsembleArgs
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

    cfg = SyntheticEnsembleArgs(
        output_folder=str(tmp_path / "out"),
        dataset_folder=str(tmp_path / "chunks"), batch_size=128, n_chunks=3,
        activation_dim=16, n_ground_truth_features=24, dataset_size=1536,
        learned_dict_ratio=2.0)
    build = lambda c, m, device=None: texp.dense_l1_range_experiment(
        c, m, l1_range=[1e-3], activation_dim=16, device=device)
    res = tsweep.sweep(build, cfg, device="cpu", image_metrics_every=None)
    store = ChunkStore(tmp_path / "chunks")
    assert store.n_chunks == 3 and store.meta["synthetic"]
    assert np.load(tmp_path / "chunks" / "ground_truth_feats.npy").shape == (
        24, 16)
    again = tsweep.sweep(build, cfg.replace(output_folder=str(tmp_path / "o2")),
                         device="cpu", image_metrics_every=None)
    torch.testing.assert_close(res["dense_l1_range"][0][0].dictionary,
                               again["dense_l1_range"][0][0].dictionary,
                               rtol=0, atol=0)
