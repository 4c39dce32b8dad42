"""The port's baseline dicts and their trainers (sparse_coding_tpu_torch/
models/ica.py, nmf.py, direct_coef.py, combination.py,
ensemble.py::resurrect_ensemble_features, train/baselines.py and
train/toy_models.py) against the JAX package's, on the same numpy data.

Tolerances:
- ICA and NMF fits: sklearn runs on the same float64 host arrays on
  either side, so the fitted arrays agree within 1e-6 (they are equal);
  their encodes within RTOL = 1e-5 of max|ref| (fp32 products);
- FISTA codes within 2e-4 of max|ref|: 50 iterations of fp32 products
  in other orders;
- resurrection: everything but the fresh directions bitwise the JAX
  engine's; the fresh rows' norms (the live-row mean) within RTOL;
- the toy ensemble's trajectory, 20 steps through ``Ensemble`` from the
  same numpy inits and batches: losses and params within 2e-4 (the JAX
  package's fused-vs-autodiff bound, as tests/test_torch_port_ensemble.py
  holds the engine);
- PCA baselines: the port solves ``eigh`` in float64, the JAX package in
  float32; eigenvector rows agree up to sign within 1e-4 on a spectrum
  with distinct eigenvalues.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from sparse_coding_tpu import ensemble as jensemble
from sparse_coding_tpu.ensemble import Ensemble as JaxEnsemble
from sparse_coding_tpu.models import TiedSAE as JTiedSAE
from sparse_coding_tpu.models import combination as jcomb
from sparse_coding_tpu.models import direct_coef as jdc
from sparse_coding_tpu.models import ica as jica
from sparse_coding_tpu.models import nmf as jnmf
from sparse_coding_tpu.models.sae import FunctionalTiedSAE as JaxTiedSig
from sparse_coding_tpu.models.signatures import get_signature as jget
from sparse_coding_tpu.train import baselines as jbaselines
from sparse_coding_tpu.utils import artifacts as jart
from sparse_coding_tpu_torch import config as tconfig
from sparse_coding_tpu_torch import ensemble as tensemble
from sparse_coding_tpu_torch.data.chunk_store import ChunkWriter
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.models import TiedSAE
from sparse_coding_tpu_torch.models import combination, direct_coef, ica, nmf
from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE
from sparse_coding_tpu_torch.train import baselines, toy_models
from sparse_coding_tpu_torch.utils import artifacts as tart
from sparse_coding_tpu_torch.utils.carry import (
    members_from_numpy,
    state_from_numpy,
)

RTOL = 1e-5  # of max|ref|
FIT_TOL = 1e-6
FISTA_RTOL = 2e-4
TRAJ_TOL = dict(rtol=2e-4, atol=1e-6)
PCA_TOL = 1e-4


def _close(got, ref, what, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rtol * max(float(np.abs(ref).max()), 1e-30), (what, err)


def _data(n=300, d=8, seed=0):
    """Non-Gaussian sources with a distinct spectrum (ICA and PCA need
    both), mixed."""
    rs = np.random.default_rng(seed)
    s = rs.laplace(size=(n, d)) * np.geomspace(3.0, 0.3, d)
    return (s @ rs.normal(size=(d, d))).astype(np.float32)


# -- ICA, NMF, FISTA, concat ---------------------------------------------------

def test_ica_fit_and_encodes_match_jax():
    x = _data(n=200)
    got = ica.ICAEncoder.train(x, random_state=3, device="cpu")
    ref = jica.ICAEncoder.train(jnp.asarray(x), random_state=3)
    for f in ("components", "scaler_mean", "scaler_scale", "ica_mean"):
        _close(getattr(got, f), getattr(ref, f), f, rtol=FIT_TOL)
    tx = torch.from_numpy(x[:40])
    _close(got.encode(tx), ref.encode(x[:40]), "encode")
    _close(got.get_learned_dict(), ref.get_learned_dict(), "dict")
    _close(got.to_topk_dict(3).encode(tx), ref.to_topk_dict(3).encode(x[:40]),
           "topk encode")
    nn_got, nn_ref = got.to_nneg_dict(), ref.to_nneg_dict()
    _close(nn_got.encode(tx), nn_ref.encode(x[:40]), "nneg encode")
    _close(nn_got.get_learned_dict(), nn_ref.get_learned_dict(), "nneg dict")
    assert (nn_got.encode(tx) >= 0).all()


def test_nmf_fit_and_encodes_match_jax():
    x = _data(n=120, d=6, seed=1)
    got = nmf.NMFEncoder.train(x, n_components=4, max_iter=400, device="cpu")
    ref = jnmf.NMFEncoder.train(jnp.asarray(x), n_components=4, max_iter=400)
    _close(got.components, ref.components, "components", rtol=FIT_TOL)
    assert float(got.shift) == float(ref.shift) < 0
    _close(got.encode(torch.from_numpy(x[:30])), ref.encode(x[:30]), "encode")
    _close(got.to_topk_dict(2).encode(torch.from_numpy(x[:30])),
           ref.to_topk_dict(2).encode(x[:30]), "topk encode")
    with pytest.raises(RuntimeError, match="fitted sklearn model"):
        dataclasses.replace(got, _nmf=None).encode(torch.from_numpy(x[:2]))


@pytest.mark.parametrize("nonneg", [True, False])
def test_fista_codes_match_jax(nonneg):
    rs = np.random.default_rng(2)
    dictionary = rs.normal(size=(24, 10)).astype(np.float32)
    x = rs.normal(size=(16, 10)).astype(np.float32)
    got = direct_coef.DirectCoefOptimizer(
        dictionary=torch.from_numpy(dictionary), l1_alpha=0.05,
        nonneg=nonneg).encode(torch.from_numpy(x))
    ref = jdc.DirectCoefOptimizer(dictionary=jnp.asarray(dictionary),
                                  l1_alpha=0.05, nonneg=nonneg).encode(
        jnp.asarray(x))
    _close(got, ref, "fista codes", rtol=FISTA_RTOL)
    assert (np.asarray(ref) == 0).mean() > 0.2  # sparse


def _tied(d, n, seed, **kw):
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(n, d)).astype(np.float32)
    b = (rs.normal(size=n) * 0.2).astype(np.float32)
    return (JTiedSAE(dictionary=jnp.asarray(w), encoder_bias=jnp.asarray(b),
                     **{k: jnp.asarray(v) for k, v in kw.items()}),
            TiedSAE(dictionary=torch.from_numpy(w),
                    encoder_bias=torch.from_numpy(b),
                    **{k: torch.from_numpy(v) for k, v in kw.items()}))


def test_concat_ensemble_matches_jax():
    (j1, t1), (j2, t2) = _tied(8, 12, 3), _tied(8, 20, 4)
    got = combination.ConcatEnsembleDict.create([t1, t2])
    ref = jcomb.ConcatEnsembleDict.create([j1, j2])
    x = np.random.default_rng(5).normal(size=(9, 8)).astype(np.float32)
    tx = torch.from_numpy(x)
    _close(got.encode(tx), ref.encode(x), "encode")
    _close(got.predict(tx), ref.predict(x), "predict")
    _close(got.predict(tx), (t1.predict(tx) + t2.predict(tx)) / 2, "bagging")
    assert got.n_feats == 32
    _, centered = _tied(8, 12, 6, centering_trans=np.ones(8, np.float32))
    with pytest.raises(ValueError, match="non-identity centering"):
        combination.ConcatEnsembleDict.create([t1, centered])


@pytest.fixture(scope="module")
def new_dicts():
    """(port dict, JAX dict) of each new class from the same arrays."""
    x = _data(n=80, d=6, seed=7)
    t_ica = ica.ICAEncoder.train(x, random_state=0, device="cpu")
    j_ica = jica.ICAEncoder.train(jnp.asarray(x), random_state=0)
    t_nmf = nmf.NMFEncoder.train(x, n_components=3, max_iter=300,
                                 device="cpu")
    j_nmf = jnmf.NMFEncoder.train(jnp.asarray(x), n_components=3,
                                  max_iter=300)
    w = np.random.default_rng(8).normal(size=(10, 6)).astype(np.float32)
    (j1, t1), (j2, t2) = _tied(6, 10, 9), _tied(6, 4, 10)
    return {
        "ICAEncoder": (t_ica, j_ica),
        "NNegICAEncoder": (t_ica.to_nneg_dict(), j_ica.to_nneg_dict()),
        "NMFEncoder": (t_nmf, j_nmf),
        "DirectCoefOptimizer": (
            direct_coef.DirectCoefOptimizer(dictionary=torch.from_numpy(w),
                                            l1_alpha=0.01, n_iters=7),
            jdc.DirectCoefOptimizer(dictionary=jnp.asarray(w), l1_alpha=0.01,
                                    n_iters=7)),
        "ConcatEnsembleDict": (
            combination.ConcatEnsembleDict.create([t1, t2]),
            jcomb.ConcatEnsembleDict.create([j1, j2])),
    }


@pytest.mark.parametrize("name", ["ICAEncoder", "NNegICAEncoder",
                                  "NMFEncoder", "DirectCoefOptimizer",
                                  "ConcatEnsembleDict"])
def test_pkl_round_trip_both_ways(tmp_path, new_dicts, name):
    t_dict, j_dict = new_dicts[name]
    x = _data(n=12, d=6, seed=11)
    tart.save_learned_dicts([(t_dict, {"who": "port"})], tmp_path / "t.pkl")
    jart.save_learned_dicts([(j_dict, {"who": "jax"})], tmp_path / "j.pkl")
    (j_from_t, h1), = jart.load_learned_dicts(tmp_path / "t.pkl")
    (t_from_j, h2), = tart.load_learned_dicts(tmp_path / "j.pkl")
    (t_from_t, _), = tart.load_learned_dicts(tmp_path / "t.pkl")
    assert (h1, h2) == ({"who": "port"}, {"who": "jax"})
    assert type(j_from_t).__name__ == type(t_from_j).__name__ == name
    ref = np.asarray(j_dict.encode(jnp.asarray(x)))
    _close(j_from_t.encode(jnp.asarray(x)), t_dict.encode(
        torch.from_numpy(x)), f"{name}: JAX from the port's file")
    for d in (t_from_j, t_from_t):
        assert type(d) is type(t_dict)
        _close(d.encode(torch.from_numpy(x)), ref, f"{name}: port load")


# -- resurrection --------------------------------------------------------------

RESURRECT_SIGS = {  # JAX signature name -> init kwargs
    "tied_sae": {"l1_alpha": 1e-3},
    "sae": {"l1_alpha": 1e-3},
    "positive_tied_sae": {"l1_alpha": 1e-3},
    "thresholding_sae": {"l1_alpha": 1e-3},
    "semilinear_sae": {"l1_alpha": 1e-3},
    "rica": {"sparsity_coef": 1e-3},
    "lista_denoising_sae": {"l1_alpha": 1e-3},
}


@pytest.mark.parametrize("sig_name", list(RESURRECT_SIGS))
def test_resurrection_contract_against_jax(sig_name):
    d, n, members = 8, 16, 3
    jsig = jget(sig_name)
    keys = jax.random.split(jax.random.PRNGKey(12), members)
    inits = jax.device_get([jsig.init(k, d, n, **RESURRECT_SIGS[sig_name])
                            for k in keys])
    stack = lambda *vs: np.stack(vs)
    params = jax.tree.map(stack, *[p for p, _ in inits])
    split = [tensemble.split_buffers(b) for _, b in inits]
    buffers = jax.tree.map(stack, *[a for a, _ in split])
    statics = split[0][1]
    rs = np.random.default_rng(13)
    noise = lambda v: rs.normal(size=v.shape).astype(v.dtype)
    mu, nu = jax.tree.map(noise, params), jax.tree.map(noise, params)
    count, lrs = np.full(members, 3, np.int32), np.full(members, 1e-3,
                                                       np.float32)
    jstate = jensemble.EnsembleState(
        params=params, buffers=buffers,
        opt_state=optax.ScaleByAdamState(count=count, mu=mu, nu=nu),
        lrs=lrs, step=np.int32(3), static_buffers=statics,
        sig_name=jsig.signature_name)
    before = state_from_numpy(params=params, buffers=buffers, mu=mu, nu=nu,
                              count=count, lrs=lrs, step=3,
                              static_buffers=statics,
                              sig_name=jsig.signature_name)
    dead = rs.uniform(size=(members, n)) < 0.3
    dead[:, 0], dead[:, 1] = True, False
    ref = jax.device_get(jensemble.resurrect_ensemble_features(
        jstate, jnp.asarray(dead), jax.random.PRNGKey(14)))
    got = tensemble.resurrect_ensemble_features(
        before, torch.from_numpy(dead), torch.Generator().manual_seed(14))
    ref_state = state_from_numpy(
        params=ref.params, buffers=ref.buffers, mu=ref.opt_state.mu,
        nu=ref.opt_state.nu, count=ref.opt_state.count, lrs=ref.lrs,
        live=ref.live, step=ref.step, static_buffers=ref.static_buffers,
        sig_name=ref.sig_name)
    rows = [k for k in got.params if k in jensemble._RESURRECT_ROW_PARAMS]
    assert rows, "no row parameter to refresh"
    dm = torch.from_numpy(dead)
    for k in got.params:
        g, r, b = got.params[k], ref_state.params[k], before.params[k]
        if k in rows:
            # live rows bitwise; fresh rows have the live-row mean norm
            assert torch.equal(g[~dm], b[~dm]), k
            _close(g.norm(dim=-1)[dm], r.norm(dim=-1)[dm], f"{k} norms")
            assert not torch.equal(g[dm], b[dm]), k
        else:
            assert torch.equal(g, r), k  # scalars reset, the rest bitwise
        for mom in ("mu", "nu"):
            gm, rm = getattr(got, mom)[k], getattr(ref_state, mom)[k]
            assert torch.equal(gm, rm), (mom, k)
    if sig_name == "positive_tied_sae":
        assert (got.params["encoder_bias"][dm] == -1.0).all()
    if sig_name == "lista_denoising_sae":  # nested params untouched
        nested = [k for k in got.params if "/" in k]
        assert nested and all(torch.equal(got.params[k], before.params[k])
                              for k in nested)


# -- toy models and the baseline runner -----------------------------------------

def test_toy_ensemble_trajectory_matches_jax():
    """ToyArgs' ensemble (three tied members over an L1 grid) 20 steps
    through Ensemble on the same ground-truth batches from the same numpy
    inits; the port on its default path's plain versions."""
    d, n_gt, n_dict, batch, steps = 16, 32, 64, 64, 20
    rs = np.random.default_rng(15)
    feats = rs.normal(size=(n_gt, d))
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    codes = rs.uniform(size=(steps, batch, n_gt)) * (
        rs.uniform(size=(steps, batch, n_gt)) < 5 / n_gt)
    data = (codes @ feats).astype(np.float32)
    l1s = [1e-3 / 3, 1e-3, 3e-3]
    keys = jax.random.split(jax.random.PRNGKey(16), 3)
    jm = [JaxTiedSig.init(k, d, n_dict, l1_alpha=l1) for k, l1 in
          zip(keys, l1s)]
    jens = JaxEnsemble(jm, JaxTiedSig, lr=1e-3, donate=False)
    tens = Ensemble(members_from_numpy(jax.device_get(jm)), FunctionalTiedSAE,
                    lr=1e-3, device="cpu")
    for b in data:
        ja = jens.step_batch(jnp.asarray(b))
        ta = tens.step_batch(torch.from_numpy(b))
        np.testing.assert_allclose(ta.losses["loss"].numpy(),
                                   jax.device_get(ja.losses["loss"]),
                                   **TRAJ_TOL)
    assert tens.fused_path == "train_step_tiled"
    s = jax.device_get(jens.state.params)
    for k in s:
        np.testing.assert_allclose(tens.state.params[k].numpy(), s[k],
                                   **TRAJ_TOL, err_msg=k)


def test_toy_replication_gate(tmp_path):
    """The JAX package's gate config (tests/test_plotting_toy.py): best
    representedness above 0.85; the json and the plot written."""
    cfg = tconfig.ToyArgs(activation_dim=48, n_ground_truth_features=64,
                          feature_num_nonzero=5, learned_dict_ratio=1.5,
                          l1_alpha=1e-3, lr=3e-3, batch_size=512, epochs=3,
                          dataset_size=120_000)
    results = toy_models.run_toy_replication(cfg, output_folder=tmp_path,
                                             device="cpu")
    assert (tmp_path / "toy_recovery.json").exists()
    assert (tmp_path / "toy_recovery.png").exists()
    assert [r["l1_alpha"] for r in results] == [1e-3 / 3, 1e-3, 3e-3]
    assert all(np.isfinite(list(r.values())).all() for r in results)
    assert max(r["representedness"] for r in results) > 0.85


def test_toy_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    toy_models.main(["--device", "cpu", "--activation_dim", "8",
                     "--n_ground_truth_features", "16", "--batch_size", "32",
                     "--dataset_size", "64"])
    assert (tmp_path / "toy_output" / "toy_recovery.json").exists()
    assert capsys.readouterr().out.count("representedness") == 3


def _write_store(folder, x):
    w = ChunkWriter(folder, x.shape[1], chunk_size_gb=x.nbytes / 2**30,
                    dtype="float32")
    w.add(x)
    w.finalize()


def _sign_aligned(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a * np.sign((a * b).sum(-1, keepdims=True)), b


def test_run_layer_baselines_match_jax(tmp_path, monkeypatch):
    x = _data(n=1024, d=12, seed=17)
    _write_store(tmp_path / "store", x)
    _, ref_dict = _tied(12, 24, 18)
    j_ref, _ = _tied(12, 24, 18)
    kw = dict(sparsity=4, max_ica_samples=512, seed=0)
    # both runners fit FastICA with random_state=None, from numpy's
    # global generator: seeded alike before each
    np.random.seed(20)
    got = baselines.run_layer_baselines(tmp_path / "store", tmp_path / "t",
                                        reference_dict=ref_dict,
                                        device="cpu", **kw)
    np.random.seed(20)
    ref = jbaselines.run_layer_baselines(tmp_path / "store", tmp_path / "j",
                                         reference_dict=j_ref, **kw)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert set(got) == set(ref) == {p[:-4] for p in names}
    hyp = lambda side, nm: jart.load_learned_dicts(
        tmp_path / side / f"{nm}.pkl")[0][1]
    assert hyp("t", "ica") == hyp("j", "ica")  # the measured sparsity
    for nm, field in (("pca", "pca_dict"), ("pca_topk", "dictionary"),
                      ("pca_rotation", "rotation")):
        a, b = _sign_aligned(getattr(got[nm], field).numpy(),
                             getattr(ref[nm], field))
        np.testing.assert_allclose(a, b, atol=PCA_TOL, err_msg=nm)
    for f in ("components", "scaler_mean", "scaler_scale", "ica_mean"):
        _close(getattr(got["ica"], f), getattr(ref["ica"], f), f,
               rtol=FIT_TOL)
    _close(got["ica_topk"].dictionary, ref["ica_topk"].dictionary, "ica topk",
           rtol=FIT_TOL)
    assert got["ica_topk"].k == ref["ica_topk"].k
    rnd = got["random"].dictionary
    assert rnd.shape == ref["random"].dictionary.shape
    torch.testing.assert_close(rnd.norm(dim=-1), torch.ones(12))
    np.testing.assert_array_equal(got["identity_relu"].eye.numpy(),
                                  ref["identity_relu"].eye)

    # each artifact that exists is skipped; remake refits
    fits = []
    real = ica.ICAEncoder.train
    monkeypatch.setattr(baselines.ICAEncoder, "train", classmethod(
        lambda cls, *a, **k: fits.append(1) or real(*a, **k)))
    stamps = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "t").iterdir()}
    again = baselines.run_layer_baselines(tmp_path / "store", tmp_path / "t",
                                          device="cpu", **kw)
    assert fits == [] and set(again) == set(got)
    assert stamps == {p.name: p.stat().st_mtime_ns
                      for p in (tmp_path / "t").iterdir()}
    (tmp_path / "t" / "ica_topk.pkl").unlink()
    baselines.run_layer_baselines(tmp_path / "store", tmp_path / "t",
                                  device="cpu", **kw)
    assert fits == [1]
    baselines.run_layer_baselines(tmp_path / "store", tmp_path / "t",
                                  device="cpu", remake=True, **kw)
    assert fits == [1, 1]
    assert stamps["random.pkl"] != (tmp_path / "t" / "random.pkl"
                                    ).stat().st_mtime_ns


def test_run_all_baselines_layout(tmp_path):
    x = _data(n=512, d=8, seed=19)
    for layer in (1, 3):
        _write_store(tmp_path / "chunks" / f"mlp.{layer}", x)
    baselines.run_all_baselines(tmp_path / "chunks", tmp_path / "out", [1, 3],
                                layer_locs=("mlp",), sparsity=2,
                                max_ica_samples=256, device="cpu")
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "l1_mlp", "l3_mlp"]
    assert len(list((tmp_path / "out" / "l3_mlp").iterdir())) == 7
