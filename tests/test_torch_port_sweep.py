"""The port's end-to-end slice, ``train/basic_sweep.py::basic_l1_sweep``,
against the JAX package's on one tiny activation store — tied and, with
``tied=False``, untied — plus the modules it leans on: config, metrics
and the synthetic generator."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sparse_coding_tpu import config as jconfig
from sparse_coding_tpu.data.chunk_store import ChunkWriter as JaxChunkWriter
from sparse_coding_tpu.metrics import core as jmetrics
from sparse_coding_tpu.train.basic_sweep import basic_l1_sweep as jax_sweep
from sparse_coding_tpu.utils.artifacts import (
    load_learned_dicts as jax_load_learned_dicts,
)
from sparse_coding_tpu_torch import config as tconfig
from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator
from sparse_coding_tpu_torch.metrics import core as tmetrics
from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts
from torch_port_helpers import batches

D, RATIO, BATCH = 32, 2.0, 64
L1_VALUES = [1e-4, 1e-3, 1e-2]
# Per-member final metrics of the two sweeps. The inits differ (a
# torch.Generator vs jax.random), everything else — store, epoch order,
# L1 grid, Adam, step count — is the same. Across port seeds 0-3 on this
# store the members' FVU lay within 0.011 and L0 within 4.6% of the JAX
# run's, tied and untied alike, so the band is FVU ± 0.03 absolute and
# L0 ± 10%.
FVU_BAND, L0_BAND = 0.03, 0.10
# the learned-dict class each family exports, and one field of [n, d]
EXPORTS = {True: ("TiedSAE", "dictionary"), False: ("UntiedSAE", "encoder")}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One tiny activation store (JAX writer) that every sweep reads."""
    root = tmp_path_factory.mktemp("sweep")
    w = JaxChunkWriter(root / "store", D, chunk_size_gb=2048 * D * 2 / 2**30,
                       dtype="float16")
    for b in batches(seed=0, n=112, batch=128, d=D):
        w.add(b)
    w.finalize()
    return root


@pytest.fixture(scope="module", params=[True, False],
                ids=["tied", "untied"])
def sweeps(store, request):
    """One sweep of the family on each side: 224 steps each, so both log
    at steps 100 and 200."""
    root = store / ("tied" if request.param else "untied")
    kw = dict(dict_ratio=RATIO, batch_size=BATCH, lr=3e-3, seed=0,
              tied=request.param)
    jd = jax_sweep(store / "store", root / "jax", L1_VALUES, **kw)
    td = basic_l1_sweep(store / "store", root / "torch", L1_VALUES,
                        device="cpu", **kw)
    return root, jd, td, request.param


def test_sweep_artifacts_cross_load(sweeps):
    """Each side's epoch_0/learned_dicts.pkl loads with the other's
    load_learned_dicts, same class, shapes and hyperparams."""
    root, jd, td, tied = sweeps
    cls, field = EXPORTS[tied]
    port_in_jax = jax_load_learned_dicts(root / "torch/epoch_0/learned_dicts.pkl")
    jax_in_port = load_learned_dicts(root / "jax/epoch_0/learned_dicts.pkl")
    assert len(port_in_jax) == len(jax_in_port) == len(L1_VALUES)
    for (a, ha), (b, hb) in zip(port_in_jax, jax_in_port):
        assert type(a).__name__ == type(b).__name__ == cls
        assert ha.keys() == hb.keys()
        assert np.asarray(getattr(a, field)).shape == \
            tuple(getattr(b, field).shape) == (int(D * RATIO), D)
    assert [h for _, h in jd] == [h for _, h in td]


def test_sweep_eval_json_keys_and_band(sweeps):
    """eval.json has the same records; per-member FVU and L0 lie within
    the stated band of the JAX run (different inits, same training)."""
    root = sweeps[0]
    je = json.loads((root / "jax/epoch_0/eval.json").read_text())
    te = json.loads((root / "torch/epoch_0/eval.json").read_text())
    assert [set(r) for r in te] == [set(r) for r in je]
    for j, t in zip(je, te):
        assert t["l1_alpha"] == j["l1_alpha"]
        assert abs(t["fvu"] - j["fvu"]) <= FVU_BAND, (t, j)
        assert abs(t["l0"] - j["l0"]) <= L0_BAND * j["l0"], (t, j)
    assert te[0]["fvu"] < te[-1]["fvu"] and te[0]["l0"] > te[-1]["l0"]


def test_sweep_metrics_log(sweeps):
    root = sweeps[0]
    recs = [json.loads(line) for line in
            (root / "torch/metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [100, 200]
    for l1 in L1_VALUES:
        for k in ("loss", "mse", "l0"):
            assert np.isfinite(recs[-1][f"l1={l1:.2e}/{k}"])
        assert recs[-1][f"l1={l1:.2e}/loss"] < recs[0][f"l1={l1:.2e}/loss"]


def test_sweep_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        basic_l1_sweep(tmp_path, tmp_path / "out", L1_VALUES)


@pytest.mark.parametrize("cls", ["DataArgs", "EnsembleArgs",
                                 "SyntheticEnsembleArgs", "BigSAEArgs",
                                 "ToyArgs", "ErasureArgs"])
def test_config_matches_jax(cls):
    """Same fields, defaults and CLI parsing as the JAX package's."""
    j, t = getattr(jconfig, cls), getattr(tconfig, cls)
    jf = {f.name: f for f in dataclasses.fields(j)}
    tf = {f.name: f for f in dataclasses.fields(t)}
    assert list(tf) == list(jf)
    assert t().to_dict() == j().to_dict()
    argv = ["--seed", "3", "--dataset_folder", "acts"]
    if cls in ("EnsembleArgs", "SyntheticEnsembleArgs"):
        argv += ["--batch_size", "512", "--fused_path", "two_stage",
                 "--tied_ae", "true", "--lr", "3e-4"]
    if cls == "SyntheticEnsembleArgs":
        argv += ["--dataset_size", "4096", "--correlated_components", "true",
                 "--feature_prob_decay", "0.95"]
    if cls == "BigSAEArgs":
        argv += ["--n_feats", "4096", "--l1_alpha", "3e-4",
                 "--resurrect_every", "0", "--scan_steps", "4"]
    if cls == "ToyArgs":
        argv += ["--activation_dim", "48", "--learned_dict_ratio", "1.5",
                 "--correlated_components", "true", "--lr", "3e-3"]
    if cls == "ErasureArgs":
        argv += ["--layers", "[1, 3]", "--layer_loc", "mlp",
                 "--max_edit_feats", "16", "--dict_path", "d.pkl"]
    assert t.from_cli(argv).to_dict() == j.from_cli(argv).to_dict()


def test_metrics_match_jax():
    from sparse_coding_tpu.models.learned_dict import TiedSAE as JaxTiedSAE
    from sparse_coding_tpu_torch.models.learned_dict import TiedSAE

    rs = np.random.default_rng(3)
    w = rs.normal(size=(48, D)).astype(np.float32)
    b = (rs.normal(size=48) * 0.1).astype(np.float32)
    x = batches(seed=4, n=1, batch=256, d=D)[0]
    jd = JaxTiedSAE(dictionary=w, encoder_bias=b)
    td = TiedSAE(dictionary=torch.from_numpy(w), encoder_bias=torch.from_numpy(b))
    np.testing.assert_allclose(
        float(tmetrics.fraction_variance_unexplained(td, torch.from_numpy(x))),
        float(jmetrics.fraction_variance_unexplained(jd, x)), rtol=1e-5)
    assert float(tmetrics.mean_l0(td, torch.from_numpy(x))) == float(
        jmetrics.mean_l0(jd, x))


def test_synthetic_generator_statistics():
    """The RNG differs from jax.random, the distribution does not:
    unit-norm features, geometric-decay inclusion, nonnegative codes."""
    g = torch.Generator().manual_seed(0)
    gen = RandomDatasetGenerator.create(g, 16, 64, 4, 0.95)
    codes, data = gen.batch_with_codes(g, 20000)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(gen.feats, dim=-1).numpy(), 1.0, rtol=1e-5)
    probs = (4 / 64) * 0.95 ** np.arange(64)
    freq = (codes > 0).float().mean(0).numpy()
    np.testing.assert_allclose(freq, probs, atol=0.01)
    assert (codes >= 0).all() and data.shape == (20000, 16)
    corr = RandomDatasetGenerator.create(g, 16, 64, 4, 0.95, correlated=True)
    c, _ = corr.batch_with_codes(g, 2000)
    assert ((c > 0).sum(-1) > 0).all()  # no all-zero rows
