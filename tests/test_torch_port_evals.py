"""The port's evaluation stage (sparse_coding_tpu_torch/metrics/
intervention.py, erasure.py, erasure_driver.py, geometry.py, tasks/ and
plotting/erasure.py) against the JAX package's, on the same tiny
random-weight LM (the JAX ``init_params``, carried by
``lm.convert.params_from_numpy``), the same numpy dicts and tokens.

Tolerances:
- LM-level numbers (losses, perplexities, task metrics, effects, KL,
  the encoded codes and the ablation graphs' edge weights) within
  RTOL = 1e-5 of max|ref|: the LM forward's own bound
  (tests/test_torch_port_lm.py), both sides fp32, sums in other orders
  (the graphs' weights measured within 2.5e-7 of the largest);
- ``LeaceEraser``: the port solves in float64, the JAX package in
  float32; the projections differ by 1.0e-6 of max|P| here and are held
  at LEACE_TOL = 1e-5, the erased activations (4.0e-7 measured) at
  RTOL; the port's erased activations keep no cross-covariance with the
  labels (below 1e-6);
- probe AUROCs (sklearn's logistic regression on either side's floats)
  within 1e-3; the IOI rankings, the task datasets, the clusterings and
  the activity counts exactly.
"""

import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.config import ErasureArgs as JErasureArgs
from sparse_coding_tpu.data.chunk_store import ChunkStore as JChunkStore
from sparse_coding_tpu.lm import gptneox as jneox
from sparse_coding_tpu.lm.model_config import tiny_test_config
from sparse_coding_tpu.metrics import erasure as jerasure
from sparse_coding_tpu.metrics import erasure_driver as jdriver
from sparse_coding_tpu.metrics import geometry as jgeometry
from sparse_coding_tpu.metrics import intervention as jint
from sparse_coding_tpu.models import Identity as JIdentity
from sparse_coding_tpu.models import Rotation as JRotation
from sparse_coding_tpu.models import TiedSAE as JTiedSAE
from sparse_coding_tpu.tasks import feature_ident as jfi
from sparse_coding_tpu.tasks import gender as jgender
from sparse_coding_tpu.tasks import ioi as jioi
from sparse_coding_tpu.tasks import ioi_counterfact as jcf
from sparse_coding_tpu.utils.artifacts import save_learned_dicts
from sparse_coding_tpu_torch.config import ErasureArgs
from sparse_coding_tpu_torch.data.chunk_store import ChunkStore, ChunkWriter
from sparse_coding_tpu_torch.lm import convert
from sparse_coding_tpu_torch.metrics import erasure, erasure_driver
from sparse_coding_tpu_torch.metrics import geometry
from sparse_coding_tpu_torch.metrics import intervention as tint
from sparse_coding_tpu_torch.models import Identity, Rotation, TiedSAE
from sparse_coding_tpu_torch.plotting.erasure import (
    plot_erasure_tradeoff,
    plot_task_ablation_curve,
)
from sparse_coding_tpu_torch.tasks import feature_ident as tfi
from sparse_coding_tpu_torch.tasks import gender as tgender
from sparse_coding_tpu_torch.tasks import ioi as tioi
from sparse_coding_tpu_torch.tasks import ioi_counterfact as tcf

RTOL = 1e-5  # of max|ref|
LEACE_TOL = 1e-5
AUROC_TOL = 1e-3
N_FEATS = 48
LOC1, LOC2 = (1, "residual"), (2, "residual")


def _close(got, ref, what, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= rtol * max(float(np.abs(ref).max()), 1e-30), (what, err)


class StubTokenizer:
    """Word-level: each word one id, from zlib.crc32 (the same in every
    process) inside the vocabulary, 0 reserved for padding."""

    pad_token_id = 0

    def __init__(self, vocab: int):
        self.vocab = vocab

    def _encode(self, text):
        return [zlib.crc32(w.encode()) % (self.vocab - 1) + 1
                for w in text.split()]

    def __call__(self, texts):
        if isinstance(texts, str):
            return {"input_ids": self._encode(texts)}
        return {"input_ids": [self._encode(t) for t in texts]}


@pytest.fixture(scope="module")
def lm():
    """(cfg, JAX params, port params) of the tiny GPT-NeoX."""
    cfg = tiny_test_config("gptneox")
    jp = jneox.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, convert.params_from_numpy(jax.device_get(jp),
                                              device="cpu")


def _tied_pair(d, seed, n=N_FEATS, bias=-0.2):
    """A JAX and a port TiedSAE from the same numpy arrays; by default a
    negative bias, so a share of the codes is zero."""
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(n, d)).astype(np.float32)
    b = (rs.normal(size=n) * 0.3 + bias).astype(np.float32)
    return (JTiedSAE(dictionary=jnp.asarray(w), encoder_bias=jnp.asarray(b)),
            TiedSAE(dictionary=torch.from_numpy(w),
                    encoder_bias=torch.from_numpy(b)))


def _tokens(cfg, rows, seq, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(rows, seq)).astype(np.int32)


# -- intervention --------------------------------------------------------------

def test_lm_loss_and_perplexity_under_reconstruction(lm):
    cfg, jp, tp = lm
    toks = _tokens(cfg, 3, 12)
    jd, td = _tied_pair(cfg.d_model, 1)
    jlogits, _ = jneox.forward(jp, jnp.asarray(toks), cfg)
    tlogits, _ = tint._forward(cfg, None)(tp, torch.as_tensor(toks).long(),
                                          cfg)
    _close(tint.lm_loss(tlogits, torch.as_tensor(toks).long()),
           jint.lm_loss(jlogits, jnp.asarray(toks)), "lm_loss")
    _close(tint.perplexity_under_reconstruction(tp, cfg, td, LOC1, toks),
           jint.perplexity_under_reconstruction(jp, cfg, jd, LOC1,
                                                jnp.asarray(toks)),
           "perplexity_under_reconstruction")
    # the identity dict is a no-op: x @ I is exact
    base = tint.lm_loss(tlogits, torch.as_tensor(toks).long())
    ident = tint.perplexity_under_reconstruction(
        tp, cfg, Identity.create(cfg.d_model), LOC1, toks)
    assert float(ident) == float(base)


@pytest.mark.parametrize("rows,batch", [(2, 2), (3, 2)],
                         ids=["one_full_batch", "full_and_tail"])
def test_calculate_perplexity_matches_jax(lm, rows, batch):
    cfg, jp, tp = lm
    toks = _tokens(cfg, rows, 10, seed=rows)
    jd, td = _tied_pair(cfg.d_mlp, 2)
    jorig, jper = jint.calculate_perplexity(
        jp, cfg, [(jd, {}), (JIdentity.create(cfg.d_mlp), {})], 1, "mlp",
        toks, model_batch_size=batch)
    torig, tper = tint.calculate_perplexity(
        tp, cfg, [(td, {}), (Identity.create(cfg.d_mlp), {})], 1, "mlp",
        toks, model_batch_size=batch)
    _close(np.array([torig] + tper), np.array([jorig] + jper),
           "perplexities")
    assert tper[1] == torig  # identity: exactly the original


def test_cache_all_activations_matches_jax(lm):
    cfg, jp, tp = lm
    toks = _tokens(cfg, 2, 8, seed=3)
    (j1, t1), (j2, t2) = _tied_pair(cfg.d_model, 4), _tied_pair(
        cfg.d_model, 5)
    got = tint.cache_all_activations(tp, cfg, {LOC1: t1, LOC2: t2}, toks)
    ref = jint.cache_all_activations(jp, cfg, {LOC1: j1, LOC2: j2},
                                     jnp.asarray(toks))
    for loc in (LOC1, LOC2):
        _close(got[loc], ref[loc], f"codes at {loc}")


def _graph_close(got: dict, ref: dict, what: str):
    assert set(got) == set(ref), what
    keys = sorted(ref, key=repr)
    _close(np.array([got[k] for k in keys]), np.array([ref[k] for k in keys]),
           what, rtol=RTOL)
    assert max(ref.values()) > 0, what


def test_ablation_graphs_match_jax(lm):
    cfg, jp, tp = lm
    toks = _tokens(cfg, 2, 6, seed=6)
    # a positive bias: the ablated features fire, the targets move
    (j1, t1), (j2, t2) = _tied_pair(cfg.d_model, 7, bias=1.0), _tied_pair(
        cfg.d_model, 8, bias=1.0)
    jm, tm = {LOC1: j1, LOC2: j2}, {LOC1: t1, LOC2: t2}
    feats = {LOC1: [0, 3, 5, 11]}
    targets = {LOC2: list(range(8))}
    _graph_close(
        tint.build_ablation_graph_non_positional(tp, cfg, tm, toks, feats,
                                                 targets),
        jint.build_ablation_graph_non_positional(jp, cfg, jm,
                                                 jnp.asarray(toks), feats,
                                                 targets),
        "non-positional graph")
    pfeats = {LOC1: [(0, 1), (2, 3), (5, 0)]}
    ptargets = {LOC2: [(p, f) for p in (2, 5) for f in range(6)]}
    _graph_close(
        tint.build_ablation_graph(tp, cfg, tm, toks, pfeats, ptargets),
        jint.build_ablation_graph(jp, cfg, jm, jnp.asarray(toks), pfeats,
                                  ptargets),
        "positional graph")


def test_ablation_edits_match_jax():
    rs = np.random.default_rng(9)
    x = rs.normal(size=(2, 5, 16)).astype(np.float32)
    jd, td = _tied_pair(16, 10, n=24)
    mask = np.zeros(24, np.float32)
    mask[[2, 7]] = 1.0
    tx = torch.from_numpy(x)
    _close(tint.ablate_feature_set_edit(td, torch.from_numpy(mask))(tx),
           jint.ablate_feature_set_edit(jd, mask)(jnp.asarray(x)), "set edit")
    _close(tint.ablate_feature_edit(td, 7, position=3)(tx),
           jint.ablate_feature_edit(jd, 7, position=3)(jnp.asarray(x)),
           "positional edit")
    # a one-feature set is the single ablation, an int or a device index
    one = np.zeros(24, np.float32)
    one[7] = 1.0
    single = tint.ablate_feature_edit(td, 7)(tx)
    _close(tint.ablate_feature_set_edit(td, one)(tx), single, "one-hot set")
    _close(tint.ablate_feature_edit(td, torch.tensor(7))(tx), single,
           "tensor index")
    # the mask takes the codes' dtype: a bf16 stream stays bf16
    bf = tint.ablate_feature_set_edit(
        TiedSAE(dictionary=td.dictionary.bfloat16(),
                encoder_bias=td.encoder_bias.bfloat16()),
        torch.from_numpy(mask))(tx.bfloat16())
    assert bf.dtype == torch.bfloat16


# -- erasure -------------------------------------------------------------------

def _concept(n=64, d=12, seed=11):
    """Activations whose class mean differs along a few directions."""
    rs = np.random.default_rng(seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    x = rs.normal(size=(n, d)) + np.outer(labels, rs.normal(size=d)) * 0.8
    return x.astype(np.float32), labels


def test_leace_float64_solve_against_jax():
    x, z = _concept()
    got = erasure.LeaceEraser.fit(torch.from_numpy(x), torch.from_numpy(z))
    ref = jerasure.LeaceEraser.fit(jnp.asarray(x), jnp.asarray(z))
    _close(got.proj, ref.proj, "LEACE projection", rtol=LEACE_TOL)
    _close(got.mean, ref.mean, "LEACE mean")
    erased = got(torch.from_numpy(x))
    _close(erased, ref(jnp.asarray(x)), "erased", rtol=RTOL)
    ec = erased.double() - erased.double().mean(0)
    zc = torch.from_numpy(z).double() - 0.5
    assert float((ec.T @ zc).abs().max()) / len(z) < 1e-6


def test_concept_scores_population_std():
    """Held at RTOL against JAX's jnp.std (population); the unbiased std
    would put every score √(n/(n−1)) off, 3% at n = 16: outside RTOL."""
    x, z = _concept(n=16, d=8, seed=12)
    jd, td = _tied_pair(8, 13, n=24)
    got = erasure.concept_feature_scores(td, torch.from_numpy(x), z)
    ref = jerasure.concept_feature_scores(jd, jnp.asarray(x), z)
    _close(got, ref, "concept scores")
    c = td.encode(torch.from_numpy(x))
    zt = torch.from_numpy(z).float()
    zc = (zt - zt.mean()) / (torch.std(zt) + 1e-8)
    cc = (c - c.mean(0)) / (torch.std(c, dim=0) + 1e-8)
    unbiased = torch.abs(cc.T @ zc) / c.shape[0]
    err = float((unbiased - torch.from_numpy(np.array(ref))).abs().max())
    assert err > RTOL * float(np.abs(ref).max())


def test_erase_features_matches_jax():
    x, _ = _concept(seed=14)
    jd, td = _tied_pair(12, 15, n=20)
    idx = np.array([3, 0, 17])
    _close(erasure.erase_features(td, torch.from_numpy(x),
                                  torch.from_numpy(idx)),
           jerasure.erase_features(jd, jnp.asarray(x), jnp.asarray(idx)),
           "erased")


@pytest.mark.parametrize("with_lm", [False, True], ids=["probe", "lm_kl"])
def test_feature_erasure_curve_and_leace_match_jax(lm, with_lm):
    cfg, jp, tp = lm
    x, z = _concept(d=cfg.d_model, seed=16)
    jd, td = _tied_pair(cfg.d_model, 17, n=24)
    grid = (1, 2, 4)
    toks = _tokens(cfg, 2, 8, seed=18)
    t_eval = j_eval = None
    if with_lm:
        t_eval = {"params": tp, "lm_cfg": cfg, "tokens": toks,
                  "location": LOC1, "forward": None}
        j_eval = {**t_eval, "params": jp, "tokens": jnp.asarray(toks)}
    got = erasure.feature_erasure_curve(td, torch.from_numpy(x), z, grid,
                                        lm_eval=t_eval)
    ref = jerasure.feature_erasure_curve(jd, jnp.asarray(x), z, grid,
                                         lm_eval=j_eval)
    assert [r["n_erased"] for r in got] == [r["n_erased"] for r in ref]
    assert [sorted(r) for r in got] == [sorted(r) for r in ref]
    for g, r in zip(got, ref):
        assert abs(g["auroc"] - r["auroc"]) <= AUROC_TOL
        _close(np.array(g["edit_magnitude"]), r["edit_magnitude"], "edit")
        if with_lm:
            _close(np.array(g["kl"]), r["kl"], "kl")
    if with_lm:
        assert got[-1]["kl"] > 0
    lg = erasure.leace_baseline(torch.from_numpy(x), z)
    lr = jerasure.leace_baseline(jnp.asarray(x), z)
    assert abs(lg["auroc"] - lr["auroc"]) <= AUROC_TOL
    _close(np.array(lg["edit_magnitude"]), lr["edit_magnitude"],
           "leace edit", rtol=RTOL)


def test_run_erasure_writes_the_jax_json(lm, tmp_path):
    cfg, jp, tp = lm
    jd, _ = _tied_pair(cfg.d_model, 19, n=24)
    save_learned_dicts([(jd, {"l1_alpha": 1e-3, "note": "x"})],
                       tmp_path / "d.pkl")
    rs = np.random.default_rng(20)
    n = 32
    labels = (np.arange(n) % 2).astype(np.int32)
    probe = rs.integers(1, cfg.vocab_size, size=(n, 6)).astype(np.int32)
    probe[:, -1] = np.where(labels == 1, 5, 9)  # the concept's token
    kl_toks = _tokens(cfg, 2, 8, seed=21)
    recs = {}
    for side, args_cls, run, params in (
            ("jax", JErasureArgs, jdriver.run_erasure, jp),
            ("port", ErasureArgs, erasure_driver.run_erasure, tp)):
        c = args_cls(layers=[1], dict_path=str(tmp_path / "d.pkl"),
                     output_folder=str(tmp_path / side), max_edit_feats=4)
        run(c, params, cfg, probe, labels, kl_tokens=kl_toks)
        recs[side] = json.loads(
            (tmp_path / side / "erasure_scores_layer_1.json").read_text())
        assert (tmp_path / side / "erasure_layer_1.png").exists()
    got, ref = recs["port"], recs["jax"]
    assert got["layer"] == ref["layer"] == 1
    assert got["dicts"][0]["hyperparams"] == ref["dicts"][0]["hyperparams"]
    assert abs(got["leace"]["auroc"] - ref["leace"]["auroc"]) <= AUROC_TOL
    for g, r in zip(got["dicts"][0]["curve"], ref["dicts"][0]["curve"]):
        assert sorted(g) == sorted(r) and g["n_erased"] == r["n_erased"]
        assert abs(g["auroc"] - r["auroc"]) <= AUROC_TOL
        for k in ("edit_magnitude", "kl"):
            _close(np.array(g[k]), r[k], k)


def test_probe_activations_matches_jax(lm):
    cfg, jp, tp = lm
    toks = _tokens(cfg, 5, 7, seed=22)
    for t in (toks, toks[:, 0]):  # prompts, and bare token ids
        _close(erasure_driver.probe_activations(tp, cfg, t, 1, "mlp",
                                                model_batch_size=2),
               jdriver.probe_activations(jp, cfg, t, 1, "mlp",
                                         model_batch_size=2),
               f"probe activations {t.shape}")


def test_erasure_plots(tmp_path):
    curve = [{"n_erased": n, "edit_magnitude": 0.1 * n, "auroc": 1 - 0.05 * n}
             for n in (0, 1, 4)]
    plot_erasure_tradeoff(curve, leace={"edit_magnitude": 0.3, "auroc": 0.55},
                          save_path=tmp_path / "e.png")
    plot_task_ablation_curve({"metrics": np.array([1.0, 0.5]),
                              "base_metric": 1.2}, ranking=[3, 1],
                             save_path=tmp_path / "t.png")
    assert (tmp_path / "e.png").stat().st_size and \
        (tmp_path / "t.png").stat().st_size


# -- tasks ---------------------------------------------------------------------

def test_ioi_datasets_equal_jax():
    tok = StubTokenizer(50304)
    for got, ref in zip(tioi.generate_ioi_dataset(tok, 3, 2, seed=1),
                        jioi.generate_ioi_dataset(tok, 3, 2, seed=1)):
        np.testing.assert_array_equal(got, ref)
    for fam in ("mixed", "abc", "baba_long"):
        for got, ref in zip(
                tcf.gen_ioi_dataset_with_distractors(tok, 6, fam, seed=2),
                jcf.gen_ioi_dataset_with_distractors(tok, 6, fam, seed=2)):
            np.testing.assert_array_equal(got, ref)
    assert tcf.TEMPLATE_FAMILIES == jcf.TEMPLATE_FAMILIES


def test_gender_probe_arrays_equal_jax(tmp_path):
    tok = StubTokenizer(50304)
    csv = tmp_path / "names.csv"
    rows = ["name,gender,count,probability"] + [
        f"{n},{'F' if i % 3 else 'M'},{10 + i},0.{i}"
        for i, n in enumerate(["Ann", "Bob", "Cleo", "Dan", "Eve", "Finn",
                               "Gus", "Hana", "Ivy", "Mary Ann"])]
    csv.write_text("\n".join(rows) + "\n")
    got = tgender.preprocess_gender_dataset(csv, tok,
                                            out_path=tmp_path / "t.pkl")
    ref = jgender.preprocess_gender_dataset(csv, tok,
                                            out_path=tmp_path / "j.pkl")
    assert got == ref and len(got[1]) == 9  # "Mary Ann" is two tokens
    assert tgender.load_gender_dataset(tmp_path / "t.pkl") == ref
    for n in (None, 2):
        for a, b in zip(tgender.gender_probe_arrays(got[1], tok, n, seed=3),
                        jgender.gender_probe_arrays(ref[1], tok, n, seed=3)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ioi(lm):
    cfg, _, _ = lm
    tok = StubTokenizer(cfg.vocab_size)
    return tok, jcf.gen_ioi_dataset_with_distractors(tok, 6, "mixed", seed=4)


def test_identify_task_features_and_curve_match_jax(lm, ioi):
    cfg, jp, tp = lm
    _, (toks, _, lengths, tgt, dis) = ioi
    jd, td = _tied_pair(cfg.d_model, 23, n=16)
    got = tfi.identify_task_features(tp, cfg, td, 1, toks, lengths, tgt, dis,
                                     top_m=6)
    ref = jfi.identify_task_features(jp, cfg, jd, 1, toks, lengths, tgt, dis,
                                     top_m=6)
    _close(np.array(got["base_metric"]), ref["base_metric"], "base")
    _close(got["effects"], ref["effects"], "effects",
           rtol=RTOL * abs(ref["base_metric"]) / np.abs(ref["effects"]).max())
    assert got["ranking"] == ref["ranking"]
    sub = tfi.identify_task_features(tp, cfg, td, 1, toks, lengths, tgt, dis,
                                     feature_indices=[4, 1, 9], top_m=2)
    assert set(sub["ranking"]) <= {4, 1, 9} and len(sub["ranking"]) == 2
    gc = tfi.cumulative_ablation_curve(tp, cfg, td, 1, toks, lengths, tgt,
                                       dis, got["ranking"])
    rc = jfi.cumulative_ablation_curve(jp, cfg, jd, 1, toks, lengths, tgt,
                                       dis, ref["ranking"])
    _close(gc["metrics"], rc["metrics"], "curve")
    _close(gc["drops"], rc["drops"], "drops",
           rtol=RTOL * abs(rc["base_metric"]) / np.abs(rc["drops"]).max())


def test_run_ioi_feature_ident_matches_jax(lm, ioi):
    cfg, jp, tp = lm
    tok, _ = ioi
    jd, td = _tied_pair(cfg.d_model, 24, n=16)
    got = tfi.run_ioi_feature_ident(tp, cfg, td, 2, tok, n_prompts=4,
                                    curve=True, top_m=4)
    ref = jfi.run_ioi_feature_ident(jp, cfg, jd, 2, tok, n_prompts=4,
                                    curve=True, top_m=4)
    assert got["ranking"] == ref["ranking"]
    _close(got["ablation_curve"]["metrics"], ref["ablation_curve"]["metrics"],
           "curve")


# -- geometry ------------------------------------------------------------------

def test_clusterings_equal_jax():
    q, _ = np.linalg.qr(np.random.default_rng(25).normal(size=(24, 24)))
    q = q.astype(np.float32)
    got = geometry.cluster_vectors(Rotation(rotation=torch.from_numpy(q)),
                                   n_clusters=4, top_clusters=3)
    ref = jgeometry.cluster_vectors(JRotation(rotation=jnp.asarray(q)),
                                    n_clusters=4, top_clusters=3)
    assert got == ref
    np.testing.assert_array_equal(
        geometry.hierarchical_cluster_vectors(torch.from_numpy(q), 5),
        jgeometry.hierarchical_cluster_vectors(jnp.asarray(q), 5))


def test_activity_and_kurtosis_sweeps_match_jax(tmp_path):
    d, batch = 16, 100
    rs = np.random.default_rng(26)
    acts = np.abs(rs.normal(size=(650, d))).astype(np.float32)
    files = []
    for i in range(2):
        jd, _ = _tied_pair(d, 27 + i, n=24)
        files.append(tmp_path / f"d{i}.pkl")
        save_learned_dicts([(jd, {"l1_alpha": 1e-3 * (i + 1)}),
                            (jd, {"l1_alpha": 5.0})], files[-1])
    w = ChunkWriter(tmp_path / "store", d, chunk_size_gb=256 * d * 4 / 2**30,
                    dtype="float32")
    w.add(acts)
    w.finalize()
    for name, t_in, j_in in (
            ("array", acts, acts),
            ("store", ChunkStore(tmp_path / "store"),
             JChunkStore(tmp_path / "store"))):
        got = geometry.activity_sweep(files, t_in, threshold=10,
                                      batch_size=batch, device="cpu")
        ref = jgeometry.activity_sweep(files, j_in, threshold=10,
                                       batch_size=batch)
        assert got == ref, name
        got = geometry.kurtosis_sweep(files, t_in, batch_size=batch,
                                      device="cpu")
        ref = jgeometry.kurtosis_sweep(files, j_in, batch_size=batch)
        for g, r in zip(got, ref):
            assert g["l1_alpha"] == r["l1_alpha"]
            for k in ("mean_kurtosis", "median_kurtosis", "mean_skew"):
                np.testing.assert_allclose(g[k], r[k], rtol=1e-4,
                                           err_msg=f"{name} {k}")
