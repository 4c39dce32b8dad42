"""The port's auto-interpretation stage (sparse_coding_tpu_torch/interp/:
fragments.py, client.py, run.py, graph.py) against the JAX package's, on
the same tiny random-weight LM (the JAX ``init_params``, carried by
``lm.convert.params_from_numpy``), the same numpy dicts (saved by the
JAX package, loaded by the port) and the same token rows.

Tolerances:
- the per-fragment maxes, the per-token codes and the ablation graphs'
  edge weights within RTOL = 1e-5 of max|ref| (the LM forward's bound,
  tests/test_torch_port_lm.py; both sides fp32, sums in other orders);
- scores (correlations of simulated and true activations) within
  rtol 1e-5; explanations, prompts, feature choices, top-fragment
  orders and artifact layouts exactly;
- ``scan_batches``: bit-identical maxes for K=1, 3 and 5 (a tail
  included; the port keeps the field, which changes nothing there).
Masses are distinct on these inputs (asserted), so numpy's unstable
default sort picks the same features on both sides; the top-k tests plant
ties, which both sides order by index.
"""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.config import InterpArgs as JInterpArgs
from sparse_coding_tpu.config import InterpGraphArgs as JInterpGraphArgs
from sparse_coding_tpu.config import InvestigateArgs as JInvestigateArgs
from sparse_coding_tpu.interp import client as jclient
from sparse_coding_tpu.interp import fragments as jfrag
from sparse_coding_tpu.interp import graph as jgraph
from sparse_coding_tpu.interp import run as jrun
from sparse_coding_tpu.lm import gptneox as jneox
from sparse_coding_tpu.lm.model_config import tiny_test_config
from sparse_coding_tpu.models import TiedSAE as JTiedSAE
from sparse_coding_tpu.models import UntiedSAE as JUntiedSAE
from sparse_coding_tpu.utils.artifacts import save_learned_dicts
from sparse_coding_tpu_torch.config import (
    InterpArgs,
    InterpGraphArgs,
    InvestigateArgs,
)
from sparse_coding_tpu_torch.data.tokenize import save_token_dataset
from sparse_coding_tpu_torch.interp import client, fragments, graph
from sparse_coding_tpu_torch.interp import run as trun
from sparse_coding_tpu_torch.lm import convert
from sparse_coding_tpu_torch.lm import gptneox as tneox
from sparse_coding_tpu_torch.lm.model_config import (
    tiny_test_config as port_tiny_config,
)
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

RTOL = 1e-5  # of max|ref|
SCORE_RTOL = 1e-5
N_FEATS = 24


def _close(got, ref, what, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= rtol * max(float(np.abs(ref).max()), 1e-30), (what, err)


@pytest.fixture(scope="module")
def lm():
    """(cfg, JAX params, port params) of the tiny GPT-NeoX."""
    cfg = tiny_test_config("gptneox")
    jp = jneox.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, convert.params_from_numpy(jax.device_get(jp),
                                              device="cpu")


def _jax_dict(kind, d, seed, n=N_FEATS, bias=-0.1):
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(n, d)).astype(np.float32)
    b = (rs.normal(size=n) * 0.2 + bias).astype(np.float32)
    if kind == "tied":
        return JTiedSAE(dictionary=jnp.asarray(w), encoder_bias=jnp.asarray(b))
    return JUntiedSAE(encoder=jnp.asarray(w), encoder_bias=jnp.asarray(b),
                      dictionary=jnp.asarray(
                          rs.normal(size=(n, d)).astype(np.float32)))


def _save(path, dicts):
    """A JAX-written artifact; returns the port's load of it."""
    path.parent.mkdir(parents=True, exist_ok=True)
    save_learned_dicts([(ld, {"l1_alpha": 1e-3 * (i + 1)})
                        for i, ld in enumerate(dicts)], path)
    return [ld for ld, _ in load_learned_dicts(path)]


def _rows(cfg, n, seq, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, seq))


def _tok(t):
    return f"tok{t}"


def _same_records(got, ref):
    assert [r["feature"] for r in got] == [r["feature"] for r in ref]
    for g, r in zip(got, ref):
        assert g["explanation"] == r["explanation"], (g, r)
        for k in ("top_score", "random_score", "top_random_score",
                  "max_activation"):
            assert math.isclose(g[k], r[k], rel_tol=SCORE_RTOL,
                                abs_tol=1e-6), (k, g, r)


# -- fragments -----------------------------------------------------------------


def test_sample_fragments_match_jax():
    rows = np.random.default_rng(3).integers(0, 100, (40, 20))
    np.testing.assert_array_equal(
        fragments.sample_fragments(rows, 8, 25, seed=4),
        jfrag.sample_fragments(rows, 8, 25, seed=4))
    np.testing.assert_array_equal(  # fewer rows than asked
        fragments.sample_fragments(rows, 20, 99, seed=1),
        jfrag.sample_fragments(rows, 20, 99, seed=1))
    with pytest.raises(ValueError, match="fragment_len"):
        fragments.sample_fragments(rows, 21, 4)


@pytest.mark.parametrize("layer_loc", ["residual", "mlp"])
def test_fragment_maxes_and_lookup_match_jax(lm, layer_loc):
    """The maxes of every fragment (a tail batch included) and the
    lookup's per-token codes, for a tied and an untied dict."""
    cfg, jp, tp = lm
    d = cfg.d_mlp if layer_loc == "mlp" else cfg.d_model
    frags = _rows(cfg, 10, 12, seed=1)
    for kind, seed in (("tied", 2), ("untied", 3)):
        jd = _jax_dict(kind, d, seed)
        td = _port_dict(jd)
        jfa, jlook = jfrag.build_fragment_activations(
            jp, cfg, jd, frags, layer=1, layer_loc=layer_loc, batch_size=4,
            forward=jneox.forward)
        tfa, tlook = fragments.build_fragment_activations(
            tp, cfg, td, frags, layer=1, layer_loc=layer_loc, batch_size=4)
        _close(tfa.max_per_fragment, jfa.max_per_fragment,
               f"{layer_loc} {kind} maxes")
        assert tfa.n_feats == jfa.n_feats == N_FEATS
        np.testing.assert_array_equal(tfa.fragments.numpy(), frags)
        for fi, feat in ((0, 5), (9, 11)):
            _close(tlook.tokens_activations(fi, feat),
                   jlook.tokens_activations(fi, feat),
                   f"{layer_loc} {kind} lookup {fi}/{feat}")


def _port_dict(jax_dict):
    """The port's dict of the same class from the JAX dict's arrays."""
    from sparse_coding_tpu_torch.models import TiedSAE, UntiedSAE

    cls = {"TiedSAE": TiedSAE, "UntiedSAE": UntiedSAE}[type(jax_dict).__name__]
    return cls(**{k: torch.from_numpy(np.array(getattr(jax_dict, k)))
                  for k in ("encoder", "encoder_bias", "dictionary")
                  if hasattr(jax_dict, k)})


def test_scan_batches_bit_identical(lm):
    """10 fragments at batch 2 (JAX's K=3 would fuse one window of 6 and
    run a tail of 4 rows): K=3 and K=5 give K=1's maxes bit for bit, the
    field having no effect in the port."""
    cfg, _, tp = lm
    frags = _rows(cfg, 10, 12, seed=7)
    td = _port_dict(_jax_dict("tied", cfg.d_model, 8))
    maxes = [fragments.build_fragment_activations(
        tp, cfg, td, frags, layer=1, batch_size=2,
        scan_batches=k)[0].max_per_fragment for k in (1, 3, 5)]
    assert maxes[0].shape == (10, N_FEATS)
    assert torch.equal(maxes[0], maxes[1]) and torch.equal(maxes[0],
                                                           maxes[2])


def test_top_fragments_planted_tie_matches_lax_top_k():
    """Equal maxes (a planted tie and a tail of zeros) come back in index
    order, as jax.lax.top_k orders them."""
    maxes = np.zeros((12, 3), np.float32)
    maxes[[2, 5, 7, 9], 0] = [3.0, 1.5, 3.0, 1.5]
    maxes[:, 1] = 0.25  # a whole column tied
    maxes[[4, 1], 2] = [2.0, 2.0]
    frags = np.arange(12 * 4).reshape(12, 4)
    tfa = fragments.FragmentActivations(
        fragments=torch.from_numpy(frags), max_per_fragment=torch.from_numpy(
            maxes), n_feats=3)
    jfa = jfrag.FragmentActivations(fragments=jnp.asarray(frags),
                                    max_per_fragment=jnp.asarray(maxes),
                                    n_feats=3)
    for feat in range(3):
        for k in (3, 6, 20):
            ti, tv = tfa.top_fragments(feat, k)
            ji, jv = jfa.top_fragments(feat, k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tfa.top_fragments(0, 4)[0].tolist() == [2, 7, 5, 9]
    for seed in (0, 3):
        np.testing.assert_array_equal(tfa.random_fragments(5, seed).numpy(),
                                      np.asarray(jfa.random_fragments(5, seed)))


# -- the driver ----------------------------------------------------------------


def _cfgs(out_t, out_j, **kw):
    base = dict(layer=1, layer_loc="residual", n_feats_to_explain=3,
                fragment_len=8, n_fragments=24, top_k_fragments=4,
                n_random_fragments=3, batch_size=5, provider="offline")
    base.update(kw)
    return (InterpArgs(output_folder=str(out_t), **base),
            JInterpArgs(output_folder=str(out_j), **base))


def test_run_matches_jax_and_reruns_idempotent(lm, tmp_path):
    cfg, jp, tp = lm
    rows = _rows(cfg, 40, 16, seed=2)
    jd = _jax_dict("tied", cfg.d_model, 5)
    td = _save(tmp_path / "d.pkl", [jd])[0]
    tc, jc = _cfgs(tmp_path / "t", tmp_path / "j")
    fa, _ = jfrag.build_fragment_activations(
        jp, cfg, jd, jfrag.sample_fragments(rows, 8, 24), 1, batch_size=5,
        forward=jneox.forward)
    mass = np.sort(np.asarray(fa.max_per_fragment).sum(axis=0))[::-1]
    assert len(set(mass[:4].tolist())) == 4  # distinct masses: same picks
    ref = jrun.run(jd, jc, jp, cfg, rows, _tok, forward=jneox.forward)
    got = trun.run(td, tc, tp, cfg, rows, _tok)
    _same_records(got, ref)
    for rec in ref:
        f = f"feature_{rec['feature']}"
        assert (tmp_path / "t" / f / "explanation.txt").read_text() == \
            (tmp_path / "j" / f / "explanation.txt").read_text()
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    assert trun.read_scores(tmp_path / "t").keys() == \
        jrun.read_scores(tmp_path / "j").keys()
    before = {p: p.read_bytes() for p in (tmp_path / "t").rglob("scores.json")}
    mtimes = {p: p.stat().st_mtime_ns for p in before}
    again = trun.run(td, tc, tp, cfg, rows, _tok)
    assert again == got
    assert {p: p.read_bytes() for p in before} == before
    assert {p: p.stat().st_mtime_ns for p in before} == mtimes


def _write_tree(root, cfg):
    """One JAX-written tree: a sweep's `_0`/`_1` snapshots and a baselines
    folder with a layer-tagged subfolder."""
    for i in range(2):
        _save(root / "sweep" / f"_{i}" / "e_learned_dicts.pkl",
              [_jax_dict("tied", cfg.d_model, 20 + i),
               _jax_dict("untied", cfg.d_model, 30 + i)])
    _save(root / "base" / "l2_residual" / "ica.pkl",
          [_jax_dict("tied", cfg.d_model, 40)])
    _save(root / "base" / "pca.pkl", [_jax_dict("untied", cfg.d_model, 41)])


@pytest.mark.parametrize("driver", ["chunks", "big_sweep", "baselines"])
def test_batch_drivers_match_jax(lm, tmp_path, driver):
    cfg, jp, tp = lm
    _write_tree(tmp_path, cfg)
    rows = _rows(cfg, 30, 16, seed=3)
    tc, jc = _cfgs(tmp_path / "t", tmp_path / "j", n_feats_to_explain=2,
                   n_fragments=12, top_k_fragments=3, n_random_fragments=2)
    tfn, jfn, target = {
        "chunks": (trun.interpret_across_chunks, jrun.interpret_across_chunks,
                   "sweep"),
        "big_sweep": (trun.interpret_across_big_sweep,
                      jrun.interpret_across_big_sweep, "sweep"),
        "baselines": (trun.interpret_across_baselines,
                      jrun.interpret_across_baselines, "base")}[driver]
    ref = jfn(tmp_path / target, jc, jp, cfg, rows, _tok,
              forward=jneox.forward)
    got = tfn(tmp_path / target, tc, tp, cfg, rows, _tok)
    assert list(got) == list(ref)
    for key in ref:
        if driver == "chunks":
            assert list(got[key]) == list(ref[key])
            for member in ref[key]:
                _same_records(got[key][member], ref[key][member])
        else:
            _same_records(got[key], ref[key])
    tree = sorted(str(p.relative_to(tmp_path / "t"))
                  for p in (tmp_path / "t").rglob("*"))
    assert tree == sorted(str(p.relative_to(tmp_path / "j"))
                          for p in (tmp_path / "j").rglob("*"))
    if driver == "chunks":  # the same features of each member throughout
        for member in got["_0"]:
            assert [r["feature"] for r in got["_0"][member]] == \
                [r["feature"] for r in got["_1"][member]]
    if driver == "baselines":  # l2_residual/ica.pkl ran at layer 2
        assert "l2_residual_ica_0" in {p.name for p in
                                       (tmp_path / "t").iterdir()}
    tsc = trun.read_transform_scores(tmp_path / "t")
    jsc = jrun.read_transform_scores(tmp_path / "j")
    assert list(tsc) == list(jsc)
    for name in jsc:
        np.testing.assert_allclose(tsc[name], jsc[name], rtol=SCORE_RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("positional", [False, True])
def test_interp_graph_driver_matches_jax(lm, tmp_path, positional):
    cfg, jp, tp = lm
    paths = []
    for i in range(2):
        p = tmp_path / f"d{i}.pkl"
        _save(p, [_jax_dict("tied", cfg.d_model, 50 + i, n=8)])
        paths.append(str(p))
    rows = _rows(cfg, 12, 16, seed=4)
    kw = dict(layers=[0, 2], dict_paths=paths, n_fragments=6,
              fragment_len=8, positional=positional)
    if positional:
        ablate = {(0, "residual"): [(1, 0), (5, 3)]}
        targets = {(2, "residual"): [(2, 0), (7, 1), (6, 4)]}
    else:
        ablate, targets = {(0, "residual"): [0, 3]}, {(2, "residual"): [0, 1]}
    ref = jgraph.run_interp_graph(
        JInterpGraphArgs(output_folder=str(tmp_path / "j"), **kw), jp, cfg,
        rows, forward=jneox.forward, features_to_ablate=ablate,
        target_features=targets)
    got = graph.run_interp_graph(
        InterpGraphArgs(output_folder=str(tmp_path / "t"), **kw), tp, cfg,
        rows, features_to_ablate=ablate, target_features=targets)
    keys = sorted(ref, key=repr)
    assert sorted(got, key=repr) == keys and len(keys) > 0
    _close([got[k] for k in keys], [ref[k] for k in keys], "graph weights")
    tj = json.loads((tmp_path / "t" / "ablation_graph.json").read_text())
    jj = json.loads((tmp_path / "j" / "ablation_graph.json").read_text())
    assert list(tj) == list(jj)
    with pytest.raises(ValueError, match="one dict per layer"):
        graph.run_interp_graph(InterpGraphArgs(layers=[0], dict_paths=paths),
                               tp, cfg, rows)


def test_investigate_features_matches_jax(lm, tmp_path):
    cfg, jp, tp = lm
    p = tmp_path / "d.pkl"
    _save(p, [_jax_dict("tied", cfg.d_model, 60, n=12)])
    rows = _rows(cfg, 24, 16, seed=5)
    kw = dict(layer=1, learned_dict_path=str(p), feature_indices=[2, 9, 5],
              n_fragments=16, fragment_len=8)
    ref = jgraph.investigate_features(
        JInvestigateArgs(output_folder=str(tmp_path / "j"), **kw), jp, cfg,
        rows, decode_token=_tok, forward=jneox.forward)
    got = graph.investigate_features(
        InvestigateArgs(output_folder=str(tmp_path / "t"), **kw), tp, cfg,
        rows, decode_token=_tok)
    assert [r["feature"] for r in got] == [2, 9, 5]
    _same_records(got, ref)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["feature_2", "feature_5", "feature_9", "summary.json"]


# -- the clients -----------------------------------------------------------------


def test_offline_explainer_and_correlation_match_jax():
    records = [[",", "'", "cat", "sat"], ["a", "cat", "ran", "'"]]
    acts = [[5.0, 4.0, 0.0, 0.5], [0.0, 4.0, 0.25, 3.0]]
    for n in (1, 2, 5):
        t = client.OfflineExplainer(top_n_tokens=n)
        j = jclient.OfflineExplainer(top_n_tokens=n)
        tr = [client.ActivationRecord(tokens=a, activations=b)
              for a, b in zip(records, acts)]
        jr = [jclient.ActivationRecord(tokens=a, activations=b)
              for a, b in zip(records, acts)]
        assert t.explain(tr) == j.explain(jr)
        assert t.simulate(t.explain(tr), records[1]) == \
            j.simulate(j.explain(jr), records[1])
    for a, b in (([1, 2, 3], [2, 4, 6]), ([1, 2, 3], [3, 2, 1]),
                 ([1, 1, 1], [1, 2, 3]), ([0.5, 0, 2, 1], [1, 0, 1, 1])):
        assert trun.correlation_score(np.array(a), np.array(b)) == \
            jrun.correlation_score(np.array(a), np.array(b))
    with pytest.raises(ValueError, match="provider"):
        client.get_explainer("bogus")


def _fake_openai(captured):
    class Chat:
        def create(self, **kw):
            captured["chat"] = kw
            msg = types.SimpleNamespace(content=" nouns about food")
            return types.SimpleNamespace(
                choices=[types.SimpleNamespace(message=msg)])

    class Completions:
        def create(self, **kw):
            captured["comp"] = kw
            lp = types.SimpleNamespace(
                tokens=["2024", "\t", "7", "\n", "cat", "\t0", "\n"],
                top_logprobs=[{"2024": 0.0}, {"\t": 0.0},
                              {"7": math.log(0.5), "5": math.log(0.5),
                               "x": math.log(0.1)},
                              {"\n": 0.0}, {"cat": 0.0},
                              {"\t0": 0.0}, {"\n": 0.0}])
            return types.SimpleNamespace(
                choices=[types.SimpleNamespace(logprobs=lp)])

    return types.SimpleNamespace(
        chat=types.SimpleNamespace(completions=Chat()),
        completions=Completions())


def test_openai_protocol_matches_jax(monkeypatch):
    """The neuron-explainer protocol with the JAX test's fake client: the
    prompts, the calls' arguments and the expected values equal JAX's."""
    seen_t, seen_j = {}, {}
    t = client.OpenAIExplainer(_client=_fake_openai(seen_t))
    j = jclient.OpenAIExplainer(_client=_fake_openai(seen_j))
    recs = [(["the", "cat", "sat"], [0.0, 4.0, 1.3]), (["a", "dog"],
                                                       [2.2, 0.0])]
    tr = [client.ActivationRecord(tokens=a, activations=b) for a, b in recs]
    jr = [jclient.ActivationRecord(tokens=a, activations=b) for a, b in recs]
    assert t.explainer_messages(tr) == j.explainer_messages(jr)
    assert t.explain(tr) == j.explain(jr) == "nouns about food"
    assert seen_t["chat"] == seen_j["chat"]
    assert t.simulator_prompt("x", ["2024", "cat"]) == \
        j.simulator_prompt("x", ["2024", "cat"])
    assert t.simulate("nouns", ["2024", "cat"]) == \
        j.simulate("nouns", ["2024", "cat"]) == [6.0, 0.0]
    assert seen_t["comp"] == seen_j["comp"]
    for toks, lps, n in (
            (["cat\t1", "0", "\n", "dog\t2", "\n"],
             [{"cat\t1": 0.0}, {"0": 0.0}, {"\n": 0.0}, {"dog\t2": 0.0},
              {"\n": 0.0}], 2),
            (["7", "\t", "3", "\n", "tok", "\t", "oops\n", "x"],
             [{"7": 0.0}, {"\t": 0.0}, {"3": 0.0}, {"\n": 0.0},
              {"tok": 0.0}, {"\t": 0.0}, {"oops\n": 0.0}, {"x": 0.0}], 3),
            (["cat\t1", "\n0", "war", "\t", "3", "\n"],
             [{"1": 0.0}, {}, {}, {}, {"3": 0.0}, {}], 2),
            (["cat\t1", "\n", "dog\t2"], [{"1": 0.0}, {}], 2)):
        assert client.expected_values_from_logprobs(toks, lps, n) == \
            jclient.expected_values_from_logprobs(toks, lps, n)
    for acts, top in (([0.0, 2.5, 5.0], 5.0), ([1.0, -3.0], 0.0)):
        assert client.normalize_activations(acts, top) == \
            jclient.normalize_activations(acts, top)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(ValueError, match="OPENAI_API_KEY"):
        client.OpenAIExplainer()


# -- the CLI -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    """Tokens, one artifact, a sweep tree and a baselines tree at the tiny
    LM's width."""
    root = tmp_path_factory.mktemp("interp_cli")
    cfg = tiny_test_config("gptneox")
    save_token_dataset(_rows(cfg, 12, 16).astype(np.int32),
                       root / "toks.npy", {})
    _save(root / "dict.pkl", [_jax_dict("tied", cfg.d_model, 70, n=12)])
    _write_tree(root, cfg)
    return root


CLI_COMMON = ["--model_name", "tiny-gptneox", "--layer", "1",
              "--n_feats_to_explain", "2", "--fragment_len", "8",
              "--n_fragments", "6", "--top_k_fragments", "2",
              "--n_random_fragments", "2", "--batch_size", "4"]


@pytest.mark.parametrize("sub", ["interpret", "run_group", "big_sweep",
                                 "all_baselines", "chunks"])
def test_cli_subcommands_on_cpu(cli_tree, tmp_path, capsys, sub):
    out = tmp_path / "out"
    args = ["--tokens", str(cli_tree / "toks.npy"), "--device", "cpu",
            "--output_folder", str(out), *CLI_COMMON]
    target = {"run_group": cli_tree / "sweep", "big_sweep": cli_tree / "sweep",
              "all_baselines": cli_tree / "base",
              "chunks": cli_tree / "sweep"}.get(sub)
    if sub == "interpret":
        args = ["--learned_dict_path", str(cli_tree / "dict.pkl"), *args]
    else:
        args = [sub, "--target", str(target), *args]
    trun.main(args)
    n_dicts = {"interpret": 1, "run_group": 4, "big_sweep": 2,
               "all_baselines": 2, "chunks": 2}[sub]
    assert f"interp {sub}: {n_dicts} dict(s)" in capsys.readouterr().out
    member = {"interpret": out / "dict_0",
              "run_group": out / "e_learned_dicts_1",
              "big_sweep": out / "e_learned_dicts_0",
              "all_baselines": out / "l2_residual_ica_0",
              "chunks": out / "_1" / "e_learned_dicts_0"}[sub]
    scores = trun.read_scores(member)
    # run_group names outputs by artifact stem, as the JAX package does:
    # _0's and _1's e_learned_dicts.pkl share a folder
    assert len(scores) == (4 if sub == "run_group" else 2)
    assert all("explanation" in r for r in scores.values())


def test_cli_read_results_prints_scores(cli_tree, tmp_path, capsys):
    out = tmp_path / "out"
    trun.main(["--learned_dict_path", str(cli_tree / "dict.pkl"),
               "--tokens", str(cli_tree / "toks.npy"), "--device", "cpu",
               "--output_folder", str(out), *CLI_COMMON])
    capsys.readouterr()
    trun.main(["read_results", "--output_folder", str(out / "dict_0")])
    printed = json.loads(capsys.readouterr().out)
    assert {int(k): v for k, v in printed.items()} == \
        trun.read_scores(out / "dict_0")


@pytest.mark.parametrize("argv,match", [
    (["bogus_subcommand"], "unknown subcommand"),
    (["--learned_dict_path", "d.pkl"], "--tokens"),
    (["chunks", "--tokens", "t.npy"], "--target"),
    (["--tokens", "t.npy"], "--learned_dict_path"),
])
def test_cli_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        trun.main(argv)


def test_cli_defaults_to_the_card(cli_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--learned_dict_path", str(cli_tree / "dict.pkl"),
                   "--tokens", str(cli_tree / "toks.npy"),
                   "--output_folder", str(tmp_path), *CLI_COMMON])


def test_tiny_lm_seeds_a_torch_generator():
    """`_load_lm`'s tiny models come from a torch generator seeded with 0
    (jax.random.PRNGKey(0)'s stream cannot be reproduced): the same
    weights each call, the JAX tiny config."""
    p1, cfg, decode, fwd = trun._load_lm("tiny-gptneox", device="cpu")
    p2, _, _, _ = trun._load_lm("tiny-gptneox", device="cpu")
    ref = tneox.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert cfg == port_tiny_config("gptneox") and decode(7) == "7"
    assert fwd is tneox.forward
    for a, b, c in zip(convert_leaves(p1), convert_leaves(p2),
                       convert_leaves(ref)):
        assert torch.equal(a, b) and torch.equal(a, c)


def convert_leaves(params):
    from sparse_coding_tpu_torch.utils.tree import flatten_tree

    return list(flatten_tree(params).values())
