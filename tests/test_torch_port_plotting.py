"""The port's plotting modules (sparse_coding_tpu_torch/plotting/
helpers.py, frontiers.py, sweeps.py, autointerp.py, timeseries.py)
against the JAX package's: the data functions on the same numpy inputs
and JAX-written artifacts (FVU and L0 within 1e-5 of max|ref|, counts
and pivots exactly, score summaries within 1e-12), every plot writing a
PNG where matplotlib is installed, the images of the helpers that draw
the same numbers equal to the JAX package's pixel for pixel, and every
plotting module importing, and its data functions running, where
matplotlib is blocked."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.models.sae import FunctionalTiedSAE
from sparse_coding_tpu.plotting import autointerp as jauto
from sparse_coding_tpu.plotting import frontiers as jfront
from sparse_coding_tpu.plotting import helpers as jhelp
from sparse_coding_tpu.plotting import sweeps as jsweeps
from sparse_coding_tpu.plotting import timeseries as jtime
from sparse_coding_tpu.utils.artifacts import save_learned_dicts
from sparse_coding_tpu_torch.plotting import autointerp, frontiers, helpers
from sparse_coding_tpu_torch.plotting import sweeps, timeseries
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5
D = 16


def _write_dicts(path, seed, n=32, l1s=(1e-4, 1e-3), shift=0.0):
    members = []
    for i, l1 in enumerate(l1s):
        p, b = FunctionalTiedSAE.init(jax.random.PRNGKey(seed + i), D, n,
                                      l1_alpha=l1)
        p = dict(p, encoder_bias=p["encoder_bias"] - shift)
        members.append((FunctionalTiedSAE.to_learned_dict(p, b),
                        {"l1_alpha": l1, "dict_size": n}))
    path.parent.mkdir(parents=True, exist_ok=True)
    save_learned_dicts(members, path)
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_plotting")
    files = [_write_dicts(root / "a.pkl", 0),
             _write_dicts(root / "b.pkl", 5, n=48, l1s=(3e-4,))]
    batch = np.random.default_rng(1).normal(size=(256, D)).astype(np.float32)
    for i, shift in enumerate((0.0, 1.0, 2.0)):
        _write_dicts(root / "sweep" / f"_{i}" / "e_learned_dicts.pkl",
                     10 * i, n=24, shift=shift)
    for snap in ("_0", "_3"):  # an interpret_across_chunks tree
        for m, base in (("e_0", 0.1), ("e_1", 0.3)):
            for f in range(3):
                d = root / "interp" / snap / m / f"feature_{f}"
                d.mkdir(parents=True)
                (d / "scores.json").write_text(json.dumps(
                    {"feature": f, "top_random_score": base + 0.05 * f
                     + (0.1 if snap == "_3" else 0.0)}))
    for name, score in (("sae", [0.5, 0.4, 0.45]), ("pca", [0.2, 0.1])):
        for f, s in enumerate(score):
            d = root / "transforms" / name / f"feature_{f}"
            d.mkdir(parents=True)
            (d / "scores.json").write_text(json.dumps(
                {"feature": f, "top_random_score": s}))
    return root, files, batch


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= RTOL * max(np.abs(ref).max(), 1e-30), \
        what


# -- data functions against the JAX package -------------------------------------


def test_generate_scores_matches_jax(data, tmp_path):
    root, files, batch = data
    got = frontiers.generate_scores(files, batch, out_path=tmp_path / "s.json",
                                    device="cpu")
    ref = jfront.generate_scores(files, jnp.asarray(batch))
    assert [{k: v for k, v in s.items() if k not in ("fvu", "l0")}
            for s in got] == [{k: v for k, v in s.items()
                               if k not in ("fvu", "l0")} for s in ref]
    _close([[s["fvu"], s["l0"]] for s in got],
           [[s["fvu"], s["l0"]] for s in ref], "fvu, l0")
    assert json.loads((tmp_path / "s.json").read_text()) == got
    assert list(got[0]) == list(ref[0])


def test_n_active_features_and_sweep_grid_match_jax(data):
    root, files, batch = data
    for threshold in (0.0, 0.05):
        got = sweeps.n_active_features(files, batch, threshold=threshold,
                                       device="cpu")
        ref = jsweeps.n_active_features(files, jnp.asarray(batch),
                                        threshold=threshold)
        assert got == ref and list(got[0]) == list(ref[0])
    scores = frontiers.generate_scores(files, batch, device="cpu")
    for value_key in ("fvu", "l0"):
        gx, gy, gg = sweeps.sweep_grid(scores, value_key=value_key)
        jx, jy, jg = jsweeps.sweep_grid(scores, value_key=value_key)
        assert (gx, gy) == (jx, jy)
        np.testing.assert_array_equal(gg, jg)
    gx, gy, gg = sweeps.plot_sweep_grid(scores)  # no path: nothing drawn
    assert gy == [32, 48] and np.isnan(gg).sum() == 3


def test_timeseries_data_match_jax(data):
    root, _, batch = data
    got = timeseries.plot_n_active_over_time(root / "sweep", batch,
                                             threshold=5, batch_size=64,
                                             device="cpu")
    ref = jtime.plot_n_active_over_time(root / "sweep", batch, threshold=5,
                                        batch_size=64)
    assert got == ref and len(got) == 2
    for s in got.values():
        assert s["snapshots"] == [0, 1, 2]
        assert s["n_active"][0] >= s["n_active"][-1]
    got = timeseries.plot_autointerp_across_chunks(root / "interp")
    ref = jtime.plot_autointerp_across_chunks(root / "interp")
    assert list(got) == list(ref) == ["e_0", "e_1"]
    for k in ref:
        assert got[k]["snapshots"] == ref[k]["snapshots"] == [0, 3]
        np.testing.assert_allclose(got[k]["mean"], ref[k]["mean"], rtol=1e-12)
        np.testing.assert_allclose(got[k]["ci95"], ref[k]["ci95"], rtol=1e-12)


def test_autointerp_summaries_match_jax(data, tmp_path):
    root, _, _ = data
    scores = {"sae": [0.5, 0.4, 0.45], "pca": [0.2, 0.1], "ica": [0.3]}
    got = autointerp.plot_score_violins(scores)
    ref = jauto.plot_score_violins(scores, save_path=tmp_path / "v.png")
    assert got == pytest.approx(ref, rel=1e-12)
    got = autointerp.plot_autointerp_vs_baselines(root / "transforms")
    ref = jauto.plot_autointerp_vs_baselines(root / "transforms",
                                             save_path=tmp_path / "b.png")
    assert got == pytest.approx(ref, rel=1e-12) and list(got) == ["pca",
                                                                  "sae"]
    assert autointerp.SCORE_RANGE == jauto.SCORE_RANGE
    assert autointerp.MEAN_SCORE_CAP == jauto.MEAN_SCORE_CAP


# -- every plot writes a PNG ----------------------------------------------------------


def _dicts(files):
    return [pair for f in files for pair in load_learned_dicts(f)]


PLOTS = {
    "plot_hist": lambda r, f, b, p: helpers.plot_hist(
        torch.from_numpy(b[:, 0]), save_path=p),
    "plot_scatter": lambda r, f, b, p: helpers.plot_scatter(
        b[:, 0], torch.from_numpy(b[:, 1]), "x", "y", save_path=p),
    "plot_grid": lambda r, f, b, p: helpers.plot_grid(
        b[:4, :3], ["a", "b", "c"], [1, 2, 3, 4], "x", "y", save_path=p),
    "plot_capacities": lambda r, f, b, p: helpers.plot_capacities(
        _dicts(f), save_path=p),
    "plot_capacity_scatter": lambda r, f, b, p: helpers.plot_capacity_scatter(
        _dicts(f), b, save_path=p),
    "plot_kl_div": lambda r, f, b, p: helpers.plot_kl_div(
        [{"l0": 3.0, "kl": 0.2}, {"l0": 1.0, "kl": 0.5}], save_path=p),
    "bottleneck_plot": lambda r, f, b, p: helpers.bottleneck_plot(
        {"sae": [(8, 0.3), (2, 0.6)], "pca": [(8, 0.5)]}, save_path=p),
    "plot_fvu_sparsity": lambda r, f, b, p: frontiers.plot_fvu_sparsity(
        frontiers.generate_scores(f, b, device="cpu"), save_path=p),
    "plot_sweep_grid": lambda r, f, b, p: sweeps.plot_sweep_grid(
        frontiers.generate_scores(f, b, device="cpu"), save_path=p),
    "plot_n_active": lambda r, f, b, p: sweeps.plot_n_active(
        sweeps.n_active_features(f, b, device="cpu"), save_path=p),
    "plot_num_dead": lambda r, f, b, p: sweeps.plot_num_dead(
        sweeps.n_active_features(f, b, device="cpu"), save_path=p),
    "plot_score_violins": lambda r, f, b, p: autointerp.plot_score_violins(
        {"sae": [0.5, 0.4], "pca": [0.1, 0.2, 0.3]}, save_path=p),
    "plot_autointerp_vs_baselines":
        lambda r, f, b, p: autointerp.plot_autointerp_vs_baselines(
            r / "transforms", save_path=p),
    "plot_autointerp_across_chunks":
        lambda r, f, b, p: timeseries.plot_autointerp_across_chunks(
            r / "interp", save_path=p),
    "plot_n_active_over_time":
        lambda r, f, b, p: timeseries.plot_n_active_over_time(
            r / "sweep", b, threshold=5, batch_size=64, save_path=p,
            device="cpu"),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_each_plot_writes_a_png(data, tmp_path, name):
    pytest.importorskip("matplotlib")
    root, files, batch = data
    path = tmp_path / "sub" / f"{name}.png"
    if name in ("plot_hist", "plot_scatter", "plot_grid", "plot_capacities",
                "plot_capacity_scatter", "plot_kl_div", "bottleneck_plot"):
        path.parent.mkdir(parents=True)  # the image helpers write in place
    PLOTS[name](root, files, batch, path)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_helper_images_equal_jax(data):
    """The helpers that draw the same numbers render the JAX package's
    pixels."""
    pytest.importorskip("matplotlib")
    _, _, b = data
    pairs = [
        (helpers.plot_scatter(b[:, 0], b[:, 1], "x", "y"),
         jhelp.plot_scatter(b[:, 0], b[:, 1], "x", "y")),
        (helpers.plot_grid(b[:4, :3], ["a", "b", "c"], [1, 2, 3, 4], "x",
                           "y"),
         jhelp.plot_grid(b[:4, :3], ["a", "b", "c"], [1, 2, 3, 4], "x", "y")),
        (helpers.plot_kl_div([{"l0": 3.0, "kl": 0.2}, {"l0": 1.0, "kl": 0.5}]),
         jhelp.plot_kl_div([{"l0": 3.0, "kl": 0.2}, {"l0": 1.0, "kl": 0.5}])),
        (helpers.bottleneck_plot({"sae": [(8, 0.3), (2, 0.6)]}),
         jhelp.bottleneck_plot({"sae": [(8, 0.3), (2, 0.6)]})),
        (helpers.plot_hist(b[:, 0]), jhelp.plot_hist(b[:, 0])),
    ]
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


# -- without matplotlib ----------------------------------------------------------------

_BLOCKED = r"""
import importlib, importlib.abc, json, sys
import numpy as np


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("matplotlib", "jax", "sparse_coding_tpu"):
            # what a host without the package raises
            raise ModuleNotFoundError(f"blocked import of {name}", name=name)
        return None


sys.meta_path.insert(0, Block())
from sparse_coding_tpu_torch.plotting import (autointerp, erasure, frontiers,
                                              helpers, sweeps, timeseries)

root, files = sys.argv[1], json.loads(sys.argv[2])
batch = np.random.default_rng(1).normal(size=(256, 16)).astype(np.float32)
scores = frontiers.generate_scores(files, batch, device="cpu")
sweeps.sweep_grid(scores)
sweeps.plot_sweep_grid(scores)
recs = sweeps.n_active_features(files, batch, device="cpu")
sweeps.plot_n_active(recs)
sweeps.plot_num_dead(recs)
autointerp.plot_score_violins({"a": [0.1, 0.2]})
autointerp.plot_autointerp_vs_baselines(root + "/transforms")
timeseries.plot_autointerp_across_chunks(root + "/interp")
timeseries.plot_n_active_over_time(root + "/sweep", batch, threshold=5,
                                   batch_size=64, device="cpu")
try:
    sweeps.plot_n_active(recs, save_path=root + "/never.png")
except ModuleNotFoundError as e:
    print("draw:", e)
assert not any(m.split(".")[0] == "matplotlib" for m in sys.modules)
print("ok", len(scores), len(recs))
"""


def test_plotting_imports_and_computes_without_matplotlib(data):
    from conftest import stripped_cpu_subprocess_env

    root, files, _ = data
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(root),
         json.dumps([str(f) for f in files])],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=stripped_cpu_subprocess_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert "draw: blocked import of matplotlib" in out.stdout
    assert "ok 3 3" in out.stdout
