"""The sweep's seven group experiments (``topk``, ``residual_denoising``,
``centered_l1_range``, ``reverse_l1_range``, ``positive_l1_range``,
``semilinear_l1_range``, ``rica``) in the port's sweep against the JAX
package's, and a kill and resume of a group entry.

Both sides get one store written by numpy from a seed (the full sweep
test's ``write_store``), the JAX experiment's init members carried into
the port (``inits=``, flattened in bucket order: re-bucketing by first
appearance gives the same buckets), and the same chunk order and batches
from ``np.random.default_rng(cfg.seed)``. ``centered_l1_range`` gets one
JAX-fitted ``centering=`` on both sides: the whitening scale
1/√max(λ, 1e-6) amplifies the eigensolvers' rounding. The JAX side trains
on autodiff (none of these families has a kernel there); the port does
too.

Tolerances are the full sweep's (``test_torch_port_full_sweep.py``): the
final dicts within rtol 2e-4 (atol 1e-6 on elements), eval.json's fvu and
l0 within rtol 2e-4; bucket names, hyperparameters and their order, and
the checkpoint file stems equal. The LISTA encoder's layers (the
``residual_denoising`` experiment) are held at atol 2e-4 of the field's
largest element instead of 1e-6: after its 4 Adam steps a few small
elements of W sit 2.7e-5 apart (9e-5 of max|W|, 2.6e-3 of themselves) —
Adam's first steps move an element whose gradient lies near rounding of 0
by a share of lr at once, and the two-layer unrolled encoder's gradients
carry more rounding than one product does.
"""

import json
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding_tpu.config import EnsembleArgs as JaxArgs
from sparse_coding_tpu.train import experiments as jexp
from sparse_coding_tpu.train import sweep as jsweep
from sparse_coding_tpu_torch.config import EnsembleArgs
from sparse_coding_tpu_torch.ensemble import EnsembleGroup
from sparse_coding_tpu_torch.resilience import crash
from sparse_coding_tpu_torch.train import experiments as texp
from sparse_coding_tpu_torch.train import sweep as tsweep
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts
from test_torch_port_full_sweep import write_store

REPO = Path(__file__).resolve().parents[1]
D, RATIO, BATCH, N_CHUNKS, ROWS = 24, 2.0, 128, 2, 256
DICT_TOL = dict(rtol=2e-4, atol=1e-6)
EVAL_RTOL = 2e-4
GROUP_EXPERIMENTS = ["topk", "residual_denoising", "centered_l1_range",
                     "reverse_l1_range", "positive_l1_range",
                     "semilinear_l1_range", "rica"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("group_sweep") / "store",
                       n_chunks=N_CHUNKS, rows=ROWS, d=D)


def _centering(store):
    from sparse_coding_tpu.data.chunk_store import ChunkStore
    from sparse_coding_tpu.models.pca import BatchedPCA

    pca = BatchedPCA(D)
    pca.train_batch(ChunkStore(store).load_chunk(0))
    mean, rot, inv_std = pca.get_centering_transform()
    return tuple(np.asarray(v) for v in (mean, rot.T, inv_std))


def _kwargs(experiment, store):
    if experiment == "topk":
        # a repeated k shares a bucket: buckets topk_k4 (2), topk_k8 (1)
        return dict(ks=(4, 8, 4), activation_dim=D)
    if experiment == "rica":
        return dict(sparsity_range=[1e-3, 1e-2], activation_dim=D)
    kw = dict(l1_range=[1e-3, 1e-2], activation_dim=D)
    if experiment == "centered_l1_range":
        kw["centering"] = _centering(store)
    return kw


def _members(entry):
    """An entry's init members, a group's in bucket order."""
    buckets = (entry.ensembles.values() if hasattr(entry, "ensembles")
               else [entry])
    return [m for ens in buckets for m in ens.unstack()]


def _build_fns(experiment, store, jcfg):
    kw = _kwargs(experiment, store)
    jfn, tfn = jexp.EXPERIMENTS[experiment], texp.EXPERIMENTS[experiment]
    jbuild = lambda c, m: jfn(c, m, **kw)
    inits = {name: _members(e) for e, _, name in jbuild(jcfg, None)}
    built = []

    def tbuild(c, m, device=None):
        entries = tfn(c, m, inits=inits, device=device, **kw)
        built.extend(entries)
        return entries

    return jbuild, tbuild, built


def _configs(store, out):
    base = dict(dataset_folder=str(store), batch_size=BATCH, lr=1e-3,
                learned_dict_ratio=RATIO, n_chunks=N_CHUNKS, seed=0)
    return (JaxArgs(output_folder=str(out / "jax"), use_fused="off", **base),
            EnsembleArgs(output_folder=str(out / "torch"), **base))


def _tensor_fields(ld):
    """(name, numpy) for every tensor field, a dict field's entries
    under ``field.key``."""
    import dataclasses

    for f in dataclasses.fields(ld):
        v = getattr(ld, f.name)
        items = v.items() if isinstance(v, dict) else [("", v)]
        for k, x in items:
            if x is not None and not isinstance(x, (int, float, str)):
                yield (f"{f.name}.{k}" if k else f.name), np.asarray(x)


@pytest.mark.parametrize("experiment", GROUP_EXPERIMENTS)
def test_group_sweep_matches_jax(store, tmp_path, experiment):
    jcfg, tcfg = _configs(store, tmp_path)
    jbuild, tbuild, built = _build_fns(experiment, store, jcfg)
    jres = jsweep.sweep(jbuild, jcfg, log_every=1, image_metrics_every=None)
    tres = tsweep.sweep(tbuild, tcfg, log_every=1, image_metrics_every=None,
                        device="cpu")
    jentries = jbuild(jcfg, None)
    # entries, bucket names and their order
    assert list(tres) == list(jres)
    for (je, _, _), (te, _, _) in zip(jentries, built):
        assert isinstance(te, EnsembleGroup) == hasattr(je, "ensembles")
        if hasattr(je, "ensembles"):
            assert list(te.ensembles) == list(je.ensembles)
            assert [e.n_members for e in te.ensembles.values()] == \
                [e.n_members for e in je.ensembles.values()]
    # the final dicts, field by field, and their hyperparameters in order
    for name in jres:
        assert [h for _, h in tres[name]] == [h for _, h in jres[name]]
        for i, ((jd, _), (td, _)) in enumerate(zip(jres[name],
                                                   tres[name])):
            assert type(td).__name__ == type(jd).__name__
            jf, tf = dict(_tensor_fields(jd)), dict(_tensor_fields(td))
            assert list(tf) == list(jf)
            for field in jf:
                tol = (dict(rtol=2e-4, atol=2e-4 * np.abs(jf[field]).max())
                       if field.startswith("encoder_layers") else DICT_TOL)
                np.testing.assert_allclose(tf[field], jf[field], **tol,
                                           err_msg=f"{name}[{i}].{field}")
    # checkpoint files: one a bucket, {name}_{j}, the same stems
    stem = lambda p: p.name.split(".")[0]
    jck = sorted({stem(p) for p in (tmp_path / "jax/ckpt").iterdir()})
    tck = sorted({stem(p) for p in (tmp_path / "torch/ckpt").iterdir()})
    assert tck == jck and len(tck) == sum(
        len(getattr(e, "ensembles", [e])) for e, _, _ in jentries)
    # eval.json and the artifact's hyperparameters
    sub = f"_{N_CHUNKS - 1}"
    for path in sorted((tmp_path / "jax" / sub).glob("*_eval.json")):
        je = json.loads(path.read_text())
        te = json.loads((tmp_path / "torch" / sub / path.name).read_text())
        assert len(te) == len(je)
        for j, t in zip(je, te):
            assert {k: v for k, v in t.items() if k not in ("fvu", "l0")} \
                == {k: v for k, v in j.items() if k not in ("fvu", "l0")}
            for k in ("fvu", "l0"):
                assert t[k] == pytest.approx(j[k], rel=EVAL_RTOL), k
    for path in sorted((tmp_path / "jax" / sub).glob("*_learned_dicts.pkl")):
        port_side = load_learned_dicts(tmp_path / "torch" / sub / path.name)
        assert [h for _, h in port_side] == [
            h for _, h in load_learned_dicts(path)]
    # per-bucket log streams under the bucket names
    keys = set()
    for line in (tmp_path / "torch/metrics.jsonl").read_text().splitlines():
        keys |= set(json.loads(line))
    for e, _, name in built:
        for bucket in getattr(e, "ensembles", {name: e}):
            assert f"{bucket}/loss_mean" in keys
        # a group's member streams are positional
        for bucket in getattr(e, "ensembles", {}):
            assert f"{bucket}/member0/loss" in keys


def test_centered_bucket_trains_on_autodiff(store, tmp_path):
    """A centered tied bucket is ineligible for the kernels: it resolves
    to autodiff as a family, not as a shape the kernels refuse."""
    _, tcfg = _configs(store, tmp_path)
    (ens, _, _), = texp.centered_l1_range_experiment(
        tcfg, **_kwargs("centered_l1_range", store), device="cpu")
    ens.step_batch(torch.zeros(BATCH, D))
    assert ens.fused_path is None
    assert ens.path_resolved == {("autodiff", "family_ineligible"): 1}


def test_centered_fit_runs_on_the_given_device(store, tmp_path):
    """Without ``centering=``, the experiment fits its whitening on the
    device it was given (the CPU here; the default device is the card)
    and lands on the JAX fit of the same chunk: the mean within 1e-5, the
    whitening matrix rotᵀ·diag(scale)·rot — free of eigh's signs — within
    rtol 1e-3 (1/√λ doubles the small eigenvalues' rounding)."""
    _, tcfg = _configs(store, tmp_path)
    (ens, _, _), = texp.centered_l1_range_experiment(
        tcfg, l1_range=[1e-3], activation_dim=D, device="cpu")
    b = {k: v[0].numpy() for k, v in ens.state.buffers.items()}
    mean, rot, scale = _centering(store)
    np.testing.assert_allclose(b["center_trans"], mean, rtol=1e-5,
                               atol=1e-6)
    white = lambda r, s: r.T @ np.diag(s) @ r
    np.testing.assert_allclose(white(b["center_rot"], b["center_scale"]),
                               white(rot, scale), rtol=1e-3,
                               atol=1e-3 * np.abs(scale).max())


def _cli(store, out, *extra):
    return ["--experiment", "topk", "--device", "cpu",
            "--dataset_folder", str(store), "--output_folder", str(out),
            "--batch_size", "64", "--learned_dict_ratio", "8",
            "--n_chunks", "3", "--image_metrics_every", "none",
            "--log_every", "4", *extra]


def test_group_kill_and_resume_is_bitwise(tmp_path):
    """topk (six buckets at the default ks) killed at the second chunk's
    end, then resumed: its dicts, eval.json and every bucket's checkpoint
    file equal the uninterrupted run's, byte for byte; the orbax backend
    writes the same bucket files."""
    from conftest import stripped_cpu_subprocess_env

    store = write_store(tmp_path / "store", n_chunks=3, rows=192, d=D)
    full, killed_out = tmp_path / "full", tmp_path / "killed"
    tsweep.main(_cli(store, full))
    env = stripped_cpu_subprocess_env()
    env[crash.ENV_VAR] = "sweep.chunk:nth=2"
    killed = subprocess.run(
        [sys.executable, "-m", "sparse_coding_tpu_torch.train.sweep",
         *_cli(store, killed_out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-3000:]
    tsweep.main(_cli(store, killed_out, "--resume", "true"))
    # the orbax backend writes the same files, one a bucket
    orbax = tmp_path / "orbax"
    tsweep.main(_cli(store, orbax, "--checkpoint_backend", "orbax"))
    ckpts = sorted(p.name for p in (full / "ckpt").iterdir())
    for name in ckpts:
        assert (orbax / "ckpt" / name).read_bytes() == \
            (full / "ckpt" / name).read_bytes(), name
    assert [n for n in ckpts if n.endswith(".tensors")] == [
        f"topk_{j}.tensors" for j in range(6)]
    assert sorted(p.name for p in (killed_out / "ckpt").iterdir()) == ckpts
    for name in ckpts:
        assert (full / "ckpt" / name).read_bytes() == \
            (killed_out / "ckpt" / name).read_bytes(), name
    for name in ("topk_eval.json", "topk_learned_dicts.pkl"):
        assert (full / "_2" / name).read_bytes() == \
            (killed_out / "_2" / name).read_bytes(), name


def test_dispatch_takes_groups():
    """dispatch_job_on_chunk steps a group's every bucket (the aux a dict
    by bucket) beside a plain ensemble."""
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE
    from sparse_coding_tpu_torch.models.topk import TopKEncoder
    from sparse_coding_tpu_torch.train.dispatch import (
        collect_lite,
        dispatch_job_on_chunk,
        dispatch_lite,
    )

    g = torch.Generator().manual_seed(0)
    group = EnsembleGroup.build(TopKEncoder, [
        TopKEncoder.init(g, D, 48, k=k) for k in (4, 8, 4)], device="cpu")
    ens = Ensemble([FunctionalTiedSAE.init(g, D, 48, 1e-3)],
                   FunctionalTiedSAE, device="cpu")
    chunk = np.random.default_rng(0).normal(size=(256, D)).astype(np.float32)
    aux = dispatch_job_on_chunk([group, ens], chunk, batch_size=64)
    assert set(aux["0"]) == {"topk_k4", "topk_k8"}
    assert aux["1"].losses["loss"].shape == (1,)
    assert int(group.ensembles["topk_k4"].state.step) == 4
    lite = collect_lite(dispatch_lite([group], chunk, batch_size=64))
    assert set(lite["0"]) == {"topk_k4", "topk_k8"}
