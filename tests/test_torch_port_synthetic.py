"""The port's synthetic data (``data/synthetic.py``: the correlation
matrix, ``SparseMixDataset`` and its noise) against the JAX package's,
and ``save_pytree``/``restore_pytree`` (``utils/checkpoint.py``).

Where the output is deterministic it is held exactly in kind: the
correlation matrix from the same uniform draws (rtol 1e-5), the noise
Cholesky factor from the same covariance. The draws themselves come from
``torch.Generator``, not ``jax.random``; they are held by their
statistics, on a generator built from the JAX generator's own feats,
decay and factors: 400 batches of 100 rows a side (each batch with its
own copula draw), every first and second moment's two-sample difference
within 5 standard errors; the noise's covariance over 40,000 rows within
3% of max|scale²·Σ| (about six standard errors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.data import synthetic as jsyn
from sparse_coding_tpu_torch.data import synthetic as tsyn
from sparse_coding_tpu_torch.resilience import faults
from sparse_coding_tpu_torch.resilience.errors import (
    CheckpointCorruptionError,
)
from sparse_coding_tpu_torch.utils.checkpoint import (
    restore_pytree,
    save_pytree,
)

ROWS = 40_000


@pytest.mark.parametrize("n", [2, 8, 33])
def test_corr_matrix_matches_jax_on_the_same_draws(n):
    key = jax.random.PRNGKey(n)
    want = np.asarray(jsyn.generate_corr_matrix(key, n))
    uniform = np.array(jax.random.uniform(key, (n, n)))
    got = tsyn.corr_from_uniform(torch.as_tensor(uniform)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.linalg.eigvalsh(got).min() > 0
    g = tsyn.generate_corr_matrix(torch.Generator().manual_seed(0), n)
    np.testing.assert_allclose(g.numpy(), g.numpy().T)
    assert torch.linalg.eigvalsh(g).min() > 0


def _mix_pair(scale=0.3, cov=None):
    """The JAX SparseMixDataset and the port's over the same feats, decay
    and factors."""
    jds = jsyn.SparseMixDataset.create(jax.random.PRNGKey(0), 12, 24, 4,
                                       0.97, scale, noise_covariance=cov)
    t = lambda a: torch.as_tensor(np.array(a))
    base = tsyn.RandomDatasetGenerator(
        feats=t(jds.base.feats), decay=t(jds.base.decay),
        corr_chol=t(jds.base.corr_chol), frac_nonzero=jds.base.frac_nonzero,
        correlated=True)
    return jds, tsyn.SparseMixDataset(
        base=base, noise_chol=t(jds.noise_chol),
        noise_magnitude_scale=jds.noise_magnitude_scale)


def _batch_stats(batches):
    """Per batch: each dimension's mean and second moment, and the mean
    of the products of dimension pairs."""
    x = np.asarray(batches, np.float64)  # [n_batches, rows, d]
    prods = np.einsum("brd,bre->bde", x, x) / x.shape[1]
    return [x.mean(axis=1), (x ** 2).mean(axis=1),
            prods.reshape(len(x), -1)]


def test_sparse_mix_dataset_statistics_match_jax():
    """Each batch shares one copula draw, so batches vary together: the
    statistics are compared as two samples of 400 batches of 100 rows,
    each difference of means within 5 of its standard errors."""
    jds, tds = _mix_pair()
    keys = jax.random.split(jax.random.PRNGKey(1), ROWS // 100)
    jx = np.stack([np.asarray(jds.batch(k, 100)) for k in keys])
    g = torch.Generator().manual_seed(1)
    tx = torch.stack([tds.batch(g, 100) for _ in keys]).numpy()
    assert tx.shape == jx.shape and np.isfinite(tx).all()
    for js, ts in zip(_batch_stats(jx), _batch_stats(tx)):
        se = np.sqrt((js.var(axis=0) + ts.var(axis=0)) / len(keys))
        z = np.abs(js.mean(axis=0) - ts.mean(axis=0)) / np.maximum(se, 1e-12)
        assert z.max() < 5.0, z.max()
    np.testing.assert_array_equal(tds.feats.numpy(), np.asarray(jds.feats))


def test_sparse_mix_create_and_noise():
    rs = np.random.default_rng(0)
    a = rs.normal(size=(12, 12))
    cov = (a @ a.T / 12 + 0.5 * np.eye(12)).astype(np.float32)
    jds = jsyn.SparseMixDataset.create(jax.random.PRNGKey(0), 12, 24, 4,
                                       0.97, 0.5, noise_covariance=cov)
    tds = tsyn.SparseMixDataset.create(torch.Generator().manual_seed(0), 12,
                                       24, 4, 0.97, 0.5, noise_covariance=cov)
    np.testing.assert_allclose(tds.noise_chol.numpy(),
                               np.asarray(jds.noise_chol), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(tds.feats, dim=-1).numpy(), 1.0, rtol=1e-6)
    assert tds.base.correlated and tds.base.corr_chol is not None
    noise = tsyn.noise_batch(torch.Generator().manual_seed(2),
                             tds.noise_chol, 0.5, ROWS).numpy()
    np.testing.assert_allclose(np.cov(noise.T), 0.25 * cov,
                               atol=0.03 * 0.25 * np.abs(cov).max())
    jnoise = np.asarray(jsyn._noise_batch(jax.random.PRNGKey(2),
                                          jnp.asarray(tds.noise_chol.numpy()),
                                          0.5, ROWS))
    np.testing.assert_allclose(np.cov(noise.T), np.cov(jnoise.T),
                               atol=0.03 * 0.25 * np.abs(cov).max())
    # the identity covariance by default
    plain = tsyn.SparseMixDataset.create(torch.Generator().manual_seed(0),
                                         12, 24, 4, 0.97, 0.1)
    assert torch.equal(plain.noise_chol, torch.eye(12))


# -- save_pytree / restore_pytree ----------------------------------------------


def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.tensor([1, 2], dtype=torch.int32)},
            "moments": [torch.ones(3, dtype=torch.bfloat16),
                        np.array([0.5, 1.5], np.float32)],
            "meta": (7, 2.5, True), "skip": None}


def test_pytree_round_trip(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "t.tensors")
    assert (tmp_path / "t.tensors.sha256").exists()
    back = restore_pytree(tree, tmp_path / "t.tensors")
    assert torch.equal(back["params"]["w"], tree["params"]["w"])
    assert back["params"]["b"].dtype == torch.int32
    assert back["moments"][0].dtype == torch.bfloat16
    assert torch.equal(back["moments"][0], tree["moments"][0])
    np.testing.assert_array_equal(back["moments"][1], tree["moments"][1])
    assert back["meta"] == (7, 2.5, True) and back["skip"] is None
    # the template decides the nesting: a subtree restores alone
    sub = restore_pytree({"params": {"w": torch.zeros(2, 3)}},
                         tmp_path / "t.tensors")
    assert torch.equal(sub["params"]["w"], tree["params"]["w"])
    # equal trees give equal bytes
    save_pytree(_tree(), tmp_path / "u.tensors")
    assert (tmp_path / "t.tensors").read_bytes() == \
        (tmp_path / "u.tensors").read_bytes()


def test_pytree_corruption_and_fault_sites(tmp_path):
    tree = _tree()
    path = tmp_path / "t.tensors"
    save_pytree(tree, path)
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptionError, match="sha256"):
        restore_pytree(tree, path)
    save_pytree(tree, path)
    with pytest.raises(CheckpointCorruptionError, match="does not load"):
        restore_pytree({"params": {"missing": torch.zeros(1)}}, path)
    for site, call in (("ckpt.save", lambda: save_pytree(tree, path)),
                       ("ckpt.restore", lambda: restore_pytree(tree, path))):
        with faults.inject(faults.FaultSpec(site=site)):
            with pytest.raises(OSError):
                call()
