"""The port's dictionary metrics (``metrics/core.py``) against the JAX
package's on the same numpy inputs: reconstruction (FVU split, R²), the
activity counts, the streaming scans over an array and over a store
(rows carried across chunk boundaries), MMCS to a fixed truth,
representedness, Hungarian matching, feature moments, geometry and the
sklearn probes; and ``topk_sparsify`` on rows with ties.

Tolerances: rtol 1e-5 (atol 1e-6) for single products and reductions;
the streaming moments rtol 1e-4 (fp32 sums of fourth powers over
batches, atol 1e-6 of max|ref|); counts, and everything integer, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.data.chunk_store import ChunkStore as JaxStore
from sparse_coding_tpu.data.chunk_store import ChunkWriter as JaxWriter
from sparse_coding_tpu.metrics import core as jm
from sparse_coding_tpu.models import learned_dict as jld
from sparse_coding_tpu.models import topk as jtopk
from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
from sparse_coding_tpu_torch.metrics import core as tm
from sparse_coding_tpu_torch.models import learned_dict as tld
from sparse_coding_tpu_torch.models.topk import topk_sparsify
from sparse_coding_tpu_torch.resilience.errors import UndersizedInputError

D, N, ROWS, CHUNKS, BATCH = 16, 32, 250, 3, 100
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


@pytest.fixture(scope="module")
def data():
    rs = np.random.default_rng(0)
    feats = rs.normal(size=(N, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    codes = rs.uniform(size=(ROWS * CHUNKS, N)) * (
        rs.uniform(size=(ROWS * CHUNKS, N)) < 0.15)
    x = (codes @ feats + 0.05 * rs.normal(size=(ROWS * CHUNKS, D)))
    enc = (feats + 0.1 * rs.normal(size=(N, D))).astype(np.float32)
    bias = (-0.05 * np.abs(rs.normal(size=N))).astype(np.float32)
    return dict(x=x.astype(np.float32), feats=feats, enc=enc, bias=bias)


@pytest.fixture(scope="module")
def dicts(data):
    return (jld.TiedSAE(dictionary=jnp.asarray(data["enc"]),
                        encoder_bias=jnp.asarray(data["bias"])),
            tld.TiedSAE(dictionary=torch.as_tensor(data["enc"]),
                        encoder_bias=torch.as_tensor(data["bias"])))


@pytest.fixture(scope="module")
def stores(data, tmp_path_factory):
    folder = tmp_path_factory.mktemp("metrics") / "store"
    w = JaxWriter(folder, D, chunk_size_gb=ROWS * D * 4 / 2**30,
                  dtype="float32")
    w.add(data["x"])
    w.finalize()
    return JaxStore(folder), ChunkStore(folder)


def test_reconstruction_and_activity(data, dicts):
    jd, td = dicts
    jx, tx = jnp.asarray(data["x"]), torch.as_tensor(data["x"])
    _close(tm.fraction_variance_unexplained(td, tx),
           jm.fraction_variance_unexplained(jd, jx))
    _close(tm.r_squared(td, tx), jm.r_squared(jd, jx))
    for n_top in (1, 3):
        for t, j in zip(tm.fvu_top_activating(td, tx, n_top),
                        jm.fvu_top_activating(jd, jx, n_top)):
            _close(t, j)
    _close(tm.mean_l0(td, tx), jm.mean_l0(jd, jx))
    _close(tm.mean_nonzero_activations(td, tx),
           jm.mean_nonzero_activations(jd, jx))
    c = td.encode(tx)
    np.testing.assert_array_equal(tm.calc_feature_n_active(c).numpy(),
                                  np.asarray(jm.calc_feature_n_active(
                                      jnp.asarray(c.numpy()))))


@pytest.mark.parametrize("source", ["array", "store"])
def test_streaming_scans_match_jax(data, dicts, stores, source):
    jd, td = dicts
    jin, tin = ((jnp.asarray(data["x"]), data["x"]) if source == "array"
                else stores)
    for thr in (0, 10):
        assert tm.n_ever_active(td, tin, BATCH, thr) == \
            jm.n_ever_active(jd, jin, BATCH, thr)
    tmom = tm.calc_moments_streaming(td, tin, BATCH)
    jmom = jm.calc_moments_streaming(jd, jin, BATCH)
    for t, j in zip(tmom, jmom):
        j = np.asarray(j)
        _close(t, j, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(j).max()))
    n_t, swept = tm.streaming_eval_sweep(td, tin, BATCH)
    n_j, jswept = jm.streaming_eval_sweep(jd, jin, BATCH)
    assert n_t == n_j
    for t, j in zip(swept, jswept):
        j = np.asarray(j)
        _close(t, j, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(j).max()))


def test_store_slabs_equal_the_array_rows(data, stores):
    """The store's slabs are the concatenated chunks' first whole batches
    (the leftover rows carried into the next chunk)."""
    slabs = list(tm.iter_slabs(stores[1], BATCH))
    assert all(s.shape[0] % BATCH == 0 for s in slabs)
    got = torch.cat(slabs).numpy()
    n = (ROWS * CHUNKS // BATCH) * BATCH
    np.testing.assert_array_equal(got, data["x"][:n])


def test_moments_refuse_a_batch_larger_than_the_rows(data, dicts):
    _, td = dicts
    with pytest.raises(UndersizedInputError):
        tm.calc_moments_streaming(td, data["x"][:50], batch_size=BATCH)


def test_similarity_metrics(data, dicts):
    jd, td = dicts
    feats = data["feats"]
    jf, tf = jnp.asarray(feats), torch.as_tensor(feats)
    _close(tm.mcs_to_fixed(td, tf), jm.mcs_to_fixed(jd, jf))
    _close(tm.mmcs_to_fixed(td, tf), jm.mmcs_to_fixed(jd, jf))
    _close(tm.representedness(tf, td), jm.representedness(jf, jd))
    other_np = data["enc"][::-1].copy() + 0.3
    jo = jld.TiedSAE(dictionary=jnp.asarray(other_np),
                     encoder_bias=jnp.zeros(N))
    to = tld.TiedSAE(dictionary=torch.as_tensor(other_np),
                     encoder_bias=torch.zeros(N))
    _close(tm.mcs_duplicates(to, td), jm.mcs_duplicates(jo, jd))
    _close(tm.mmcs(td, to), jm.mmcs(jd, jo))
    _close(tm.mmcs_from_list([td, to, td]), jm.mmcs_from_list([jd, jo, jd]))
    small, large = data["enc"][:12], data["enc"]
    _close(tm.hungarian_mcs(torch.as_tensor(small), torch.as_tensor(large)),
           jm.hungarian_mcs(jnp.asarray(small), jnp.asarray(large)))
    rs = np.random.default_rng(3)
    grid = [[rs.normal(size=(n, D)).astype(np.float32) for n in (8, 12, 16)]
            for _ in range(2)]
    tav, tab, th = tm.mmcs_with_larger_grid(
        [[torch.as_tensor(g) for g in row] for row in grid])
    jav, jab, jh = jm.mmcs_with_larger_grid(
        [[jnp.asarray(g) for g in row] for row in grid])
    _close(tav, jav)
    np.testing.assert_array_equal(tab, jab)
    for trow, jrow in zip(th, jh):
        for t, j in zip(trow, jrow):
            _close(t, j)


def test_moments_geometry_and_probes(data, dicts):
    jd, td = dicts
    codes = td.encode(torch.as_tensor(data["x"]))
    tmom = tm.feature_moments(codes)
    jmom = jm.feature_moments(jnp.asarray(codes.numpy()))
    for k in jmom:
        _close(tmom[k], jmom[k], rtol=1e-4, atol=1e-6)
    _close(tm.neurons_per_feature(td), jm.neurons_per_feature(jd))
    _close(tm.capacity_per_feature(td), jm.capacity_per_feature(jd))
    pytest.importorskip("sklearn")
    acts = codes.numpy()[:200]
    labels = (data["x"][:200, 0] > 0).astype(np.int64)
    assert tm.logistic_regression_auroc(acts, labels, max_iter=200) == \
        pytest.approx(jm.logistic_regression_auroc(acts, labels,
                                                   max_iter=200), rel=1e-6)
    assert tm.ridge_regression_auroc(acts, labels) == pytest.approx(
        jm.ridge_regression_auroc(acts, labels), rel=1e-6)


def test_topk_sparsify_with_ties():
    """Rows whose k-th place is a tie among zeros or negatives: either
    pick writes relu(value) = 0, so the result equals JAX's."""
    scores = np.array([[3.0, 0.0, 0.0, 0.0, -1.0, 2.0],
                       [-1.0, -1.0, -1.0, -1.0, -2.0, 0.5],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [1.0, 0.5, -3.0, 0.2, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        t = topk_sparsify(torch.as_tensor(scores), k).numpy()
        j = np.asarray(jtopk.topk_sparsify(jnp.asarray(scores), k))
        np.testing.assert_array_equal(t, j)
    rs = np.random.default_rng(1)
    s = rs.normal(size=(64, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        topk_sparsify(torch.as_tensor(s), 7).numpy(),
        np.asarray(jtopk.topk_sparsify(jnp.asarray(s), 7)))
    # and its gradient flows to the kept positive scores only
    st = torch.as_tensor(s).requires_grad_(True)
    topk_sparsify(st, 7).sum().backward()
    jg = jax.grad(lambda a: jtopk.topk_sparsify(a, 7).sum())(jnp.asarray(s))
    np.testing.assert_array_equal(st.grad.numpy(), np.asarray(jg))
