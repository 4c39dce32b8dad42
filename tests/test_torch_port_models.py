"""The model zoo's trainable families in the port against the JAX
package's signatures: the tied-centered, thresholding, masked-untied and
reverse SAEs, TopK, LISTA and residual denoising, the positive and
semilinear SAEs and RICA (both sparsity losses), plus PCA and the
EnsembleGroup bucketing.

Inputs are numpy arrays from a seed: each JAX ``init`` member is carried
into the port (``utils/carry.py``), and the batches are the same arrays.
The loss, every aux statistic and every gradient are held at rtol 2e-4
(atol 1e-6), the JAX package's fused-vs-autodiff bound, at d=24-40; the
gradients also at the boundaries where the JAX and torch primitives could
part (LISTA's ``clip(rho, 0, 1)`` at 0 and 1, the positive family's
``relu(encoder)`` at 0, ReverseSAE's ``where(c > 0, c − b, c)`` with most
codes at 0); then a 20-step ``Ensemble`` trajectory per family on
autodiff, per-step losses and the final params at the same bound (the
LISTA encoder's layers at atol 2e-4 of max|leaf|, see
``test_torch_port_group_sweep.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu import ensemble as jens
from sparse_coding_tpu.models import lista as jlista
from sparse_coding_tpu.models import pca as jpca
from sparse_coding_tpu.models import positive as jpos
from sparse_coding_tpu.models import rica as jrica
from sparse_coding_tpu.models import sae as jsae
from sparse_coding_tpu.models import semilinear as jsemi
from sparse_coding_tpu.models import topk as jtopk
from sparse_coding_tpu_torch import ensemble as tens
from sparse_coding_tpu_torch.models import lista as tlista
from sparse_coding_tpu_torch.models import pca as tpca
from sparse_coding_tpu_torch.models import positive as tpos
from sparse_coding_tpu_torch.models import rica as trica
from sparse_coding_tpu_torch.models import sae as tsae
from sparse_coding_tpu_torch.models import semilinear as tsemi
from sparse_coding_tpu_torch.models import topk as ttopk
from sparse_coding_tpu_torch.models.signatures import get_signature
from sparse_coding_tpu_torch.utils.carry import members_from_numpy

TOL = dict(rtol=2e-4, atol=1e-6)
D, N, B = 24, 40, 64


def _np_tree(t):
    """Array leaves as numpy; static buffers (ints, strings) as they are."""
    return jax.tree.map(lambda v: v if isinstance(v, (int, float, str))
                        else np.asarray(v), t)


def _jax_tree(t):
    return jax.tree.map(lambda v: v if isinstance(v, (int, float, str))
                        else jnp.asarray(v), t)


def _with(params, **over):
    """A member's params with leaves replaced by numpy arrays."""
    out = _np_tree(params)
    for path, v in over.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = np.asarray(v, np.float32)
    return out


def _rs(seed):
    return np.random.default_rng(seed)


# (id, JAX signature, port signature, init(sig, key_or_gen, l1) -> member)
def _init(*args, **kw):
    return lambda sig, k, l1: sig.init(k, D, N, l1, *args, **kw)


FAMILIES = [
    ("tied_centered", jsae.FunctionalTiedCenteredSAE,
     tsae.FunctionalTiedCenteredSAE, _init()),
    ("thresholding", jsae.FunctionalThresholdingSAE,
     tsae.FunctionalThresholdingSAE, _init()),
    ("masked_untied", jsae.FunctionalMaskedSAE, tsae.FunctionalMaskedSAE,
     lambda sig, k, l1: sig.init(k, D, 32, N, l1)),
    ("reverse", jsae.FunctionalReverseSAE, tsae.FunctionalReverseSAE,
     lambda sig, k, l1: sig.init(k, D, N, l1, bias_decay=0.01)),
    ("topk", jtopk.TopKEncoder, ttopk.TopKEncoder,
     lambda sig, k, l1: sig.init(k, D, N, k=6)),
    ("lista", jlista.FunctionalLISTADenoisingSAE,
     tlista.FunctionalLISTADenoisingSAE, _init(n_hidden_layers=2)),
    ("residual", jlista.FunctionalResidualDenoisingSAE,
     tlista.FunctionalResidualDenoisingSAE, _init(n_hidden_layers=2)),
    ("positive", jpos.FunctionalPositiveTiedSAE,
     tpos.FunctionalPositiveTiedSAE,
     lambda sig, k, l1: sig.init(k, D, N, l1, bias_decay=0.01)),
    ("semilinear", jsemi.SemiLinearSAE, tsemi.SemiLinearSAE,
     lambda sig, k, l1: sig.init(k, D, N, l1, hidden_size=32)),
    ("rica_smooth_l1", jrica.RICA, trica.RICA,
     lambda sig, k, l1: sig.init(k, D, N, l1 * 10)),
    ("rica_l1", jrica.RICA, trica.RICA,
     lambda sig, k, l1: sig.init(k, D, N, l1 * 10, sparsity_loss="l1")),
]
IDS = [f[0] for f in FAMILIES]


def _member(fam, seed=0, l1=3e-3):
    _, jsig, _, init = fam
    params, buffers = init(jsig, jax.random.PRNGKey(seed), l1)
    return _np_tree(params), _np_tree(buffers)


def _perturbed(fam, params, rs):
    """Inputs that reach each family's boundaries and non-trivial paths."""
    name = fam[0]
    if name == "tied_centered":
        return _with(params, center=0.3 * rs.normal(size=D))
    if name == "reverse":
        return _with(params, encoder_bias=0.3 * rs.normal(size=N))
    if name == "positive":
        enc = np.array(params["encoder"])
        enc[:, :4] = 0.0  # relu(encoder) at its kink
        enc[:3, 4:] = -np.abs(enc[:3, 4:])
        return _with(params, encoder=enc)
    if name == "thresholding":
        return _with(params, activation_scale=1 + 0.2 * rs.normal(size=N),
                     activation_gain=0.3 * rs.normal(size=N))
    if name == "lista":
        # clip(rho, 0, 1) at both ends, inside and outside
        return _with(params, **{"encoder_layers.rho": [0.0, 1.0]})
    return params


def _jax_loss_and_grads(jsig, params, buffers, x):
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jsig.loss(p, buffers, jnp.asarray(x)), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return loss, aux, grads


def _port_loss_and_grads(tsig, params, buffers, x):
    (p, b), = members_from_numpy([(params, buffers)])
    flat = tens.flatten_tree(p)
    for v in flat.values():
        v.requires_grad_(True)
    loss, aux = tsig.loss(tens.unflatten_tree(flat), b, torch.as_tensor(x))
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, aux, dict(zip(flat, grads))


def _assert_aux(taux, jaux):
    assert set(taux.losses) == set(jaux.losses)
    for k in jaux.losses:
        np.testing.assert_allclose(taux.losses[k].detach().numpy(),
                                   np.asarray(jaux.losses[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(taux.l0.numpy(), np.asarray(jaux.l0), **TOL)
    np.testing.assert_array_equal(taux.feat_activity.numpy(),
                                  np.asarray(jaux.feat_activity))


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_loss_aux_and_grads_match_jax(fam):
    rs = _rs(1)
    params, buffers = _member(fam)
    params = _perturbed(fam, params, rs)
    x = rs.normal(size=(B, D)).astype(np.float32)
    jloss, jaux, jgrads = _jax_loss_and_grads(fam[1], params, buffers, x)
    tloss, taux, tgrads = _port_loss_and_grads(fam[2], params, buffers, x)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    _assert_aux(taux, jaux)
    jflat = tens.flatten_tree(_np_tree(jgrads))
    assert list(tgrads) == list(jflat)
    for k, g in jflat.items():
        np.testing.assert_allclose(tgrads[k].numpy(), g, **TOL, err_msg=k)
    if fam[0] == "lista":
        # the clip's gradient at rho = 0 and 1 is JAX's split, nonzero
        assert np.all(jflat["encoder_layers/rho"] != 0)


def test_port_signature_names_match_jax():
    from sparse_coding_tpu.models.signatures import signature_names

    ported = {f[2].signature_name for f in FAMILIES}
    for name in ported:
        assert get_signature(name).signature_name == name
    assert ported <= set(signature_names())


def _trajectory(fam, steps=20):
    jsig, tsig = fam[1], fam[2]
    members = [_member(fam, seed=s, l1=l1)
               for s, l1 in ((0, 1e-3), (1, 4e-3))]
    rs = _rs(7)
    batches = rs.normal(size=(steps, B, D)).astype(np.float32)
    jens_ = jens.Ensemble([_jax_tree(m) for m in members],
                          jsig, lr=3e-3, use_fused=False)
    tens_ = tens.Ensemble(members_from_numpy(members), tsig, lr=3e-3,
                          device="cpu")
    jl, tl = [], []
    for b in batches:
        jl.append(np.asarray(jens_.step_batch(jnp.asarray(b)).losses["loss"]))
        tl.append(tens_.step_batch(torch.as_tensor(b)).losses["loss"].numpy())
    return jens_, tens_, np.array(jl), np.array(tl)


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_ensemble_trajectory_matches_jax(fam):
    jens_, tens_, jl, tl = _trajectory(fam)
    assert tens_.fused_path is None
    np.testing.assert_allclose(tl, jl, **TOL)
    for (jp, _), (tp, _) in zip(jens_.unstack(), tens_.unstack()):
        jflat = tens.flatten_tree(_np_tree(jp))
        tflat = tens.flatten_tree(tp)
        assert list(tflat) == list(jflat)
        for k, v in jflat.items():
            tol = (dict(rtol=2e-4, atol=2e-4 * np.abs(v).max())
                   if k.startswith("encoder_layers") else TOL)
            np.testing.assert_allclose(tflat[k].numpy(), v, **tol, err_msg=k)


def test_group_buckets_match_jax():
    """Buckets keyed by static buffers in order of first appearance, with
    the JAX names; each bucket's step equals the JAX bucket's."""
    ks = (8, 4, 8, 16)
    members = [_np_tree(jtopk.TopKEncoder.init(jax.random.PRNGKey(i), D, N,
                                               k=k))
               for i, k in enumerate(ks)]
    jg = jens.EnsembleGroup.build(jtopk.TopKEncoder, members, lr=3e-3)
    tg = tens.EnsembleGroup.build(ttopk.TopKEncoder,
                                  members_from_numpy(members), lr=3e-3,
                                  device="cpu")
    assert list(tg.ensembles) == list(jg.ensembles) == [
        "topk_k8", "topk_k4", "topk_k16"]
    x = _rs(3).normal(size=(B, D)).astype(np.float32)
    jaux = jg.step_batch(jnp.asarray(x))
    taux = tg.step_batch(torch.as_tensor(x))
    for name in jaux:
        np.testing.assert_allclose(taux[name].losses["loss"].numpy(),
                                   np.asarray(jaux[name].losses["loss"]),
                                   **TOL)
    cost = tg.step_cost(B)
    assert cost.activations == 3 * B and cost.path == "autodiff"
    assert [len(v) for v in tg.to_learned_dicts().values()] == [2, 1, 1]
    # a string static names its bucket too
    rica = [_np_tree(jrica.RICA.init(jax.random.PRNGKey(0), D, N, 0.1,
                                     sparsity_loss=s)) for s in ("l1", "smooth_l1")]
    assert list(tens.EnsembleGroup.build(
        trica.RICA, members_from_numpy(rica), device="cpu").ensembles) == \
        list(jens.EnsembleGroup.build(jrica.RICA, rica).ensembles)


# -- PCA -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def acts():
    rs = _rs(5)
    mix = rs.normal(size=(D, D)) * np.linspace(0.2, 2.0, D)
    return (rs.normal(size=(1000, D)) @ mix + 0.5).astype(np.float32)


def test_fit_pca_matches_jax(acts):
    jstate = jpca.fit_pca(jnp.asarray(acts), batch_size=96)
    tstate = tpca.fit_pca(acts, batch_size=96, device="cpu")
    np.testing.assert_allclose(tstate.n_samples.item(),
                               float(jstate.n_samples))
    np.testing.assert_allclose(tstate.mean.numpy(), np.asarray(jstate.mean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tstate.cov.numpy(), np.asarray(jstate.cov),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tpca.fit_mean(acts, 96, "cpu").numpy(),
                               np.asarray(jpca.fit_mean(jnp.asarray(acts), 96)),
                               rtol=1e-5, atol=1e-6)


def test_batched_pca_and_exports_match_jax(acts):
    """Eigenvalues and rotᵀ·diag(λ)·rot, never the raw vectors (eigh fixes
    each only up to its sign); the exports compared sign-free."""
    jp, tp = jpca.BatchedPCA(D), tpca.BatchedPCA(D, device="cpu")
    for lo in range(0, 1000, 250):
        jp.train_batch(acts[lo:lo + 250])
        tp.train_batch(acts[lo:lo + 250])
    jl, jv = (np.asarray(a) for a in jp.get_pca())
    tl, tv = (a.numpy() for a in tp.get_pca())
    # fp32 streaming sums and eigh: within 1e-4 of the largest eigenvalue
    scale = 1e-4 * np.abs(jl).max()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=scale)
    np.testing.assert_allclose(tv @ np.diag(tl) @ tv.T,
                               jv @ np.diag(jl) @ jv.T, rtol=1e-4, atol=scale)
    jm, _, js = jp.get_centering_transform()
    tm, _, ts = tp.get_centering_transform()
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    # 1/√λ doubles the small eigenvalues' relative rounding (1.7e-4 seen)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3)
    sign_free = lambda a, b: np.testing.assert_allclose(
        np.abs(np.sum(a * b, axis=-1)), 1.0, atol=1e-4)
    sign_free(tp.get_dict().numpy(), np.asarray(jp.get_dict()))
    assert tp.to_rotation_dict(5).rotation.shape == (5, D)
    assert tp.to_topk_dict(3).dictionary.shape == (2 * D, D)
    pve = tp.to_pve_rotation_dict(4)
    assert pve.dictionary.shape == (8, D) and pve.centering_trans is not None
    # PCAEncoder on one dictionary: the same signed top-k codes
    pca_dict = np.array(jp.to_learned_dict(5).pca_dict)
    x = acts[:32]
    jenc = jpca.PCAEncoder(pca_dict=jnp.asarray(pca_dict), k=5)
    tenc = tpca.PCAEncoder(pca_dict=torch.as_tensor(pca_dict), k=5)
    np.testing.assert_allclose(tenc.encode(torch.as_tensor(x)).numpy(),
                               np.asarray(jenc.encode(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
