"""The port's inference dictionaries against the JAX package's: every
class of the JAX ``models`` export list (and the zoo modules' own dicts)
but those of the ica, nmf, direct_coef and combination families.

One JAX-written ``learned_dicts.pkl`` holding every class loads in the
port (``utils/artifacts.py``), and a port-written one loads in the JAX
package; on the same numpy inputs each dict's encode, decode and predict
agree at rtol 1e-5 (atol 1e-5 of max(1, max|ref|)). ``AddedNoise`` draws its noise from a
torch generator seeded by the key and the batch, not ``jax.random``:
held for determinism on one batch, independence across batches, and its
noise statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.models import learned_dict as jld
from sparse_coding_tpu.models import lista as jlista
from sparse_coding_tpu.models import pca as jpca
from sparse_coding_tpu.models import rica as jrica
from sparse_coding_tpu.models import sae as jsae
from sparse_coding_tpu.models import semilinear as jsemi
from sparse_coding_tpu.utils import artifacts as jart
from sparse_coding_tpu_torch.models import learned_dict as tld
from sparse_coding_tpu_torch.utils import artifacts as tart

D, N = 12, 20
EXCLUDED_FAMILIES = ("ica", "nmf", "direct_coef", "combination")


def _a(rs, *shape, scale=1.0):
    return jnp.asarray((scale * rs.normal(size=shape)).astype(np.float32))


def _jax_dicts():
    rs = np.random.default_rng(0)
    layers = {"W": _a(rs, 2, N, D, scale=0.3), "theta": _a(rs, 2, N, scale=0.1),
              "rho": jnp.asarray([0.1, 0.4], jnp.float32)}
    rlayers = {"W": _a(rs, 2, N, N, scale=0.2),
               "theta": _a(rs, 2, N, scale=0.1)}
    pca_dict = jld.normalize_rows(_a(rs, N, D))
    return [
        jld.Identity.create(D),
        jld.IdentityReLU.create(D),
        jld.IdentityPositive.create(D),
        jld.RandomDict.create(jax.random.PRNGKey(1), D, N),
        jld.Rotation.create(jax.random.PRNGKey(2), D),
        jld.AddedNoise.create(jax.random.PRNGKey(3), D, 0.5),
        jld.UntiedSAE(encoder=_a(rs, N, D), encoder_bias=_a(rs, N),
                      dictionary=_a(rs, N, D)),
        jld.TiedSAE(dictionary=_a(rs, N, D), encoder_bias=_a(rs, N),
                    centering_trans=_a(rs, D)),
        jld.TiedCenteredSAE(dictionary=_a(rs, N, D), encoder_bias=_a(rs, N),
                            centering_trans=_a(rs, D)),
        jld.ReverseSAE(dictionary=_a(rs, N, D), encoder_bias=_a(rs, N)),
        jld.TopKLearnedDict(dictionary=_a(rs, N, D), k=5),
        jsae.ThresholdingSAE(dictionary=_a(rs, N, D),
                             activation_scale=1.0 + _a(rs, N, scale=0.1),
                             activation_gain=_a(rs, N, scale=0.3)),
        jlista.LISTADenoisingSAE(decoder=_a(rs, N, D), encoder_layers=layers),
        jlista.ResidualDenoisingSAE(decoder=_a(rs, N, D),
                                    encoder_layers=rlayers,
                                    encoder_bias=_a(rs, N, scale=0.1)),
        jsemi.SemiLinearDict(enc0_w=_a(rs, 16, D), enc0_b=_a(rs, 16),
                             enc1_w=_a(rs, N, 16), enc1_b=_a(rs, N),
                             dictionary=_a(rs, N, D)),
        jrica.RICADict(weights=_a(rs, N, D)),
        jpca.PCAEncoder(pca_dict=pca_dict, k=4),
    ]


def test_every_exported_class_is_covered():
    """The dicts above span the JAX registry minus the families this
    port leaves out (and the big SAE's dict, held by its own tests)."""
    import sparse_coding_tpu.models  # noqa: F401

    covered = {type(d).__name__ for d in _jax_dicts()}
    want = {name for name, cls in jld.LEARNED_DICT_REGISTRY.items()
            if not any(f".{fam}" in cls.__module__
                       for fam in EXCLUDED_FAMILIES)} - {"BigSAEDict"}
    assert covered == want


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(j).max()))


def _compare(jd, td, x):
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    _close(td.encode(tx), jd.encode(jx))
    c = np.abs(np.asarray(jd.encode(jx)))  # nonnegative codes for decode
    _close(td.decode(torch.as_tensor(c)), jd.decode(jnp.asarray(c)))
    _close(td.predict(tx), jd.predict(jx))
    _close(td.get_learned_dict(), jd.get_learned_dict())
    assert td.n_feats == jd.n_feats and td.batch_coupled == jd.batch_coupled


def test_jax_pkl_loads_in_the_port_and_back(tmp_path):
    jdicts = _jax_dicts()
    hypers = [{"i": i, "name": type(d).__name__} for i, d in enumerate(jdicts)]
    jart.save_learned_dicts(list(zip(jdicts, hypers)), tmp_path / "j.pkl")
    ported = tart.load_learned_dicts(tmp_path / "j.pkl")
    assert [h for _, h in ported] == hypers
    x = np.random.default_rng(9).normal(size=(16, D)).astype(np.float32)
    for jd, (td, _) in zip(jdicts, ported):
        assert type(td).__name__ == type(jd).__name__
        if type(td).__name__ != "AddedNoise":
            _compare(jd, td, x)
    # the port's file loads in the JAX package, field for field
    tart.save_learned_dicts(ported, tmp_path / "t.pkl")
    back = jart.load_learned_dicts(tmp_path / "t.pkl")
    for jd, (bd, h) in zip(jdicts, back):
        assert type(bd) is type(jd)
        jleaves = jax.tree.leaves(jd)
        bleaves = jax.tree.leaves(bd)
        assert len(jleaves) == len(bleaves)
        for a, b in zip(jleaves, bleaves):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        if type(bd).__name__ != "AddedNoise":
            _compare(bd, ported[h["i"]][0], x)


def test_select_and_skip_diverged(tmp_path):
    jdicts = _jax_dicts()[:3]
    hypers = [{"i": 0}, {"i": 1, "diverged": True}, {"i": 2}]
    jart.save_learned_dicts(list(zip(jdicts, hypers)), tmp_path / "j.pkl")
    assert [h["i"] for _, h in tart.load_learned_dicts(
        tmp_path / "j.pkl", skip_diverged=True)] == [0, 2]
    assert [h["i"] for _, h in tart.load_learned_dicts(
        tmp_path / "j.pkl", select=lambda h: h["i"] > 0)] == [1, 2]


def test_random_rotation_and_identity_baselines():
    g = torch.Generator().manual_seed(0)
    rd = tld.RandomDict.create(g, D, N)
    np.testing.assert_allclose(torch.linalg.vector_norm(
        rd.dictionary, dim=-1).numpy(), 1.0, rtol=1e-6)
    rot = tld.Rotation.create(g, D).rotation
    np.testing.assert_allclose((rot @ rot.T).numpy(), np.eye(D), atol=1e-5)
    x = torch.randn(4, D, generator=g)
    assert torch.equal(tld.Identity.create(D).predict(x), x)
    assert torch.equal(tld.IdentityReLU.create(D).encode(x), torch.relu(x))
    pm = tld.IdentityPositive.create(D)
    np.testing.assert_allclose(pm.predict(x).numpy(), x.numpy(), atol=1e-6)


def test_added_noise_determinism_and_statistics():
    g = torch.Generator().manual_seed(4)
    noise = tld.AddedNoise.create(g, 64, 0.5)
    assert noise.key.dtype == torch.uint32 and noise.key.shape == (2,)
    x = torch.randn(2048, 64, generator=g)
    a, b = noise.encode(x), noise.predict(x)
    assert torch.equal(a, b)  # one batch, one draw
    eps = (a - x).numpy()
    assert abs(eps.mean()) < 0.01 and abs(eps.std() - 0.5) < 0.01
    other = noise.encode(x + 1.0) - (x + 1.0)
    assert np.abs(np.corrcoef(eps.ravel(), other.numpy().ravel())[0, 1]) < 0.02
    # another key, another stream on the same batch
    noise2 = tld.AddedNoise(noise_mag=noise.noise_mag, eye=noise.eye,
                            key=torch.tensor([1, 2], dtype=torch.uint32))
    assert not torch.equal(noise2.encode(x), a)
    assert noise.to("cpu").key.dtype == torch.uint32
