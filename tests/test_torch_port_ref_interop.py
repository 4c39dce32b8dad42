"""The port's reference interop (``utils/ref_interop.py``) against the
JAX package's, on the same files: artifacts in the reference's on-disk
formats (``learned_dicts.pt`` pickles of ``autoencoders.*`` instances,
``<i>.pt`` chunks) written with the fixture classes of
``tests/test_ref_interop.py``, with the reference package absent. Each
file goes through both loaders: the same classes, and each dict's encode
and predict within rtol 1e-5 of the other's and of the reference math;
the allowlist refuses what the JAX unpickler refuses."""

import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.utils import ref_interop as jri
from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
from sparse_coding_tpu_torch.metrics.core import (
    fraction_variance_unexplained,
    mmcs,
)
from sparse_coding_tpu_torch.models import learned_dict as tld
from sparse_coding_tpu_torch.utils import ref_interop as tri
from test_ref_interop import _norm_rows, _ref_instance, _rng, \
    _save_ref_artifact

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(path):
    """The file through both loaders: [(port dict, JAX dict, hyper)]."""
    tres, jres = tri.load_reference_learned_dicts(path), \
        jri.load_reference_learned_dicts(path)
    assert len(tres) == len(jres)
    out = []
    for (td, th), (jd, jh) in zip(tres, jres):
        assert type(td).__name__ == type(jd).__name__
        assert th.keys() == jh.keys()
        out.append((td, jd, th))
    return out


def _same(td, jd, x):
    """encode and predict of the two loaders' dicts agree."""
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    for fn in ("encode", "predict"):
        np.testing.assert_allclose(getattr(td, fn)(tx).numpy(),
                                   np.asarray(getattr(jd, fn)(jx)), **TOL,
                                   err_msg=fn)


def test_untied_sae(tmp_path):
    r = _rng(1)
    enc, dec = (r.normal(size=(24, 16)).astype(np.float32) for _ in "ab")
    bias = r.normal(size=(24,)).astype(np.float32)
    ref = _ref_instance("UntiedSAE", encoder=torch.tensor(enc),
                        decoder=torch.tensor(dec),
                        encoder_bias=torch.tensor(bias), n_feats=24,
                        activation_size=16)
    (td, jd, hyper), = _both(_save_ref_artifact(
        tmp_path, [(ref, {"l1_alpha": torch.tensor(3e-4), "dict_size": 24})]))
    assert isinstance(td, tld.UntiedSAE)
    assert hyper["l1_alpha"] == pytest.approx(3e-4)
    assert hyper["dict_size"] == 24 and isinstance(hyper["dict_size"], int)
    x = r.normal(size=(7, 16)).astype(np.float32)
    want_c = np.maximum(x @ enc.T + bias, 0.0)
    np.testing.assert_allclose(td.encode(torch.as_tensor(x)).numpy(),
                               want_c, **TOL)
    np.testing.assert_allclose(td.predict(torch.as_tensor(x)).numpy(),
                               want_c @ _norm_rows(dec), **TOL)
    _same(td, jd, x)


@pytest.mark.parametrize("centering", ["trivial", "real", "unnormalized"])
def test_tied_sae_centerings(tmp_path, centering):
    r = _rng(3)
    enc = (3.0 * r.normal(size=(12, 8))).astype(np.float32)
    bias = r.normal(size=(12,)).astype(np.float32)
    attrs = dict(encoder=torch.tensor(enc), encoder_bias=torch.tensor(bias),
                 norm_encoder=centering != "unnormalized", n_feats=12,
                 activation_size=8)
    if centering == "trivial":
        attrs.update(center_trans=torch.zeros(8), center_rot=torch.eye(8),
                     center_scale=torch.ones(8))
    if centering == "real":
        q, _ = np.linalg.qr(r.normal(size=(8, 8)))
        attrs.update(center_trans=torch.tensor(
            r.normal(size=8).astype(np.float32)),
            center_rot=torch.tensor(q.astype(np.float32)),
            center_scale=torch.tensor((1 + r.random(8)).astype(np.float32)))
    (td, jd, _), = _both(_save_ref_artifact(
        tmp_path, [(_ref_instance("TiedSAE", **attrs), {})]))
    x = r.normal(size=(5, 8)).astype(np.float32)
    if centering == "unnormalized":
        assert isinstance(td, tld.UntiedSAE)
        np.testing.assert_allclose(td.encode(torch.as_tensor(x)).numpy(),
                                   np.maximum(x @ enc.T + bias, 0.0), **TOL)
    else:
        assert isinstance(td, tld.TiedSAE)
        assert (td.centering_rot is None) == (centering == "trivial")
        rot = attrs.get("center_rot", torch.eye(8)).numpy()
        trans = attrs.get("center_trans", torch.zeros(8)).numpy()
        scale = attrs.get("center_scale", torch.ones(8)).numpy()
        want = np.maximum(((x - trans) @ rot.T) * scale @ _norm_rows(enc).T
                          + bias, 0.0)
        np.testing.assert_allclose(
            td.encode(td.center(torch.as_tensor(x))).numpy(), want,
            rtol=1e-4, atol=1e-5)
    _same(td, jd, x)


def test_baselines_topk_reverse_positive_and_lista(tmp_path):
    r = _rng(5)
    rnd = r.normal(size=(10, 6)).astype(np.float32)
    q, _ = np.linalg.qr(r.normal(size=(6, 6)))
    enc_pos = np.abs(r.normal(size=(10, 6))).astype(np.float32)
    layers = [{"W": torch.tensor(0.3 * r.normal(size=(10, 6)),
                                 dtype=torch.float32),
               "theta": torch.tensor(0.05 * r.normal(size=10),
                                     dtype=torch.float32),
               "rho": torch.tensor(0.2)} for _ in range(2)]
    rlayers = [{"W": torch.tensor(0.2 * r.normal(size=(10, 10)),
                                  dtype=torch.float32),
                "theta": torch.zeros(10)} for _ in range(2)]
    first = _ref_instance("TiedPositiveSAE", encoder=torch.tensor(enc_pos),
                          encoder_bias=torch.tensor(r.normal(size=10)
                                                    .astype(np.float32)),
                          norm_encoder=False, n_feats=10, activation_size=6)
    second = type(first).__new__(type(first))
    second.__dict__.update(first.__dict__, norm_encoder=True)
    pairs = [
        (_ref_instance("Identity", activation_size=6, n_feats=6), {}),
        (_ref_instance("IdentityReLU", activation_size=6, n_feats=6,
                       bias=torch.zeros(6)), {}),
        (_ref_instance("IdentityPositive", activation_size=6), {}),
        (_ref_instance("RandomDict", activation_size=6, n_feats=10,
                       encoder=torch.tensor(rnd),
                       encoder_bias=torch.zeros(10)), {}),
        (_ref_instance("Rotation", matrix=torch.tensor(q.astype(np.float32)),
                       activation_size=6), {}),
        (_ref_instance("TopKLearnedDict", dict=torch.tensor(
            _norm_rows(rnd)), sparsity=3, n_feats=10, activation_size=6), {}),
        (_ref_instance("ReverseSAE", encoder=torch.tensor(rnd),
                       encoder_bias=torch.zeros(10), norm_encoder=True,
                       n_feats=10, activation_size=6), {}),
        (first, {}), (second, {}),
        (_ref_instance("LISTADenoisingSAE", params={
            "decoder": torch.tensor(rnd), "encoder_layers": layers}), {}),
        (_ref_instance("ResidualDenoisingSAE", params={
            "dict": torch.tensor(rnd), "encoder_layers": rlayers,
            "encoder_bias": torch.zeros(10)}), {}),
        (_ref_instance("AddedNoise", activation_size=6,
                       noise_mag=torch.tensor(0.1)), {}),
    ]
    loaded = _both(_save_ref_artifact(tmp_path, pairs))
    assert [type(td).__name__ for td, _, _ in loaded] == [
        "Identity", "IdentityReLU", "IdentityPositive", "RandomDict",
        "Rotation", "TopKLearnedDict", "ReverseSAE", "UntiedSAE", "TiedSAE",
        "LISTADenoisingSAE", "ResidualDenoisingSAE", "AddedNoise"]
    x = r.normal(size=(4, 6)).astype(np.float32)
    for td, jd, _ in loaded[:-1]:
        _same(td, jd, x)
    assert loaded[5][0].k == 3
    # the converted AddedNoise holds jax.random.PRNGKey(0)'s words
    noise = loaded[-1][0]
    np.testing.assert_array_equal(noise.key.numpy(),
                                  np.asarray(loaded[-1][1].key))


@pytest.mark.parametrize("ref,match", [
    (lambda: _ref_instance("LISTADenoisingSAE", params={
        "decoder": torch.randn(8, 4), "encoder_layers": []}),
     "encoder_layers"),
    (lambda: _ref_instance("FrobnicatorDict", weights=torch.zeros(3, 3)),
     "FrobnicatorDict"),
], ids=["empty_lista", "unknown_class"])
def test_unconvertible_artifacts_fail_loudly(tmp_path, ref, match):
    path = _save_ref_artifact(tmp_path, [(ref(), {})])
    for loader in (tri, jri):
        with pytest.raises(NotImplementedError, match=match):
            loader.load_reference_learned_dicts(path)


def test_cross_framework_eval(tmp_path):
    r = _rng(6)
    enc = r.normal(size=(32, 16)).astype(np.float32)
    bias = r.normal(size=(32,)).astype(np.float32)
    ref = _ref_instance("TiedSAE", encoder=torch.tensor(enc),
                        encoder_bias=torch.tensor(bias), norm_encoder=True,
                        n_feats=32, activation_size=16)
    (td, jd, _), = _both(_save_ref_artifact(tmp_path, [(ref, {})]))
    native = tld.TiedSAE(dictionary=torch.tensor(enc),
                         encoder_bias=torch.tensor(bias))
    assert float(mmcs(td, native)) == pytest.approx(1.0, abs=1e-6)
    x = torch.as_tensor(r.normal(size=(256, 16)).astype(np.float32))
    assert float(fraction_variance_unexplained(td, x)) == pytest.approx(
        float(fraction_variance_unexplained(native, x)), rel=1e-5)


def test_malicious_pickle_rejected(tmp_path):
    class Evil:
        def __reduce__(self):
            import os

            return (os.system, ("echo pwned",))

    path = tmp_path / "learned_dicts.pt"
    with path.open("wb") as fh:
        pickle.dump([(Evil(), {})], fh)
    for loader in (tri, jri):
        with pytest.raises(Exception) as exc:
            loader.load_reference_learned_dicts(path)
        assert "allowlist" in str(exc.value) or isinstance(
            exc.value, pickle.UnpicklingError)


def test_storage_bytes_payload_rejected(tmp_path):
    """``torch.storage._load_from_bytes`` unpickles its bytes with
    unrestricted pickle, a second pickle inside the first: the port's
    allowlist names no such global, so a payload hidden there is refused
    and never runs. (The JAX package's unpickler lets this global through,
    so only the port's loader is run.)"""
    import io
    import os

    marker = tmp_path / "ran"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    inner = io.BytesIO()
    torch.save(Evil(), inner)

    class Planted:
        def __reduce__(self):
            return (torch.storage._load_from_bytes, (inner.getvalue(),))

    path = tmp_path / "learned_dicts.pt"
    with path.open("wb") as fh:
        pickle.dump([(Planted(), {})], fh)
    with pytest.raises(pickle.UnpicklingError, match="allowlist"):
        tri.load_reference_learned_dicts(path)
    assert not marker.exists()


def test_legacy_torch_format_loads(tmp_path):
    """A reference file in torch's legacy (pre-zip) format loads through
    both loaders to the same dict: neither torch.save format needs a
    global beyond the allowlist."""
    from test_ref_interop import _ref_modules_visible

    r = _rng(7)
    enc, dec = (r.normal(size=(12, 8)).astype(np.float32) for _ in "ab")
    bias = r.normal(size=(12,)).astype(np.float32)
    ref = _ref_instance("UntiedSAE", encoder=torch.tensor(enc),
                        decoder=torch.tensor(dec),
                        encoder_bias=torch.tensor(bias), n_feats=12,
                        activation_size=8)
    path = tmp_path / "learned_dicts.pt"
    with _ref_modules_visible(ref):
        torch.save([(ref, {"l1_alpha": torch.tensor(1e-3)})], path,
                   _use_new_zipfile_serialization=False)
    (td, jd, hyper), = _both(path)
    assert isinstance(td, tld.UntiedSAE)
    assert hyper["l1_alpha"] == pytest.approx(1e-3)
    np.testing.assert_allclose(td.encoder.numpy(), enc)
    _same(td, jd, r.normal(size=(5, 8)).astype(np.float32))


def test_export_roundtrip_sanitizes_and_restores_classes(tmp_path):
    """The port's dicts exported in the reference layout load back through
    both loaders with equal fields and encodes; tensor hyperparams become
    plain scalars at any depth; a real class the export shadowed
    survives it; a class the reference cannot hold raises."""
    r = _rng(8)
    a = lambda *s: torch.tensor(r.normal(size=s).astype(np.float32))
    dicts = [tld.UntiedSAE(encoder=a(10, 6), encoder_bias=a(10),
                           dictionary=a(10, 6)),
             tld.TiedSAE(dictionary=a(10, 6), encoder_bias=a(10),
                         centering_trans=a(6)),
             tld.TiedCenteredSAE(dictionary=a(10, 6), encoder_bias=a(10),
                                 centering_trans=a(6)),
             tld.ReverseSAE(dictionary=a(10, 6), encoder_bias=a(10)),
             tld.TopKLearnedDict(dictionary=a(10, 6), k=3)]
    hyper = {"l1_alpha": torch.tensor(1e-3), "dict_size": 10,
             "schedule": {"lr": np.float32(3e-4)}, "tags": [torch.tensor(2.0),
                                                           "a"]}
    real_cls = type("TiedSAE", (), {"marker": "real"})
    pkg = types.ModuleType("autoencoders")
    mod = types.ModuleType("autoencoders.learned_dict")
    mod.TiedSAE, pkg.learned_dict = real_cls, mod
    sys.modules["autoencoders"], sys.modules[mod.__name__] = pkg, mod
    try:
        tri.export_reference_learned_dicts([(d, hyper) for d in dicts],
                                           tmp_path / "exp.pt")
        assert sys.modules["autoencoders.learned_dict"].TiedSAE is real_cls
        assert sys.modules["autoencoders"].learned_dict is mod
    finally:
        sys.modules.pop("autoencoders", None)
        sys.modules.pop("autoencoders.learned_dict", None)
    loaded = _both(tmp_path / "exp.pt")
    x = r.normal(size=(5, 6)).astype(np.float32)
    for d, (td, jd, h) in zip(dicts, loaded):
        assert isinstance(h["l1_alpha"], float)
        assert isinstance(h["schedule"]["lr"], float)
        assert isinstance(h["tags"][0], float) and h["tags"][1] == "a"
        np.testing.assert_allclose(td.encode(torch.as_tensor(x)).numpy(),
                                   d.encode(torch.as_tensor(x)).numpy(),
                                   rtol=1e-6, atol=1e-6)
        _same(td, jd, x)
    with pytest.raises(NotImplementedError, match="RICADict|Identity"):
        tri.export_reference_learned_dicts(
            [(tld.Identity.create(6), {})], tmp_path / "bad.pt")


def _write_pt_chunks(folder, arrays):
    folder.mkdir(parents=True, exist_ok=True)
    for i, arr in enumerate(arrays):
        torch.save(torch.tensor(arr), folder / f"{i}.pt")


def test_chunkstore_reads_pt_folder_and_imports(tmp_path):
    r = _rng(7)
    chunks = [r.normal(size=(40, 12)).astype(np.float16) for _ in range(3)]
    src = tmp_path / "ref_chunks"
    _write_pt_chunks(src, chunks)
    store = ChunkStore(src)
    assert (store.format, store.n_chunks, store.activation_dim) == \
        ("pt", 3, 12)
    np.testing.assert_allclose(store.load_chunk(1),
                               chunks[1].astype(np.float32))
    got = list(store.chunk_reader([2, 0]))
    np.testing.assert_allclose(got[0], chunks[2].astype(np.float32))
    batches = list(store.epoch(batch_size=16, rng=_rng(0)))
    assert len(batches) == 3 * (40 // 16)
    assert store.load_chunk(0, dtype=torch.bfloat16).dtype == torch.bfloat16
    assert tri.import_reference_chunks(src, tmp_path / "native") == 3
    native = ChunkStore(tmp_path / "native")
    assert native.format == "npy" and native.meta["format"] == "pt-import"
    for i in range(3):
        np.testing.assert_allclose(native.load_chunk(i),
                                   chunks[i].astype(np.float32))


def test_read_pt_chunk_flattens_sequence_dims(tmp_path):
    t = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    torch.save(torch.tensor(t), tmp_path / "0.pt")
    out = tri.read_pt_chunk(tmp_path / "0.pt")
    assert out.shape == (2, 12)
    np.testing.assert_array_equal(out, jri.read_pt_chunk(tmp_path / "0.pt"))
