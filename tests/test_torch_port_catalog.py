"""The port's feature catalog (sparse_coding_tpu_torch/catalog/build.py,
query.py; utils/trees.py) against the JAX package's, on the same
artifacts (written by the JAX package) and the same chunk store.

Tolerances, build against the JAX build (numpy encodes on the host
against torch's on the build's device, here the CPU):
- dead flags and the index metadata (but the digests) equal;
- activation counts (frequency × rows) equal but for one ReLU flip per
  million codes (a pre-activation within rounding of 0);
- mean magnitudes within 1e-5 of max|ref|; decoder rows, MMCS and match
  cosines within 1e-6; match indices equal but at near-ties (a partner
  whose cosine lies within 1e-6 of the best);
- the query ops: values within 1e-6, indices equal (a planted tie
  included), votes equal.
Within the port a build is byte-identical, across a SIGKILL at
``catalog.finalize`` too.
"""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.catalog import build as jbuild
from sparse_coding_tpu.catalog import query as jquery
from sparse_coding_tpu.data.chunk_store import ChunkWriter
from sparse_coding_tpu.models.learned_dict import (
    RandomDict as JRandomDict,
    TiedSAE as JTiedSAE,
    TopKLearnedDict as JTopK,
    UntiedSAE as JUntiedSAE,
)
from sparse_coding_tpu.utils import trees as jtrees
from sparse_coding_tpu.utils.artifacts import save_learned_dicts
from sparse_coding_tpu_torch.catalog import build, query
from sparse_coding_tpu_torch.models import TiedSAE, UntiedSAE
from sparse_coding_tpu_torch.utils import trees
from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

REPO = Path(__file__).resolve().parents[1]
D, N = 16, 32
DEAD_FEAT = 7  # bias-silenced in dict 0: never fires
TWIN_OF = 3    # dict 0's DEAD_FEAT row duplicates its TWIN_OF row
FLIPS_PER_CODE = 1e-6
MAG_TOL, COS_TOL = 1e-5, 1e-6


def _tied(seed, silence_dead=False):
    r = np.random.default_rng(seed)
    d = r.normal(size=(N, D)).astype(np.float32)
    bias = (r.normal(size=(N,)) * 0.1).astype(np.float32)
    if silence_dead:
        d[DEAD_FEAT] = d[TWIN_OF]
        bias[DEAD_FEAT] = -1000.0
    return JTiedSAE(dictionary=jnp.asarray(d), encoder_bias=jnp.asarray(bias))


def _untied(seed):
    r = np.random.default_rng(seed)
    return JUntiedSAE(
        encoder=jnp.asarray(r.normal(size=(N, D)).astype(np.float32)),
        encoder_bias=jnp.asarray((r.normal(size=(N,)) * 0.1).astype(
            np.float32)),
        dictionary=jnp.asarray(r.normal(size=(N, D)).astype(np.float32)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A JAX-written artifact set (a diverged member among them), a
    3-chunk store, and the JAX build and the port's over both."""
    base = tmp_path_factory.mktemp("port_catalog")
    rng = np.random.default_rng(0)
    w = ChunkWriter(base / "chunks", D,
                    chunk_size_gb=D * 128 * 4 / 2**30, dtype="float32")
    w.add(rng.normal(size=(384, D)).astype(np.float32))
    w.finalize()
    pkl = base / "sweep" / "learned_dicts.pkl"
    save_learned_dicts(
        [(_tied(1, silence_dead=True), {"l1_alpha": 1e-3}),
         (_tied(2), {"l1_alpha": 3e-3}),
         (_untied(4), {"l1_alpha": 1e-3}),
         (_tied(9), {"l1_alpha": 1.0, "diverged": True})], pkl)
    jbuild.build_catalog(pkl, base / "chunks", base / "jcat", experiment="t")
    build.build_catalog(pkl, base / "chunks", base / "tcat", experiment="t",
                        device="cpu")
    return base


def _digests(folder: Path) -> dict[str, str]:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(folder).iterdir())}


def _near_tie(rows, i, dict_got, feat_got, dict_ref, feat_ref, f):
    """The port's partner is within COS_TOL of the reference's best."""
    a = rows[i][f]
    return abs(float(a @ rows[dict_got][feat_got])
               - float(a @ rows[dict_ref][feat_ref])) <= COS_TOL


def assert_index_close(got_dir: Path, ref_dir: Path) -> None:
    """A port-built catalog against a JAX-built one, at the tolerances of
    the module docstring."""
    got = build.CatalogIndex.load(got_dir, verify=True)
    ref = jbuild.CatalogIndex.load(ref_dir, verify=True)
    gm = {k: v for k, v in got.meta.items() if k != "files"}
    rm = {k: v for k, v in ref.meta.items() if k != "files"}
    assert gm == rm
    assert sorted(got.meta["files"]) == sorted(ref.meta["files"])
    rows_total, codes = ref.meta["n_rows"], 0
    flips = 0
    for i in range(ref.n_dicts):
        np.testing.assert_array_equal(got.dead(i), ref.dead(i))
        np.testing.assert_allclose(got.rows(i), ref.rows(i), atol=COS_TOL)
        cg = np.rint(got.freq(i).astype(np.float64) * rows_total)
        cr = np.rint(ref.freq(i).astype(np.float64) * rows_total)
        flips += int(np.abs(cg - cr).sum())
        codes += rows_total * got.rows(i).shape[0]
        assert np.abs(got.mag(i) - ref.mag(i)).max() <= MAG_TOL * max(
            float(np.abs(ref.mag(i)).max()), 1e-30)
        for s in ("match_dict", "match_feat", "match_cos"):
            assert got._arr(i, s).dtype == ref._arr(i, s).dtype, s
        np.testing.assert_allclose(got._arr(i, "match_cos"),
                                   ref._arr(i, "match_cos"), atol=COS_TOL)
        gd, gf = got._arr(i, "match_dict"), got._arr(i, "match_feat")
        rd, rf = ref._arr(i, "match_dict"), ref._arr(i, "match_feat")
        for f in np.nonzero((gd != rd) | (gf != rf))[0]:
            assert _near_tie([ref.rows(k) for k in range(ref.n_dicts)], i,
                             gd[f], gf[f], rd[f], rf[f], f), (i, f)
    assert flips <= FLIPS_PER_CODE * codes, flips
    np.testing.assert_allclose(got.mmcs_matrix(), ref.mmcs_matrix(),
                               atol=COS_TOL)
    assert got.mmcs_matrix().dtype == ref.mmcs_matrix().dtype


def test_build_matches_jax(corpus):
    assert_index_close(corpus / "tcat", corpus / "jcat")
    assert sorted(_digests(corpus / "tcat")) == sorted(
        _digests(corpus / "jcat"))


def test_two_builds_byte_identical(corpus, tmp_path):
    build.build_catalog(corpus / "sweep" / "learned_dicts.pkl",
                        corpus / "chunks", tmp_path / "again",
                        experiment="t", device="cpu")
    assert _digests(tmp_path / "again") == _digests(corpus / "tcat")


_KILLED_BUILD = r"""
import sys
from sparse_coding_tpu_torch.catalog.build import build_catalog
build_catalog(sys.argv[1], sys.argv[2], sys.argv[3], experiment="t",
              device="cpu")
"""


def test_kill_at_finalize_then_rebuild_byte_identical(corpus, tmp_path):
    """A SIGKILL at ``catalog.finalize`` leaves every array and no
    index.json; the rebuild over that directory is the clean build, bit
    for bit."""
    from conftest import stripped_cpu_subprocess_env

    out = tmp_path / "killed"
    env = stripped_cpu_subprocess_env()
    env["SPARSE_CODING_CRASH_PLAN"] = "catalog.finalize:nth=1"
    proc = subprocess.run(
        [sys.executable, "-c", _KILLED_BUILD,
         str(corpus / "sweep" / "learned_dicts.pkl"), str(corpus / "chunks"),
         str(out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert not (out / "index.json").exists()
    assert (out / "mmcs.npy").exists()
    with pytest.raises(FileNotFoundError, match="incomplete build"):
        build.CatalogIndex.load(out)
    build.build_catalog(corpus / "sweep" / "learned_dicts.pkl",
                        corpus / "chunks", out, experiment="t", device="cpu")
    assert _digests(out) == _digests(corpus / "tcat")


def test_index_schema_and_digest_verify(corpus, tmp_path):
    meta = json.loads((corpus / "tcat" / "index.json").read_text())
    assert meta["version"] == 1 and meta["n_rows"] == 384
    assert meta["quarantined_chunks"] == []
    shutil.copytree(corpus / "tcat", tmp_path / "torn")
    victim = tmp_path / "torn" / "d000_freq.npy"
    arr = np.load(victim)
    arr[0] += 1
    np.save(victim, arr)
    build.CatalogIndex.load(tmp_path / "torn")
    with pytest.raises(build.CatalogBuildError, match="digest"):
        build.CatalogIndex.load(tmp_path / "torn", verify=True)
    stats = build.CatalogIndex.load(corpus / "tcat").feature_stats(1, 4)
    ref = jbuild.CatalogIndex.load(corpus / "jcat").feature_stats(1, 4)
    assert stats.keys() == ref.keys()
    assert {k: stats[k] for k in ("dict", "feature", "dead")} == \
        {k: ref[k] for k in ("dict", "feature", "dead")}


def test_quarantined_chunk_skipped_like_jax(corpus, tmp_path):
    store = tmp_path / "chunks"
    shutil.copytree(corpus / "chunks", store)
    rot = np.random.default_rng(5).normal(size=(128, D)).astype(np.float32)
    np.save(store / "1.npy", rot)  # a digest mismatch: quarantined
    pkl = corpus / "sweep" / "learned_dicts.pkl"
    jstore = tmp_path / "jchunks"
    shutil.copytree(store, jstore)
    meta = build.build_catalog(pkl, store, tmp_path / "t1", experiment="t",
                               device="cpu")
    assert meta["quarantined_chunks"] == [1]
    assert meta["n_rows"] == 256 and meta["n_chunks_read"] == 2
    jbuild.build_catalog(pkl, jstore, tmp_path / "j", experiment="t")
    assert_index_close(tmp_path / "t1", tmp_path / "j")
    build.build_catalog(pkl, store, tmp_path / "t2", experiment="t",
                        device="cpu")
    assert _digests(tmp_path / "t1") == _digests(tmp_path / "t2")


def test_diverged_dropped_and_dead_never_matched(corpus):
    meta = json.loads((corpus / "tcat" / "index.json").read_text())
    assert meta["dropped_diverged"] == 1 and len(meta["dicts"]) == 3
    recs = build.load_catalog_records(corpus / "sweep" / "learned_dicts.pkl")
    assert len(recs) == 3
    assert len(build.load_catalog_records(
        corpus / "sweep" / "learned_dicts.pkl", skip_diverged=False)) == 4
    index = build.CatalogIndex.load(corpus / "tcat")
    dead0 = index.dead(0)
    assert bool(dead0[DEAD_FEAT]) and index.freq(0)[DEAD_FEAT] == 0.0
    assert meta["dicts"][0]["n_dead"] == int(dead0.sum())
    for i in range(1, index.n_dicts):
        hits = index._arr(i, "match_feat")[index._arr(i, "match_dict") == 0]
        assert not dead0[hits].any()


def test_group_labels_match_jax(corpus, tmp_path):
    pkl = corpus / "sweep" / "learned_dicts.pkl"
    base = tmp_path / "baseline.pkl"
    save_learned_dicts([(_tied(7), {"l1_alpha": 1e-3})], base)
    pairs = [(pkl, "group-000"), (base, None)]
    got = build.build_catalog(pairs, corpus / "chunks", tmp_path / "t",
                              experiment="t", device="cpu")
    ref = jbuild.build_catalog(pairs, corpus / "chunks", tmp_path / "j",
                               experiment="t")
    assert [d["group"] for d in got["dicts"]] == \
        [d["group"] for d in ref["dicts"]] == ["group-000"] * 3 + [None]
    assert_index_close(tmp_path / "t", tmp_path / "j")
    mm = build.CatalogIndex.load(tmp_path / "t").mmcs_matrix()
    rows_g = build.decoder_rows_np(build.load_catalog_records(pkl)[0])
    rows_b = build.decoder_rows_np(build.load_catalog_records(base)[0])
    assert mm[0, 3] == np.float32(build.mmcs_np(rows_b, rows_g))
    meta = build.build_catalog(pkl, corpus / "chunks", tmp_path / "g",
                               experiment="t", group="group-001",
                               device="cpu")
    assert all(d["group"] == "group-001" for d in meta["dicts"])


def _records(dicts, tmp_path):
    pkl = tmp_path / "learned_dicts.pkl"
    save_learned_dicts(dicts, pkl)
    return build.load_catalog_records(pkl, skip_diverged=False)


def test_encode_np_matches_jax_for_each_class(tmp_path):
    x = np.random.default_rng(3).normal(size=(8, D)).astype(np.float32)
    dicts = [
        (_tied(1, silence_dead=True), {}),
        (_untied(4), {}),
        (JRandomDict(dictionary=jnp.asarray(np.random.default_rng(6).normal(
            size=(N, D)).astype(np.float32))), {}),
        (JTopK(dictionary=jnp.asarray(np.random.default_rng(7).normal(
            size=(N, D)).astype(np.float32)), k=4), {}),
    ]
    for (ld, _), rec in zip(dicts, _records(dicts, tmp_path)):
        got = build.encode_np(rec, x)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, jbuild.encode_np(rec, x), rtol=1e-5,
                                   atol=1e-5, err_msg=rec["cls"])
        np.testing.assert_allclose(got, np.asarray(ld.encode(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5, err_msg=rec["cls"])
        np.testing.assert_allclose(build.decoder_rows_np(rec),
                                   jbuild.decoder_rows_np(rec), atol=1e-6)
    rows = [build.decoder_rows_np(r) for r in _records(dicts, tmp_path)]
    assert abs(build.mmcs_np(rows[0], rows[1])
               - jbuild.mmcs_np(rows[0], rows[1])) <= COS_TOL


def test_encode_np_unsupported_class_is_typed():
    with pytest.raises(build.CatalogBuildError, match="no catalog encode"):
        build.encode_np({"cls": "Lista", "fields": {}, "static": {}},
                        np.ones((1, D), np.float32))
    with pytest.raises(build.CatalogBuildError, match="no decoder matrix"):
        build.decoder_rows_np({"cls": "Lista", "fields": {}, "static": {}})


def test_build_refuses_empty_inputs(corpus, tmp_path):
    pkl = tmp_path / "all_diverged.pkl"
    save_learned_dicts([(_tied(9), {"diverged": True})], pkl)
    with pytest.raises(build.CatalogBuildError, match="no non-diverged"):
        build.build_catalog(pkl, corpus / "chunks", tmp_path / "o",
                            device="cpu")
    with pytest.raises(build.CatalogBuildError, match="empty artifact list"):
        build.build_catalog([], corpus / "chunks", tmp_path / "o",
                            device="cpu")


# -- the query ops and the trees ---------------------------------------------------


def _pair(seed, n=N, d=D, twins=()):
    r = np.random.default_rng(seed)
    w = r.normal(size=(n, d)).astype(np.float32)
    for a, b in twins:
        w[b] = w[a]  # equal rows: tied similarities
    b_ = (r.normal(size=n) * 0.1).astype(np.float32)
    return (JTiedSAE(dictionary=jnp.asarray(w), encoder_bias=jnp.asarray(b_)),
            TiedSAE(dictionary=torch.from_numpy(w),
                    encoder_bias=torch.from_numpy(b_)))


def test_neighbor_topk_with_a_tie_matches_jax():
    """Rows 3 and 11 are equal (and 5, 20, 27), so every query ties them:
    the lower index comes first on both sides."""
    jd, td = _pair(1, twins=((3, 11), (5, 20), (5, 27)))
    x = np.random.default_rng(2).normal(size=(12, D)).astype(np.float32)
    x[0] = np.asarray(jd.get_learned_dict())[3]  # its own row at the top
    for k in (1, 4, 9):
        got = query.neighbor_topk(td, torch.from_numpy(x), k)
        ref = jquery.neighbor_topk(jd, jnp.asarray(x), k)
        gv, gi = query.unpack_neighbors(got)
        rv, ri = jquery.unpack_neighbors(ref)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gv, rv, atol=COS_TOL)
        assert gi.dtype == np.int32 and got.shape == (12, 2 * k)
    gi = query.unpack_neighbors(query.neighbor_topk(td, torch.from_numpy(x),
                                                    2))[1]
    assert gi[0].tolist() == [3, 11]


def test_union_vote_matches_jax():
    pairs = [_pair(s) for s in (3, 4, 5, 6)]
    x = np.random.default_rng(7).normal(size=(10, D)).astype(np.float32)
    got = query.union_vote(trees.stack_trees([t for _, t in pairs]),
                           torch.from_numpy(x))
    ref = jquery.union_vote(jtrees.stack_trees([j for j, _ in pairs]),
                            jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.float32 and got.max() <= 4


def test_trees_match_jax():
    pairs = [_pair(s, n=6, d=4) for s in (8, 9, 10)]
    tstack = trees.stack_trees([t for _, t in pairs])
    jstack = jtrees.stack_trees([j for j, _ in pairs])
    np.testing.assert_array_equal(tstack.dictionary.numpy(),
                                  np.asarray(jstack.dictionary))
    assert trees.tree_len(tstack) == jtrees.tree_len(jstack) == 3
    assert trees.tree_bytes(tstack) == jtrees.tree_bytes(jstack)
    for i, member in enumerate(trees.unstack_tree(tstack)):
        assert torch.equal(member.dictionary, pairs[i][1].dictionary)
        assert torch.equal(trees.tree_index(tstack, i).encoder_bias,
                           pairs[i][1].encoder_bias)
    nested = {"a": [torch.ones(2), torch.zeros(2, dtype=torch.int32)],
              "k": 4}
    cast = trees.tree_cast(trees.stack_trees([nested, nested]),
                           torch.float64)
    assert cast["a"][0].dtype == torch.float64 and cast["k"] == 4
    assert cast["a"][1].dtype == torch.int32 and cast["a"][0].shape == (2, 2)
    with pytest.raises(ValueError, match="empty"):
        trees.stack_trees([])
    with pytest.raises(ValueError, match="static"):
        trees.stack_trees([nested, {**nested, "k": 5}])


def test_place_catalog_rows_names_the_multi_gpu_item():
    """Catalog rows split over the mesh's model axis (the multi-GPU
    slice): each model shard keeps its block of rows, as the JAX
    placement's CATALOG_FEATURE_RULES put them."""
    from sparse_coding_tpu_torch.parallel.mesh import Mesh

    rows = torch.arange(8.0).reshape(4, 2)
    first = query.place_catalog_rows(rows, Mesh(2, 1, "cpu"))
    assert torch.equal(first, rows[:2])
    assert torch.equal(query.place_catalog_rows(rows, Mesh(1, 1, "cpu")),
                       rows)


def test_port_loads_the_jax_artifact_it_catalogs(corpus):
    """The catalog's raw records and the port's dicts agree: the decoder
    rows the index stores are the loaded dicts' normalized rows."""
    lds = load_learned_dicts(corpus / "sweep" / "learned_dicts.pkl",
                             skip_diverged=True)
    index = build.CatalogIndex.load(corpus / "tcat")
    for i, (ld, _) in enumerate(lds):
        np.testing.assert_allclose(index.rows(i),
                                   ld.get_learned_dict().numpy(), atol=1e-7)
    assert isinstance(lds[2][0], UntiedSAE)
