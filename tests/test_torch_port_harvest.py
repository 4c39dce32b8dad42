"""The port's harvest path against the JAX package's, on the CPU: chunk
folders harvested from the same tiny LM weights and token rows
(``data/harvest.py``), the ChunkWriter's resume and abort, tokenizer
packing (``data/tokenize.py``) and store scrubs (``data/scrub.py``); then
the ensemble kernels' lifted width: ``choose_plan`` at LM widths and the
CPU twin of ``train_step_tiled`` at d=1024 against the JAX step.

Tolerances: float32 chunks within 1e-5 of max|ref| (the two forwards sum
in other orders), bf16 and float16 chunks each value within one ulp of
its dtype more, meta.json fields equal and digests equal wherever the
arrays are bitwise equal;
tokenizer arrays, scrub reports and worklists exactly equal; the d=1024
step at the JAX package's fused-vs-autodiff bound, rtol 2e-4."""

import json
import shutil
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sparse_coding_tpu.data import chunk_store as jchunk
from sparse_coding_tpu.data import harvest as jharvest
from sparse_coding_tpu.data import scrub as jscrub
from sparse_coding_tpu.data import tokenize as jtok
from sparse_coding_tpu.ensemble import Ensemble as JaxEnsemble
from sparse_coding_tpu.lm import gptneox as jneox
from sparse_coding_tpu.lm.model_config import tiny_test_config
from sparse_coding_tpu.models.sae import FunctionalSAE as JaxSAE
from sparse_coding_tpu.models.sae import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding_tpu_torch.config import DataArgs
from sparse_coding_tpu_torch.data import chunk_store, harvest, scrub
from sparse_coding_tpu_torch.data import shard_store, tokenize
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.lm import convert, gptneox
from sparse_coding_tpu_torch.models.sae import FunctionalSAE, FunctionalTiedSAE
from sparse_coding_tpu_torch.ops import _build, roofline
from sparse_coding_tpu_torch.utils.carry import members_from_numpy
from torch_port_helpers import batches

SEQ, MB = 16, 4  # context and model batch
ROWS_PER_CHUNK = 3 * MB * SEQ  # 3 model batches a chunk
SIDES = {"jax": jharvest.harvest_activations,
         "port": harvest.harvest_activations}


@pytest.fixture(scope="module")
def lm():
    """(cfg, JAX params, port params): the JAX package's tiny GPT-NeoX,
    carried to the port."""
    cfg = tiny_test_config("gptneox")
    jp = jneox.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, convert.params_from_numpy(jax.device_get(jp),
                                              device="cpu")


def _rows(cfg, n=28, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(n, SEQ))


def _gb(width, itemsize, rows=ROWS_PER_CHUNK):
    return rows * width * itemsize / 2**30


def _run(side, lm, out, rows, **kw):
    cfg, jp, tp = lm
    kw.setdefault("model_batch_size", MB)
    if side == "port":
        kw["device"] = "cpu"
    return SIDES[side](jp if side == "jax" else tp, cfg, rows,
                       output_folder=out, **kw)


def _raw(folder: Path, i: int) -> np.ndarray:
    return np.load(folder / f"{i}.npy")


# explicit mantissa bits of the half-width chunk dtypes
MANTISSA = {"bfloat16": 7, "float16": 10}


def _decode(raw: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        return chunk_store._from_bf16_bits(raw)
    return raw.astype(np.float32)


def _chunks_close(a_raw: np.ndarray, b_raw: np.ndarray, dtype: str) -> None:
    """Two chunks of the same activations that the two forwards summed in
    other orders: within 1e-5 of max|ref| (float32), and a half-width
    chunk's values each within one ulp of its dtype more — rounding moves
    each side by at most half an ulp."""
    a, b = _decode(a_raw, dtype), _decode(b_raw, dtype)
    tol = 1e-5 * np.abs(a).max()
    if dtype in MANTISSA:
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
        tol = tol + np.exp2(np.floor(np.log2(mag)) - MANTISSA[dtype])
    assert np.all(np.abs(a - b) <= tol), float(np.abs(a - b).max())


def _assert_folders_match(jdir: Path, tdir: Path, dtype: str) -> None:
    jmeta = json.loads((jdir / "meta.json").read_text())
    tmeta = json.loads((tdir / "meta.json").read_text())
    jd, td = jmeta.pop("chunk_digests"), tmeta.pop("chunk_digests")
    assert tmeta == jmeta
    assert set(td) == set(jd) and len(jd) == jmeta["n_chunks"]
    for i in range(jmeta["n_chunks"]):
        a, b = _raw(jdir, i), _raw(tdir, i)
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.array_equal(a, b):
            assert td[str(i)] == jd[str(i)], i
        else:
            _chunks_close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_folders_match_jax(tmp_path, lm, dtype):
    """Two taps (mlp at d_mlp, residual at d_model) of two layers, three
    chunks and a short tail chunk: the same folders on both sides."""
    rows = _rows(lm[0], n=28)
    itemsize = 4 if dtype == "float32" else 2
    for loc, width in (("mlp", lm[0].d_mlp), ("residual", lm[0].d_model)):
        got = {side: _run(side, lm, tmp_path / side / loc, rows,
                          layers=[0, 2], layer_loc=loc, dtype=dtype,
                          chunk_size_gb=_gb(width, itemsize))
               for side in SIDES}
        assert got["port"] == got["jax"] == {f"{loc}.0": 3, f"{loc}.2": 3}
        for tap in got["jax"]:
            _assert_folders_match(tmp_path / "jax" / loc / tap,
                                  tmp_path / "port" / loc / tap, dtype)
        meta = json.loads((tmp_path / "port" / loc / f"{loc}.2"
                           / "meta.json").read_text())
        assert (meta["model"], meta["layer_loc"], meta["tap"],
                meta["layer"]) == ("gptneox", loc, f"{loc}.2", 2)


def test_centering_matches_jax(tmp_path, lm):
    """center=True subtracts the first chunk's mean inside the writer, as
    the JAX harvest does; center.npy and the chunks agree."""
    rows = _rows(lm[0], n=24, seed=1)
    kw = dict(layers=[1], layer_loc="residual", dtype="float32",
              center=True, chunk_size_gb=_gb(lm[0].d_model, 4))
    for side in SIDES:
        _run(side, lm, tmp_path / side, rows, **kw)
    jdir, tdir = (tmp_path / s / "residual.1" for s in ("jax", "port"))
    _assert_folders_match(jdir, tdir, "float32")
    jc, tc = np.load(jdir / "center.npy"), np.load(tdir / "center.npy")
    assert np.abs(tc - jc).max() <= 1e-5 * np.abs(jc).max()
    first = chunk_store.ChunkStore(tdir).load_chunk(0)
    assert np.abs(first.mean(axis=0)).max() < 1e-5


def test_skip_chunks_resume_and_n_chunks_cap(tmp_path, lm):
    """n_chunks caps in whole batches (a scan window that would cross the
    cap stops at it); a skip_chunks resume of that store writes the rest
    bitwise equal to one uninterrupted harvest, meta.json included, and
    so does a resume after a crash before finalize (no meta.json: the kept
    chunks' digests are recomputed from their files)."""
    rows = _rows(lm[0], n=28, seed=2)
    kw = dict(layers=[1], layer_loc="mlp", dtype="bfloat16",
              chunk_size_gb=_gb(lm[0].d_mlp, 2))
    _run("port", lm, tmp_path / "whole", rows, **kw)
    for k in (1, 4):
        capped = _run("port", lm, tmp_path / f"cap{k}", rows, n_chunks=1,
                      scan_batches=k, **kw)
        assert capped == {"mlp.1": 1}
    ref = tmp_path / "whole" / "mlp.1"
    for k in (1, 4):
        d = tmp_path / f"cap{k}" / "mlp.1"
        assert np.array_equal(_raw(d, 0), _raw(ref, 0))
        assert not (d / "1.npy").exists()
    _run("port", lm, tmp_path / "cap1", rows, skip_chunks=1, **kw)
    (tmp_path / "cap4" / "mlp.1" / "meta.json").unlink()  # the crash
    _run("port", lm, tmp_path / "cap4", rows, skip_chunks=1, **kw)
    for k in (1, 4):
        d = tmp_path / f"cap{k}" / "mlp.1"
        assert (d / "meta.json").read_bytes() == (ref / "meta.json").read_bytes()
        for i in range(3):
            assert np.array_equal(_raw(d, i), _raw(ref, i)), (k, i)
    # the JAX harvest resumes the same way
    _run("jax", lm, tmp_path / "jcap", rows, n_chunks=1, **kw)
    _run("jax", lm, tmp_path / "jcap", rows, skip_chunks=1, **kw)
    _assert_folders_match(tmp_path / "jcap" / "mlp.1", ref, "bfloat16")


def test_scan_batches_bit_identical(tmp_path, lm):
    """scan_batches=3 over 7 model batches (two windows, then a tail of
    one batch) writes the folders of scan_batches=1 bit for bit."""
    rows = _rows(lm[0], n=28, seed=3)
    kw = dict(layers=[0, 1], layer_loc="attn_concat", dtype="float16",
              chunk_size_gb=_gb(lm[0].d_model, 2, rows=4 * MB * SEQ))
    for k in (1, 3):
        _run("port", lm, tmp_path / f"k{k}", rows, scan_batches=k, **kw)
    for tap in ("attn_concat.0", "attn_concat.1"):
        a, b = tmp_path / "k1" / tap, tmp_path / "k3" / tap
        assert (a / "meta.json").read_bytes() == (b / "meta.json").read_bytes()
        for i in range(2):
            assert np.array_equal(_raw(a, i), _raw(b, i))


def test_abort_leaves_whole_chunks_and_no_meta(tmp_path, lm, monkeypatch):
    """A forward that fails at its 5th batch: the exception propagates,
    each tap's folder keeps its whole chunks and no meta.json or
    temporary file — on one device and on the mesh path (a 1 × 1 CPU
    mesh, its sequence-parallel forward failing the same way)."""
    from sparse_coding_tpu_torch.lm import long_context
    from sparse_coding_tpu_torch.parallel.mesh import make_mesh

    rows = _rows(lm[0], n=28, seed=4)

    def failing_at_5(real):
        calls = []

        def failing(*args, **kw):
            calls.append(1)
            if len(calls) == 5:
                raise RuntimeError("forward failed")
            return real(*args, **kw)
        return failing

    monkeypatch.setattr(long_context, "sequence_parallel_forward",
                        failing_at_5(long_context.sequence_parallel_forward))
    for out, kw in ((tmp_path, {"forward": failing_at_5(gptneox.forward)}),
                    (tmp_path / "m", {"mesh": make_mesh(1, 1,
                                                        device="cpu")})):
        with pytest.raises(RuntimeError, match="forward failed"):
            _run("port", lm, out, rows, layers=[1], layer_loc="residual",
                 dtype="float16", chunk_size_gb=_gb(lm[0].d_model, 2), **kw)
        folder = out / "residual.1"
        assert not (folder / "meta.json").exists()
        assert sorted(p.name for p in folder.iterdir()) == ["0.npy"]
        assert _raw(folder, 0).shape == (ROWS_PER_CHUNK, lm[0].d_model)


def test_chunk_writer_resume_and_abort_as_jax(tmp_path):
    """ChunkWriter's start_index, round_rows_to and abort() keep the JAX
    writer's semantics: the same rows a chunk, the inherited digests, a
    centered resume that needs center.npy, abort() sweeping tmp files."""
    data = np.random.default_rng(5).normal(size=(300, 8)).astype(np.float32)
    gb = 8 * 100 * 2 / 2**30
    for side, cs in (("jax", jchunk), ("port", chunk_store)):
        w = cs.ChunkWriter(tmp_path / side, 8, chunk_size_gb=gb,
                           dtype="float16", round_rows_to=64)
        assert w.rows_per_chunk == 64
        w.add(data)
        w.finalize()
        r = cs.ChunkWriter(tmp_path / side, 8, chunk_size_gb=gb,
                           dtype="float16", round_rows_to=64, start_index=2)
        assert r.chunk_index == 2
        r.add(data[128:])
        r.finalize({"resumed": True})
        with pytest.raises(ValueError, match="center.npy"):
            cs.ChunkWriter(tmp_path / side, 8, chunk_size_gb=gb,
                           dtype="float16", start_index=1, center=True)
        a = cs.ChunkWriter(tmp_path / f"{side}_abort", 8, chunk_size_gb=gb,
                           dtype="float16")
        a.add(data[:10])
        (tmp_path / f"{side}_abort" / ".0.npy.tmp.123").write_bytes(b"x")
        a.abort()
        assert not (tmp_path / f"{side}_abort" / "meta.json").exists()
    for name in ("meta.json", *(f"{i}.npy" for i in range(5))):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    for side in SIDES:
        assert not list((tmp_path / f"{side}_abort").glob(".*.tmp.*"))


# --- tokenize -----------------------------------------------------------------

class _CharTokenizer:
    eos_token_id = 0

    def encode(self, text):
        return [ord(c) % 100 + 1 for c in text]


TEXTS = ["hello world", "foo bar baz", "the quick brown fox jumps",
         "über straße", "", "x" * 40]


def test_pack_and_tokenize_match_jax():
    lists = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [], [10] * 9]
    for length in (1, 4, 7):
        np.testing.assert_array_equal(tokenize.pack_tokens(lists, length, 0),
                                      jtok.pack_tokens(lists, length, 0))
    assert tokenize.pack_tokens([[1]], 8, 0).shape == (0, 8)
    for kw in ({}, {"max_docs": 3}, {"eos_token_id": 99, "max_length": 5}):
        rows, ratio = tokenize.chunk_and_tokenize(TEXTS, _CharTokenizer(), **kw)
        jrows, jratio = jtok.chunk_and_tokenize(TEXTS, _CharTokenizer(), **kw)
        np.testing.assert_array_equal(rows, jrows)
        assert rows.dtype == jrows.dtype == np.int32
        assert ratio == jratio


def test_token_datasets_and_pile_shards(tmp_path, monkeypatch):
    """save/load round trip (both sides read each other's file), a plain
    and a zstd Pile shard read as the JAX reader reads them, the
    datasets-free error, and the Pile fallback when the HF load fails."""
    rows = tokenize.pack_tokens([list(range(1, 50))], 8, 0)
    tokenize.save_token_dataset(rows, tmp_path / "toks", {"model": "tiny"})
    np.testing.assert_array_equal(jtok.load_token_dataset(tmp_path / "toks"),
                                  rows)
    assert json.loads((tmp_path / "toks.meta.json").read_text()) == {
        "model": "tiny"}
    lines = [json.dumps({"text": t}) for t in TEXTS] + [""]
    shards = tmp_path / "pile"
    shards.mkdir()
    (shards / "03.jsonl").write_text("\n".join(lines) + "\n")
    assert (tokenize.load_pile_shard(cache_dir=shards, max_docs=4)
            == jtok.load_pile_shard(cache_dir=shards, max_docs=4))
    zstandard = pytest.importorskip("zstandard")
    (shards / "05.jsonl.zst").write_bytes(zstandard.ZstdCompressor().compress(
        ("\n".join(lines) + "\n").encode()))
    assert (tokenize.load_pile_shard(5, cache_dir=shards)
            == jtok.load_pile_shard(5, cache_dir=shards) == TEXTS)
    with pytest.raises(FileNotFoundError, match="fetch one"):
        tokenize.load_pile_shard(7, cache_dir=shards)
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="datasets package"):
        tokenize.load_text_dataset("NeelNanda/pile-10k")

    def no_cache(name, split):
        raise FileNotFoundError(f"{name} not cached")

    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=no_cache))
    assert tokenize.load_text_dataset("pile", max_docs=2,
                                      pile_shard_dir=shards) == TEXTS[:2]
    with pytest.raises(FileNotFoundError, match="not cached"):
        tokenize.load_text_dataset("pile", split="validation",
                                   pile_shard_dir=shards)


def test_setup_data_and_generate_cli(tmp_path, lm, monkeypatch):
    """setup_data packs and harvests as DataArgs says; the generate CLI
    drives it with the model, tokenizer and texts from their caches
    (stubbed here: there are none) on the device it is given."""
    cfg, jp, tp = lm
    texts = ["lorem ipsum dolor sit amet " * 12] * 8
    args = DataArgs(dataset_folder=str(tmp_path / "a"), layers=[0, 1],
                    layer_loc="mlpout", context_len=SEQ, n_chunks=2,
                    chunk_size_gb=_gb(cfg.d_model, 2), activation_dtype="float16")
    got = harvest.setup_data(args, tp, cfg, texts, _CharTokenizer(),
                             device="cpu")
    ref = jharvest.setup_data(args.replace(dataset_folder=str(tmp_path / "j")),
                              jp, cfg, texts, _CharTokenizer())
    assert got == ref == {"mlpout.0": 2, "mlpout.1": 2}
    for tap in got:
        _assert_folders_match(tmp_path / "j" / tap, tmp_path / "a" / tap,
                              "float16")

    from sparse_coding_tpu_torch.data import generate

    seen = {}

    def load_model(name, device=None):
        seen["model"], seen["device"] = name, device
        return tp, cfg

    fake_transformers = types.SimpleNamespace(AutoTokenizer=types.SimpleNamespace(
        from_pretrained=lambda name, local_files_only: _CharTokenizer()))
    monkeypatch.setitem(sys.modules, "transformers", fake_transformers)
    monkeypatch.setattr(convert, "load_model", load_model)
    monkeypatch.setattr(tokenize, "load_text_dataset",
                        lambda name, max_docs=None: texts)
    generate.main(["--model_name", "gpt2", "--layers", "[0,1]",
                   "--layer_loc", "mlpout", "--context_len", str(SEQ),
                   "--n_chunks", "2", "--chunk_size_gb",
                   str(_gb(cfg.d_model, 2)), "--activation_dtype", "float16",
                   "--dataset_folder", str(tmp_path / "cli"),
                   "--device", "cpu"])
    assert seen == {"model": "gpt2", "device": "cpu"}
    for tap in got:
        a, b = tmp_path / "a" / tap, tmp_path / "cli" / tap
        assert (a / "meta.json").read_bytes() == (b / "meta.json").read_bytes()


# --- scrub ------------------------------------------------------------------

def _store(root: Path, sharded: bool) -> None:
    """A store of 3 float16 chunks (flat) or 2 shards of 2 (sharded),
    written by the port."""
    def folder(d, seed, n):
        w = chunk_store.ChunkWriter(d, 8, chunk_size_gb=8 * 16 * 2 / 2**30,
                                    dtype="float16")
        w.add(np.random.default_rng(seed).normal(size=(16 * n, 8)))
        w.finalize()

    if not sharded:
        folder(root, 0, 3)
        return
    for si in range(2):
        d = root / shard_store.shard_name(si)
        folder(d, si, 2)
        shard_store.write_shard_digest(d)
    shard_store.build_store_manifest(root, expect_shards=2)


def _flip(path: Path) -> None:
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0x40
    path.write_bytes(bytes(raw))


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_scrub_reports_match_jax(tmp_path, sharded):
    """Clean, then one flipped byte in one chunk, then with repair: the
    port's scrub_store (and scrub_folder on a folder) gives the JAX
    scrub's reports, and leaves the same files behind, byte for byte."""
    _store(tmp_path / "base", sharded)
    sides = {"port": scrub, "jax": jscrub}
    for s in sides:
        shutil.copytree(tmp_path / "base", tmp_path / s)
    bad = (tmp_path / "{}" / (shard_store.shard_name(1) if sharded else "")
           / "1.npy")
    folder = bad.parent
    reports = {}
    for s, mod in sides.items():
        root = tmp_path / s
        clean = mod.scrub_store(root)
        clean_folder = mod.scrub_folder(Path(str(folder).format(s)))
        _flip(Path(str(bad).format(s)))
        found = mod.scrub_store(root)
        repaired = mod.scrub_store(root, repair=True)
        again = mod.scrub_store(root, repair=True)
        reports[s] = (clean, clean_folder, found, repaired, again)
    assert reports["port"] == reports["jax"]
    clean, _, found, repaired, _ = reports["port"]
    assert clean["quarantined"] == 0 and found["quarantined"] == 1
    assert repaired["repair"] and (Path(str(folder).format("port"))
                                   / "quarantine" / "1.npy").exists()
    worklist = json.loads((tmp_path / "port" / "scrub" / "reharvest.json")
                          .read_text())
    assert [(w["shard"], w["chunk"]) for w in worklist] == [
        (shard_store.shard_name(1) if sharded else "", 1)]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    scrub.main([str(tmp_path / "port"), "--out", str(tmp_path / "cli")])
    assert (json.loads((tmp_path / "cli" / "scrub_report.json").read_text())
            == reports["port"][-1] | {"repair": False})


# --- the kernels' width -------------------------------------------------------

@pytest.mark.parametrize("d", [1024, 2048, 3072, 4096])
def test_choose_plan_takes_lm_widths(d):
    """The kernels take every LM width up to 4096 (the widest d_mlp
    presets): choose_plan gives each family its default path there, and
    no path just above, where the card raises with the sizes it takes."""
    for family, path in roofline.DEFAULT_PATHS.items():
        plan = roofline.choose_plan(batch=2048, n_feats=4 * d, d=d,
                                    family=family)
        assert plan.path == path, (family, d)
    over = roofline.choose_plan(batch=2048, n_feats=8192,
                                d=_build.MAX_D + 1, family="tied")
    assert over.path is None and over.reason == "no_admissible_tile"
    assert _build.MAX_D == 4096
    _build.check_kernel_shape("sae_tied_fwd", 32, 64, d, "bfloat16")
    with pytest.raises(ValueError, match=r"1 <= d <= 4096"):
        _build.check_kernel_shape("sae_tied_fwd", 32, 64, _build.MAX_D + 1)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_train_step_tiled_at_d1024_matches_jax(tied):
    """The CPU twin of train_step_tiled at d=1024 (2 members, n=64, batch
    32) against the JAX step (its kernels in interpret mode) over 3 steps
    on the parity tests' sparse-code batches: losses at rtol 2e-4, each
    weight leaf within 2e-4 of its max|ref| (an element whose gradient
    lies near Adam's eps follows its rounding on the first step)."""
    d, n, b, steps = 1024, 64, 32, 3
    sig, port_sig = ((JaxTiedSAE, FunctionalTiedSAE) if tied
                     else (JaxSAE, FunctionalSAE))
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    jm = [sig.init(k, d, n, l1_alpha=l1) for k, l1 in zip(keys, (1e-3, 1e-2))]
    jens = JaxEnsemble(jm, sig, lr=[1e-3, 2e-3], donate=False, use_fused=True,
                       fused_interpret=True, fused_path="train_step_tiled",
                       fused_batch_tile=32, fused_feat_tile=32)
    tens = Ensemble(members_from_numpy(jax.device_get(jm)), port_sig,
                    lr=[1e-3, 2e-3], device="cpu",
                    fused_path="train_step_tiled")
    for x in batches(seed=8, n=steps, batch=b, d=d):
        ja = jens.step_batch(jax.numpy.asarray(x))
        ta = tens.step_batch(torch.from_numpy(x))
        np.testing.assert_allclose(ta.losses["loss"].numpy(),
                                   np.asarray(ja.losses["loss"]), rtol=2e-4)
    assert tens.fused_path == jens.fused_path == "train_step_tiled"
    ref = jax.device_get(jens.state.params)
    for k, v in tens.state.params.items():
        err = np.abs(v.numpy() - ref[k]).max()
        assert err <= 2e-4 * np.abs(ref[k]).max(), (k, err)
