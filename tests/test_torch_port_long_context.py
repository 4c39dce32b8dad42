"""The port's long-context harvest (``lm/ring_attention.py``,
``lm/long_context.py``, the ``mesh=`` path of ``data/harvest.py``) against
the JAX package's, on the CPU.

The JAX side runs on the virtual 8-device CPU mesh (``devices8``) under
``shard_map``; the port's side runs in gloo worlds of 2 and 4 CPU ranks
(``torch_port_world.py long_context``, one world of each size for the
module) and, for a ring of one, in this process. Inputs are seeded numpy
arrays; the LM is the JAX package's tiny GPT-NeoX carried to the port.

Tolerances: ring attention, the sequence-parallel forward's taps and
logits within 1e-5 of max|ref| (the port's LM bound: the same fp32
operations summed in other orders); harvested bf16 chunks each value
within one bf16 ulp more (each side rounds by at most half an ulp);
meta.json fields equal.
"""

import dataclasses
import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparse_coding_tpu.data import harvest as jharvest
from sparse_coding_tpu.lm import gptneox as jneox
from sparse_coding_tpu.lm.long_context import (
    sequence_parallel_forward as jax_sp_forward,
)
from sparse_coding_tpu.lm.model_config import tiny_test_config
from sparse_coding_tpu.lm.ring_attention import ring_attention as jax_ring
from sparse_coding_tpu.parallel.mesh import compat_shard_map
from sparse_coding_tpu.parallel.mesh import make_mesh as jax_mesh
from sparse_coding_tpu_torch.data import chunk_store, harvest
from sparse_coding_tpu_torch.lm import convert
from sparse_coding_tpu_torch.lm.long_context import sequence_parallel_forward
from sparse_coding_tpu_torch.lm.ring_attention import ring_attention
from sparse_coding_tpu_torch.parallel.mesh import Mesh, make_mesh
from torch_port_helpers import run_world

RTOL = 1e-5
QKV_SHAPE = (2, 32, 4, 8)  # [B, S, H, Dh]
TOKENS_SHAPE = (2, 32)
TAPS = ("attn_concat.0", "mlp.1", "mlpout.1", "residual.2", "attn.1")
# key -> (parallel_residual, taps, stop_at_layer)
FORWARDS = {"parallel": (True, TAPS, None),
            "sequential": (False, TAPS, None),
            "stopped": (True, ("residual.0", "mlp.1"), 2)}
SEQ, MB, N_ROWS = 32, 4, 12  # the harvest's context, model batch, rows
WIDTH = 128  # the tiny config's d_mlp
HARVEST = {"layers": [0, 1], "layer_loc": "mlp", "model_batch_size": MB,
           # two model batches a chunk: 256 + 128 rows
           "chunk_size_gb": 2 * MB * SEQ * WIDTH * 2 / 2**30,
           "dtype": "bfloat16"}
WORLDS = (2, 4)


def _qkv() -> np.ndarray:
    return np.random.default_rng(0).normal(
        size=(3, *QKV_SHAPE)).astype(np.float32)


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             TOKENS_SHAPE)


def _rows(cfg) -> np.ndarray:
    return np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (N_ROWS, SEQ))


def _close(got, ref, what: str) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= RTOL * scale, (f"{what}: |Δ|max {err:.3e} > {RTOL} x "
                                 f"{scale:.3e}")


def _joined(blocks) -> np.ndarray:
    """The ranks' sequence blocks, in rank order, as one array."""
    return np.concatenate([np.asarray(b) for b in blocks], axis=1)


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_test_config("gptneox")
    jp = jneox.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jax.device_get(jp)


@pytest.fixture(scope="module")
def worlds(lm, tmp_path_factory):
    """Each world size's per-rank results and its rank 0's harvest
    folder."""
    cfg, jp = lm
    root = tmp_path_factory.mktemp("long_context")
    inp = root / "input.pkl"
    inp.write_bytes(pickle.dumps({
        "qkv": _qkv(), "params": jp, "tokens": _tokens(cfg),
        "forwards": FORWARDS, "rows": _rows(cfg), "harvest": HARVEST}))
    out = {}
    for n in WORLDS:
        folder = root / f"harvest_{n}"
        out[n] = (run_world(root, "long_context", n, inp, folder), folder)
    return out


def _jax_ring(p: int) -> np.ndarray:
    q, k, v = (jnp.asarray(a) for a in _qkv())
    spec = P(None, "data")
    ring = compat_shard_map(
        lambda q, k, v: jax_ring(q, k, v, axis_name="data"), jax_mesh(1, p),
        in_specs=(spec, spec, spec), out_specs=spec)
    return np.asarray(ring(q, k, v))


# --- ring attention ----------------------------------------------------------

def test_ring_of_one_matches_jax():
    mesh = make_mesh(1, 1, device="cpu")
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    _close(ring_attention(q, k, v, mesh), _jax_ring(1), "P=1")


@pytest.mark.parametrize("n", WORLDS)
def test_ring_matches_jax(worlds, devices8, n):
    ranks, _ = worlds[n]
    _close(_joined(r["ring"] for r in ranks), _jax_ring(n), f"P={n}")


def test_ring_inside_model_rows_matches_jax(worlds, devices8):
    """On a 2 × 2 mesh each model row runs its own ring of 2 (global ranks
    2 and 3 are data ranks 0 and 1 of row 1)."""
    ranks, _ = worlds[4]
    want = _jax_ring(2)
    _close(_joined(r["ring_2x"] for r in ranks[:2]), want, "row 0")
    _close(_joined(r["ring_2x"] for r in ranks[2:]), want, "row 1")


# --- the sequence-parallel forward -------------------------------------------

def _jax_forward(lm, key: str, p: int):
    cfg, jp = lm
    parallel, taps, stop = FORWARDS[key]
    cfg = dataclasses.replace(cfg, parallel_residual=parallel)
    return jax_sp_forward(jp, jnp.asarray(_tokens(cfg)), cfg,
                          jax_mesh(1, p), taps=taps, stop_at_layer=stop)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", sorted(FORWARDS))
def test_sequence_parallel_forward_matches_jax(lm, worlds, devices8, n, key):
    """Taps and logits, gathered from the ranks' blocks, against the JAX
    sequence-parallel forward on the same mesh shape (both residual
    layouts; stopped early, no logits on either side)."""
    ranks, _ = worlds[n]
    want_logits, want_taps = _jax_forward(lm, key, n)
    got = [r[key] for r in ranks]
    if want_logits is None:
        assert all(g[0] is None for g in got)
    else:
        _close(_joined(g[0] for g in got), want_logits, "logits")
    assert all(set(g[1]) == set(want_taps) for g in got)
    for tap in want_taps:
        _close(_joined(g[1][tap] for g in got), want_taps[tap], tap)


def test_sequence_parallel_forward_of_one_and_ragged(lm, devices8):
    """On a 1 × 1 mesh the port equals JAX's single-shard forward; a
    sequence the axis does not divide raises on both sides."""
    cfg, jp = lm
    params = convert.params_from_numpy(jp, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg))
    logits, taps = sequence_parallel_forward(params, tokens, cfg,
                                             make_mesh(1, 1, device="cpu"),
                                             taps=TAPS)
    want_logits, want_taps = _jax_forward(lm, "parallel", 1)
    _close(logits, want_logits, "logits")
    for tap in TAPS:
        _close(taps[tap], want_taps[tap], tap)
    with pytest.raises(ValueError, match="divisible"):
        sequence_parallel_forward(params, tokens[:, :30], cfg,
                                  Mesh(1, 4, torch.device("cpu")))
    with pytest.raises(ValueError, match="divisible"):
        jax_sp_forward(jp, jnp.zeros((1, 30), jnp.int32), cfg,
                       jax_mesh(1, 4))


# --- the mesh harvest --------------------------------------------------------

def _decode(folder: Path, i: int) -> np.ndarray:
    return chunk_store._from_bf16_bits(np.load(folder / f"{i}.npy"))


def _chunks_close(a: np.ndarray, b: np.ndarray, what: str) -> None:
    """bf16 chunks of the same activations summed in other orders: within
    1e-5 of max|ref| and one bf16 ulp."""
    assert a.shape == b.shape, what
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    tol = RTOL * np.abs(b).max() + np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - b) <= tol), (what, float(np.abs(a - b).max()))


def _folders_match(got: Path, want: Path) -> None:
    for tap in ("mlp.0", "mlp.1"):
        gmeta = json.loads((got / tap / "meta.json").read_text())
        wmeta = json.loads((want / tap / "meta.json").read_text())
        gd, wd = gmeta.pop("chunk_digests"), wmeta.pop("chunk_digests")
        assert gmeta == wmeta, tap
        assert set(gd) == set(wd) and len(gd) == gmeta["n_chunks"] == 2
        for i in range(gmeta["n_chunks"]):
            _chunks_close(_decode(got / tap, i), _decode(want / tap, i),
                          f"{tap} chunk {i}")


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_harvest_matches_jax_and_one_device(lm, worlds, devices8,
                                                 tmp_path, n):
    """Rank 0's chunk folders against the JAX mesh harvest on the same
    mesh shape and against the port's single-device harvest (the rows in
    the single-device order); every rank returns rank 0's counts, and no
    other rank wrote anything."""
    cfg, jp = lm
    ranks, folder = worlds[n]
    assert all(r["harvest"] == {"mlp.0": 2, "mlp.1": 2} for r in ranks)
    jax_out = tmp_path / "jax"
    assert jharvest.harvest_activations(
        jp, cfg, _rows(cfg), output_folder=jax_out, mesh=jax_mesh(1, n),
        **HARVEST) == {"mlp.0": 2, "mlp.1": 2}
    _folders_match(folder, jax_out)
    one = tmp_path / "one"
    harvest.harvest_activations(convert.params_from_numpy(jp, device="cpu"),
                                cfg, _rows(cfg), output_folder=one,
                                device="cpu", **HARVEST)
    _folders_match(folder, one)
    assert sorted(p.name for p in folder.iterdir()) == ["mlp.0", "mlp.1"]


def test_mesh_harvest_refusals(lm, tmp_path):
    """forward= with mesh=, and scan_batches > 1 with mesh=, raise the JAX
    package's ValueErrors on both sides."""
    cfg, jp = lm
    params = convert.params_from_numpy(jp, device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    for side, p, m in (("port", params, mesh), ("jax", jp, jax_mesh(1, 1))):
        with pytest.raises(ValueError, match="mutually exclusive"):
            (harvest if side == "port" else jharvest).make_harvest_fn(
                p, cfg, ("mlp.0",), forward=lambda *a, **k: None, mesh=m)
        with pytest.raises(ValueError, match="scan_batches"):
            (harvest if side == "port" else jharvest).make_harvest_fn(
                p, cfg, ("mlp.0",), mesh=m, scan_batches=2)
        kw = {"device": "cpu"} if side == "port" else {}
        with pytest.raises(ValueError, match="scan_batches"):
            (harvest if side == "port" else jharvest).harvest_activations(
                p, cfg, _rows(cfg), output_folder=tmp_path / side, mesh=m,
                scan_batches=2, **HARVEST, **kw)
