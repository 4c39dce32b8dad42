"""The port's parallel layer (``sparse_coding_tpu_torch/parallel``) and the
kernels' data-sharded form, against the JAX package on the CPU.

- The mesh: construction over the world, its errors, the placement
  aliases, and (in a 4-rank gloo world) its collectives and
  ``agree_any``.
- The partition rules: every named rule set resolves each leaf of the
  ensemble, big-SAE, group and catalog trees to the JAX package's spec.
- ``total_batch``: each kernel's plain version with ``total_batch = 2·b``
  (a data-sharded call: partial sums over its rows, normalized by the
  global batch) against the JAX kernel in Pallas interpret mode with the
  same ``total_batch``. fp32 at the JAX package's fused-vs-autodiff bound
  (rtol 2e-4, atol 1e-6; losses rtol 1e-5, activity exact); bf16 at the
  port's bf16 bound (|Δ|max ≤ 1e-3 of max|ref|, tests/test_torch_port_bf16.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_big_sae as jfb
from sparse_coding_tpu.ops import fused_sae as jfs
from sparse_coding_tpu.ops import fused_sae_tiled as jft
from sparse_coding_tpu.parallel import partition as jpart
from sparse_coding_tpu_torch.ops import fused_big_sae as tfb
from sparse_coding_tpu_torch.ops import fused_sae as fs
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft
from sparse_coding_tpu_torch.parallel import mesh as tmesh
from sparse_coding_tpu_torch.parallel import partition as tpart
from torch_port_helpers import BATCH_TILE, FEAT_TILE, kernel_inputs, run_world

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
BF16_SHARE = 1e-3
BF16 = "bfloat16"


def _t(a):
    return torch.from_numpy(np.array(a))


# --- the mesh ------------------------------------------------------------------

def test_make_mesh_over_a_world_of_one_and_its_errors():
    """A 1 × 1 mesh needs no world; a mesh larger than the world, an axis
    below 1 or an unknown axis raise, as the JAX make_mesh does."""
    mesh = tmesh.make_mesh(1, 1, device="cpu")
    assert mesh.shape == {"model": 1, "data": 1}
    assert mesh.coords == {"model": 0, "data": 0} and mesh.size == 1
    assert not mesh.is_distributed
    assert tmesh.single_device_mesh("cpu").shape == mesh.shape
    assert tmesh.make_mesh(1, device_type="cpu").shape["data"] == 1
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        tmesh.make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_mesh(0, 1, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(3, None, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.psum(torch.ones(2), "rows")
    # a world of one: the collectives are the identity
    t = torch.arange(4.0)
    assert torch.equal(mesh.psum(t, ("model", "data")), t)
    assert torch.equal(mesh.all_gather(t[None], "model"), t[None])
    assert bool(mesh.all_true(torch.tensor(True)))


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_mesh(1, 1, device_type="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.default_device("cuda")


def test_initialize_distributed_is_a_no_op_without_a_rendezvous(
        monkeypatch):
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert tmesh.local_world_is_world()


def test_placement_aliases_delegate_to_the_partition_rules():
    mesh = tmesh.Mesh(2, 2, "cpu")
    assert tmesh.batch_sharding(mesh) == tpart.BATCH == ("data",)
    assert tmesh.batch_sharding(mesh, stacked=True) == tpart.STACKED_BATCH
    assert tmesh.ensemble_sharding(mesh) == tpart.MEMBER == ("model",)
    assert tmesh.replicated(mesh) == tpart.REPLICATED == ()
    assert tmesh.feature_sharding(mesh) == tpart.FEATURE_ROWS
    for name in ("MEMBER", "BATCH", "STACKED_BATCH", "REPLICATED",
                 "FEATURE_ROWS", "FEATURE_COLS"):
        assert getattr(tpart, name) == tuple(getattr(jpart, name)), name


# --- the partition rules --------------------------------------------------------

def _tree(kind: str) -> dict:
    """A tree of each rule set's kind (numpy leaves; the same paths the
    port's states have)."""
    z = lambda *s: np.zeros(s, np.float32)
    if kind == "ensemble":
        p = {"encoder": z(4, 8, 6), "encoder_bias": z(4, 8)}
        return {"params": p, "buffers": {"l1_alpha": z(4)}, "mu": p,
                "nu": p, "count": np.zeros(4, np.int32), "lrs": z(4),
                "step": np.zeros((), np.int32), "live": z(4)}
    if kind == "big_sae":
        p = {"dict": z(16, 6), "encoder": z(6, 16), "threshold": z(16),
             "centering": z(6)}
        return {"params": p, "count": np.zeros((), np.int32), "mu": p,
                "nu": p, "c_totals": z(16), "worst_losses": z(5),
                "worst_vectors": z(5, 6), "step": np.zeros((), np.int32),
                "one": z(1, 1)}
    if kind == "group":
        return {"params": {"encoder": z(4, 8, 6), "center": z(4, 6)},
                "pooled_stats": {"mean": z(6)}, "lrs": z(4)}
    return {"rows": z(16, 6)}


RULE_SETS = {"ensemble": "ENSEMBLE_STATE_RULES",
             "big_sae": "BIG_SAE_STATE_RULES",
             "big_sae_params": "BIG_SAE_PARAM_RULES",
             "group": "GROUP_STATE_RULES",
             "catalog": "CATALOG_FEATURE_RULES"}


@pytest.mark.parametrize("kind", list(RULE_SETS))
def test_match_partition_rules_resolves_every_leaf_as_jax(kind):
    tree = _tree("big_sae" if kind == "big_sae_params" else kind)
    if kind == "big_sae_params":
        tree = tree["params"]
    name = RULE_SETS[kind]
    want = dict(jpart.tree_paths(jpart.match_partition_rules(
        getattr(jpart, name), tree)))
    got_tree = tpart.match_partition_rules(getattr(tpart, name), tree)
    got = {}

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            got[prefix.rstrip("/")] = node

    walk(got_tree)
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == tuple(spec), path


def test_match_partition_rules_errors_and_port_states():
    """A leaf no rule covers raises; the port's own state dataclasses
    resolve by their field paths (the Adam moments as the params)."""
    with pytest.raises(ValueError, match="no partition rule"):
        tpart.match_partition_rules(tpart.BIG_SAE_PARAM_RULES,
                                    {"other": np.zeros((4, 2))})
    from sparse_coding_tpu_torch.train import big_sae as tbs

    state, _, _ = tbs.init_big_sae(torch.Generator().manual_seed(0), 6, 16,
                                   1e-3, n_worst=5, device="cpu")
    specs = dict(tpart.tree_paths(state))
    resolved = tpart.match_partition_rules(tpart.BIG_SAE_STATE_RULES, state)
    assert resolved.params["dict"] == tpart.FEATURE_ROWS
    assert resolved.mu["encoder"] == tpart.FEATURE_COLS
    assert resolved.nu["threshold"] == tpart.MEMBER
    assert resolved.c_totals == tpart.MEMBER
    assert resolved.worst_vectors == tpart.REPLICATED
    assert resolved.count == tpart.REPLICATED and resolved.tied is False
    assert "params/dict" in specs and "mu/dict" in specs


def test_place_tree_and_place_batch_keep_this_ranks_slice():
    """Rank (1, 0) of a 2 × 2 mesh keeps the second member half and the
    first row half; a size the axis does not divide raises."""
    mesh = tmesh.Mesh(2, 2, "cpu")
    mesh.coords = {"model": 1, "data": 0}
    full = {"params": {"encoder": torch.arange(48.0).reshape(4, 2, 6)},
            "step": torch.tensor(3), "one": torch.ones(1)}
    local = tpart.place_tree(full, mesh, tpart.ENSEMBLE_STATE_RULES)
    assert torch.equal(local["params"]["encoder"],
                       full["params"]["encoder"][2:])
    assert torch.equal(local["step"], full["step"])
    assert torch.equal(local["one"], full["one"])
    x = torch.arange(24.0).reshape(8, 3)
    assert torch.equal(tpart.place_batch(x, mesh), x[:4])
    windows = torch.arange(48.0).reshape(2, 8, 3)
    assert torch.equal(tpart.place_batch(windows, mesh, stacked=True),
                       windows[:, :4])
    with pytest.raises(ValueError, match="not divisible by mesh data"):
        tpart.place_batch(x[:7], mesh)
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        tpart.place_tree({"a": torch.zeros(3, 2)}, mesh,
                         tpart.ENSEMBLE_STATE_RULES)


def test_ensemble_on_a_mesh_refuses_what_cannot_split():
    """A member count the model axis does not divide raises, as the JAX
    shard_ensemble_state does; a signature not known to be a mean over
    rows cannot split the batch over a data axis, and raises naming it
    before any step (every signature of the zoo is such a mean)."""
    from sparse_coding_tpu_torch.ensemble import (
        ROW_SEPARABLE_SIGNATURES,
        Ensemble,
    )
    from sparse_coding_tpu_torch.models import sae as tsae
    from sparse_coding_tpu_torch.models.signatures import signature_names

    g = torch.Generator().manual_seed(0)
    members = [tsae.FunctionalTiedSAE.init(g, 8, 32, l1_alpha=1e-3)
               for _ in range(3)]
    with pytest.raises(ValueError, match="ensemble size 3 not divisible"):
        Ensemble(members, tsae.FunctionalTiedSAE, mesh=tmesh.Mesh(2, 1, "cpu"))

    class Custom(tsae.FunctionalTiedSAE):
        signature_name = "custom_sae"

    ens = Ensemble(members[:2], Custom, mesh=tmesh.Mesh(1, 2, "cpu"))
    with pytest.raises(ValueError, match="'custom_sae' is not known"):
        ens.step_batch(torch.zeros(64, 8))
    import sparse_coding_tpu_torch.models  # noqa: F401 (the zoo)
    from sparse_coding_tpu_torch.models import (  # noqa: F401
        lista, positive, rica, semilinear, topk)

    assert set(signature_names()) <= ROW_SEPARABLE_SIGNATURES


# --- the kernels' data-sharded form ---------------------------------------------

def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=what)


def _share(got, ref, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= BF16_SHARE * scale, f"{what}: {err:.3e} vs {scale:.3e}"


def _check(got, ref, names, cd):
    losses_g, losses_r = got[0], ref[0]
    for k in ("mse", "l1", "l0"):
        _close(losses_g[k], losses_r[k],
               LOSS_TOL if cd == "float32" else dict(rtol=1e-4), f"loss {k}")
    for name, g, r in zip(names, got[1:], ref[1:]):
        if name == "activity":
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        elif cd == "float32":
            _close(g, r, GRAD_TOL, name)
        else:
            _share(g, r, name)


KERNEL_CASES = [("k1", "tied"), ("k1", "masked"), ("k3", "tied"),
                ("k3", "masked"), ("k5", "untied"), ("k7", "untied")]


@pytest.mark.parametrize("cd", ["float32", BF16])
@pytest.mark.parametrize("kernel, family", KERNEL_CASES,
                         ids=[f"{k}_{f}" for k, f in KERNEL_CASES])
def test_total_batch_grads_match_jax(kernel, family, cd):
    """K1/K3 (tied, masked) and K5/K7 (untied) on a data shard of half the
    global batch: the port's plain versions against the Pallas kernels in
    interpret mode, both given total_batch = 2·b."""
    inp = kernel_inputs(seed=4)
    total = 2 * inp["x"].shape[0]
    jx, tx = jnp.asarray(inp["x"]), _t(inp["x"])
    mask = inp["coef_mask"] if family == "masked" else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    je, jb, ja = (jnp.asarray(inp[k]) for k in ("e", "bias", "alphas"))
    te, tb, ta = (_t(inp[k]) for k in ("e", "bias", "alphas"))
    if kernel == "k1":
        ref = jfs.fused_tied_sae_grads(je, jb, ja, jx, batch_tile=BATCH_TILE,
                                       interpret=True, total_batch=total,
                                       compute_dtype=cd, coef_mask=jm)
        got = fs.fused_tied_sae_grads(te, tb, ta, tx, total_batch=total,
                                      compute_dtype=cd, coef_mask=tm)
        names = ("dW", "db", "activity")
    elif kernel == "k3":
        ref = jft.tiled_tied_sae_grads(je, jb, ja, jx, BATCH_TILE, FEAT_TILE,
                                       interpret=True, total_batch=total,
                                       compute_dtype=cd, coef_mask=jm)
        got = ft.tiled_tied_sae_grads(te, tb, ta, tx, BATCH_TILE, FEAT_TILE,
                                      total_batch=total, compute_dtype=cd,
                                      coef_mask=tm)
        names = ("dW", "db", "activity", "grad_sq")
    elif kernel == "k5":
        jd, td = jnp.asarray(inp["dec"]), _t(inp["dec"])
        ref = jfs.fused_untied_sae_grads(je, jd, jb, ja, jx,
                                         batch_tile=BATCH_TILE,
                                         interpret=True, total_batch=total,
                                         compute_dtype=cd)
        got = fs.fused_untied_sae_grads(te, td, tb, ta, tx,
                                        total_batch=total, compute_dtype=cd)
        names = ("dE", "dWn", "db", "activity")
    else:
        jd, td = jnp.asarray(inp["dec"]), _t(inp["dec"])
        ref = jft.tiled_untied_sae_grads(je, jd, jb, ja, jx, BATCH_TILE,
                                         FEAT_TILE, interpret=True,
                                         total_batch=total, compute_dtype=cd)
        got = ft.tiled_untied_sae_grads(te, td, tb, ta, tx, BATCH_TILE,
                                        FEAT_TILE, total_batch=total,
                                        compute_dtype=cd)
        names = ("dE", "dWn", "db", "activity", "grad_sq")
    _check(got, ref, names, cd)
    # half the batch at twice its size: the loss terms are half-weight
    # partials of the whole-batch call's
    whole = (fs.fused_untied_sae_grads(te, _t(inp["dec"]), tb, ta, tx,
                                       compute_dtype=cd)
             if family == "untied" else
             fs.fused_tied_sae_grads(te, tb, ta, tx, compute_dtype=cd,
                                     coef_mask=tm))
    _close(got[0]["mse"] * 2, whole[0]["mse"], dict(rtol=1e-5), "mse half")


@pytest.mark.parametrize("cd", ["float32", BF16])
def test_total_batch_big_sae_backward_matches_jax(cd):
    """K9 on a data shard: the port's chunked CPU schedule against the
    Pallas kernel in interpret mode, both with total_batch = 2·b."""
    rs = np.random.default_rng(7)
    b, n, d = 128, 128, 64
    dictionary = rs.normal(size=(n, d))
    dictionary /= np.linalg.norm(dictionary, axis=-1, keepdims=True)
    p = {"dict": dictionary.astype(np.float32),
         "encoder": (rs.normal(size=(d, n)) / np.sqrt(d)).astype(np.float32),
         "threshold": (rs.normal(size=n) * 0.05).astype(np.float32),
         "centering": (rs.normal(size=d) * 0.1).astype(np.float32)}
    xc = rs.normal(size=(b, d)).astype(np.float32)
    r = (rs.normal(size=(b, d)) * 0.3).astype(np.float32)
    alpha = np.float32(3e-3)
    want = jfb.big_sae_backward(p, jnp.asarray(alpha), jnp.asarray(xc),
                                jnp.asarray(r), batch_tile=64, feat_tile=64,
                                interpret=True, total_batch=2 * b,
                                compute_dtype=cd)
    got = tfb.big_sae_backward({k: _t(v) for k, v in p.items()},
                               torch.tensor(alpha), _t(xc), _t(r), 64, 64,
                               total_batch=2 * b, compute_dtype=cd)
    plain = tfb.big_sae_backward_plain({k: _t(v) for k, v in p.items()},
                                       torch.tensor(alpha), _t(xc), _t(r),
                                       compute_dtype=cd, total_batch=2 * b)
    names = ("dE", "dWn", "dt", "dctr_enc", "c_totals", "l1_l0")
    for name, g, w, q in zip(names, got, want, plain):
        if cd == "float32":
            tol = (dict(rtol=1e-4, atol=0) if name == "c_totals"
                   else GRAD_TOL)
            _close(g, w, tol, name)
            _close(q, w, tol, name + " plain")
        else:
            _share(g, w, name)


# --- collectives and agree_any in a 4-rank gloo world ---------------------------

@pytest.fixture(scope="module")
def agree_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("agree"), "agree", 4)


def test_agree_any_one_rank_moves_all(agree_world):
    assert [r["one"] for r in agree_world] == [True] * 4


def test_agree_any_all_false_stays_false(agree_world):
    assert [r["none"] for r in agree_world] == [False] * 4


def test_mesh_collectives_in_a_world(agree_world):
    """Rank r sits at (r // 2, r % 2); psum over an axis sums its line,
    over both the world; all_gather stacks the line in axis order; the
    AND over "data" sees rank 1's False on its line only."""
    base = torch.arange(3, dtype=torch.float32)
    for r, res in enumerate(agree_world):
        m, dd = divmod(r, 2)
        assert res["coords"] == (m, dd)
        line_d = [2 * m, 2 * m + 1]
        line_m = [dd, 2 + dd]
        assert torch.equal(res["data"], 2 * base + 10 * sum(line_d))
        assert torch.equal(res["model"], 2 * base + 10 * sum(line_m))
        assert torch.equal(res["both"][0], 4 * base + 60)
        assert res["both"][1].dtype == torch.int32
        assert torch.equal(res["gather"],
                           torch.stack([base + 10 * q for q in line_m]))
        assert res["all_true"] == (m != 0)
