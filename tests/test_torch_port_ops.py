"""The port's tied-SAE ops (sparse_coding_tpu_torch/ops) against the JAX
package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_fused_kernel.py and tests/test_fused_tiled.py do; the port's
side runs the plain PyTorch version of each CUDA kernel, which is what its
wrappers do for CPU tensors. Tolerances, unless a test says otherwise:

- losses and the Adam epilogue: rtol 1e-5 — the same f32 formulas, summed
  in a different order (XLA vs torch CPU matmuls), agree to a few ulps of
  the row sums;
- the residual r = x̂ − x: rtol 1e-5 plus atol 2e-6 — the subtraction
  cancels, so a small r carries the absolute rounding of |x| ~ 1;
- gradients (dW, db, dE, grad_sq): rtol 2e-4, atol 1e-6 — the JAX
  package's own fused-vs-autodiff bound (tests/test_fused_tiled.py);
- activity counts: exact — at these shapes no pre-activation lies within
  rounding of 0, so both sides see the same ReLU masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.models.sae import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding_tpu.ops import fused_sae as jfs
from sparse_coding_tpu.ops import fused_sae_tiled as jft
from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE
from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops import fused_sae as fs
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft
from sparse_coding_tpu_torch.ops import roofline
from torch_port_helpers import ADAM, BATCH_TILE, FEAT_TILE, kernel_inputs

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
RESID_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def inp():
    return kernel_inputs(seed=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=what)


def _close_losses(got, ref):
    for k in ("mse", "l1", "l0"):
        _close(got[k], ref[k], LOSS_TOL, f"loss {k}")


def test_sae_tied_fwd_plain_matches_pallas_forward(inp):
    """The fwd kernel's contract: r = x̂ − x, x̂ from the Pallas forward
    (_fwd_call) and the residual pass after it."""
    n_m, n_f, _ = inp["e"].shape
    xhat = jft._fwd_call(jnp.asarray(inp["e"]), None,
                         jnp.asarray(inp["bias"]).reshape(n_m, 1, n_f), None,
                         jnp.asarray(inp["x"]), BATCH_TILE, FEAT_TILE, True,
                         "float32")
    r = ft.sae_tied_fwd_plain(_t(inp["e"]), _t(inp["bias"]), _t(inp["x"]))
    _close(r, np.asarray(xhat) - inp["x"][None], RESID_TOL, "residual")


def test_sae_tied_bwd_plain_matches_pallas_backward(inp):
    """The bwd kernel's contract (_bwd_call), fed the same residual."""
    n_m, n_f, _ = inp["e"].shape
    b = inp["x"].shape[0]
    resid = np.asarray(ft.sae_tied_fwd_plain(_t(inp["e"]), _t(inp["bias"]),
                                             _t(inp["x"])))
    dw, db, act, loss4 = jft._bwd_call(
        jnp.asarray(inp["alphas"]), jnp.asarray(inp["e"]), None,
        jnp.asarray(inp["bias"]).reshape(n_m, 1, n_f), None,
        jnp.asarray(inp["x"]), jnp.asarray(resid), BATCH_TILE, FEAT_TILE,
        True, b, "float32")
    got = ft.sae_tied_bwd_plain(_t(inp["e"]), _t(inp["bias"]),
                                _t(inp["alphas"]), _t(inp["x"]), _t(resid))
    _close(got[0], dw, GRAD_TOL, "dW")
    _close(got[1], np.asarray(db).reshape(n_m, n_f), GRAD_TOL, "db")
    np.testing.assert_array_equal(np.asarray(got[2]),
                                  np.asarray(act).reshape(n_m, n_f))
    loss4 = np.asarray(loss4).reshape(n_m, 4)
    _close(got[3][:, :3], loss4[:, :3], LOSS_TOL, "mse/l1/l0")
    _close(got[3][:, 3], loss4[:, 3], GRAD_TOL, "grad_sq")


def test_k1_fused_tied_sae_grads(inp):
    ref = jfs.fused_tied_sae_grads(
        jnp.asarray(inp["e"]), jnp.asarray(inp["bias"]),
        jnp.asarray(inp["alphas"]), jnp.asarray(inp["x"]),
        batch_tile=BATCH_TILE, interpret=True)
    got = fs.fused_tied_sae_grads_plain(
        _t(inp["e"]), _t(inp["bias"]), _t(inp["alphas"]), _t(inp["x"]),
        batch_tile=BATCH_TILE)
    _close_losses(got[0], ref[0])
    _close(got[1], ref[1], GRAD_TOL, "dW")
    _close(got[2], ref[2], GRAD_TOL, "db")
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(ref[3]))


def test_k1_producer_chains_the_normalization_vjp(inp):
    """fused_tied_sae_loss_and_grads: grads wrt the RAW params."""
    params = {"encoder": inp["e"], "encoder_bias": inp["bias"]}
    ref = jfs.fused_tied_sae_loss_and_grads(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(inp["alphas"]), jnp.asarray(inp["x"]),
        batch_tile=BATCH_TILE, interpret=True)
    got = fs.fused_tied_sae_loss_and_grads(
        {k: _t(v) for k, v in params.items()}, _t(inp["alphas"]),
        _t(inp["x"]), batch_tile=BATCH_TILE)
    _close_losses(got[0], ref[0])
    for k in params:
        _close(got[1][k], ref[1][k], GRAD_TOL, k)


def test_k2_fused_tied_sae_train_step(inp):
    b1, b2, eps = ADAM
    keys = ("e", "bias", "mu", "nu", "mu_b", "nu_b", "alphas", "lrs", "bc1",
            "bc2", "x")
    ref = jfs.fused_tied_sae_train_step(
        *(jnp.asarray(inp[k]) for k in keys), batch_tile=BATCH_TILE,
        interpret=True, b1=b1, b2=b2, eps=eps)
    got = fs.fused_tied_sae_train_step_plain(
        *(_t(inp[k]) for k in keys), batch_tile=BATCH_TILE, b1=b1, b2=b2,
        eps=eps)
    _close_losses(got[0], ref[0])
    for i, name in enumerate(("E'", "b'", "mu_E'", "nu_E'", "mu_b'",
                              "nu_b'"), start=1):
        _close(got[i], ref[i], GRAD_TOL, name)
    np.testing.assert_array_equal(np.asarray(got[7]), np.asarray(ref[7]))


def test_k3_tiled_tied_sae_grads(inp):
    ref = jft.tiled_tied_sae_grads(
        jnp.asarray(inp["e"]), jnp.asarray(inp["bias"]),
        jnp.asarray(inp["alphas"]), jnp.asarray(inp["x"]),
        batch_tile=BATCH_TILE, feat_tile=FEAT_TILE, interpret=True)
    got = ft.tiled_tied_sae_grads_plain(
        _t(inp["e"]), _t(inp["bias"]), _t(inp["alphas"]), _t(inp["x"]),
        BATCH_TILE, FEAT_TILE)
    _close_losses(got[0], ref[0])
    _close(got[1], ref[1], GRAD_TOL, "dW")
    _close(got[2], ref[2], GRAD_TOL, "db")
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(ref[3]))
    _close(got[4], ref[4], GRAD_TOL, "grad_sq (kernel-grad norm, pre-VJP)")


def test_k3_producer_reports_the_kernel_grad_norm(inp):
    """The tiled producer's 4th output is √grad_sq of the kernel grads
    (before the normalization VJP), as in the JAX package."""
    params = {"encoder": inp["e"], "encoder_bias": inp["bias"]}
    ref = jft.fused_tied_sae_tiled_loss_and_grads(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(inp["alphas"]), jnp.asarray(inp["x"]),
        batch_tile=BATCH_TILE, feat_tile=FEAT_TILE, interpret=True)
    got = ft.fused_tied_sae_tiled_loss_and_grads(
        {k: _t(v) for k, v in params.items()}, _t(inp["alphas"]),
        _t(inp["x"]), batch_tile=BATCH_TILE, feat_tile=FEAT_TILE)
    for k in params:
        _close(got[1][k], ref[1][k], GRAD_TOL, k)
    _close(got[3], ref[3], GRAD_TOL, "gnorm")


def test_k4_fused_tied_adam_vjp_update(inp):
    b1, b2, eps = ADAM
    keys = ("e", "dw", "mu", "nu", "lrs", "bc1", "bc2")
    ref = jfs.fused_tied_adam_vjp_update(
        *(jnp.asarray(inp[k]) for k in keys), ftile=FEAT_TILE,
        interpret=True, b1=b1, b2=b2, eps=eps)
    got = fs.fused_tied_adam_vjp_update_plain(
        *(_t(inp[k]) for k in keys), ftile=FEAT_TILE, b1=b1, b2=b2, eps=eps)
    for name, g, r in zip(("E'", "mu'", "nu'", "un_sq"), got, ref):
        _close(g, r, LOSS_TOL, name)


def test_adam_vjp_bias_rows_match_the_engine_bias_update(inp):
    """sae_tied_adam_vjp's optional bias group is the JAX engine's
    _bias_adam_update (the bias half of K2's update epilogue)."""
    from types import SimpleNamespace

    from sparse_coding_tpu.ensemble import _bias_adam_update

    b1, b2, eps = ADAM
    db = inp["dw"][:, :, 0].copy()
    opt = SimpleNamespace(mu={"encoder_bias": jnp.asarray(inp["mu_b"])},
                          nu={"encoder_bias": jnp.asarray(inp["nu_b"])})
    ref = _bias_adam_update(jnp.asarray(inp["bias"]), jnp.asarray(db), opt,
                            jnp.asarray(inp["lrs"]), jnp.asarray(inp["bc1"]),
                            jnp.asarray(inp["bc2"]), b1, b2, eps)
    *_, got = fs.sae_tied_adam_vjp_plain(
        *(_t(inp[k]) for k in ("e", "dw", "mu", "nu", "lrs", "bc1", "bc2")),
        b1, b2, eps, bias=_t(inp["bias"]), db=_t(db), mu_b=_t(inp["mu_b"]),
        nu_b=_t(inp["nu_b"]))
    for name, g, r in zip(("b'", "mu_b'", "nu_b'"), got, ref):
        _close(g, r, LOSS_TOL, name)


def test_normalize_with_vjp(inp):
    e = inp["e"].copy()
    e[0, 3] = 0.0  # a zero row: the clip (not +eps) branch
    ref = jfs.normalize_with_vjp(jnp.asarray(e), jnp.asarray(inp["dw"]))
    got = fs.normalize_with_vjp(_t(e), _t(inp["dw"]))
    _close(got, ref, LOSS_TOL, "dE")


def test_tied_sae_loss_and_autograd_match_jax_grad(inp):
    """FunctionalTiedSAE.loss and its autograd grads vs jax.grad, with a
    non-identity centering and a nonzero bias decay (the terms the kernel
    paths do not take)."""
    import jax

    rs = np.random.default_rng(1)
    d = inp["e"].shape[2]
    params = {"encoder": inp["e"][0], "encoder_bias": inp["bias"][0]}
    q, _ = np.linalg.qr(rs.normal(size=(d, d)))
    buffers = {"l1_alpha": np.float32(3e-3), "bias_decay": np.float32(0.01),
               "center_rot": q.astype(np.float32),
               "center_trans": rs.normal(size=d).astype(np.float32),
               "center_scale": rs.uniform(0.5, 2, d).astype(np.float32)}
    x = inp["x"]
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(
        JaxTiedSAE.loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in buffers.items()}, jnp.asarray(x))
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    loss, aux = FunctionalTiedSAE.loss(
        tp, {k: _t(v) for k, v in buffers.items()}, _t(x))
    loss.backward()
    _close(loss.detach(), ref_loss, LOSS_TOL, "loss")
    for k in ("loss", "l_reconstruction", "l_l1"):
        _close(aux.losses[k].detach(), ref_aux.losses[k], LOSS_TOL, k)
    _close(aux.l0, ref_aux.l0, LOSS_TOL, "l0")
    np.testing.assert_array_equal(np.asarray(aux.feat_activity),
                                  np.asarray(ref_aux.feat_activity))
    for k in params:
        _close(tp[k].grad, ref_grads[k], GRAD_TOL, f"grad {k}")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch(inp):
    """On CPU tensors every wrapper returns its plain version's result and
    never touches the launch counts; mixed devices or a CPU tensor handed
    to the CUDA checks raise."""
    _build.reset_launches()
    e, bias, al, x = (_t(inp[k]) for k in ("e", "bias", "alphas", "x"))
    r = ft.sae_tied_fwd(e, bias, x)
    torch.testing.assert_close(r, ft.sae_tied_fwd_plain(e, bias, x),
                               rtol=0, atol=0)
    got = ft.sae_tied_bwd(e, bias, al, x, r)
    for g, p in zip(got, ft.sae_tied_bwd_plain(e, bias, al, x, r)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    adam = [_t(inp[k]) for k in ("e", "dw", "mu", "nu", "lrs", "bc1", "bc2")]
    for g, p in zip(fs.sae_tied_adam_vjp(*adam)[:4],
                    fs.sae_tied_adam_vjp_plain(*adam)[:4]):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError, match="not cuda"):
        _build.check_cuda_tensors("sae_tied_fwd", x=x)
    with pytest.raises(ValueError, match="go together"):
        fs.sae_tied_adam_vjp(*adam, bias=bias)


def test_shape_contract_raises(inp):
    """The JAX divisibility contract (batch % bt, n % ft) raises
    ValueError, as prepare_tiled_batch does; so do the kernels' own tile
    limits and the unported options."""
    e, bias, al, x = (_t(inp[k]) for k in ("e", "bias", "alphas", "x"))
    with pytest.raises(ValueError, match="must be 0"):
        ft.tiled_tied_sae_grads(e, bias, al, x, batch_tile=48, feat_tile=16)
    with pytest.raises(ValueError, match="tile pair"):
        ft.prepare_tiled_batch(x[:100], e.shape[1], None, None)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        _build.check_kernel_shape("sae_tied_fwd", 100, 64, 32)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        _build.check_kernel_shape("sae_tied_fwd", 128, 64, _build.MAX_D + 1)
    with pytest.raises(NotImplementedError):
        fs.fused_tied_sae_grads(e, bias, al, x, compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        fs.fused_tied_sae_grads(e, bias, al, x, coef_mask=torch.ones(3, 64))


def test_roofline_paths_and_flop_model():
    """The port keeps the JAX package's four path labels and FLOP model;
    the card's chooser defaults to train_step_tiled, honours a forced
    path, and resolves unfit shapes to autodiff with a reason."""
    from sparse_coding_tpu.ops import roofline as jroof

    assert set(roofline.KERNEL_PATHS) == set(jroof.KERNEL_PATHS)
    assert roofline.model_flops_per_activation(32, 2048, 512) == \
        jroof.model_flops_per_activation(32, 2048, 512)
    plan = roofline.choose_plan(batch=2048, n_feats=2048, d=512,
                                family="tied")
    assert (plan.path, plan.reason) == ("train_step_tiled", "default")
    for path in roofline.KERNEL_PATHS:
        assert roofline.choose_plan(batch=2048, n_feats=2048, d=512,
                                    family="tied",
                                    forced_path=path).path == path
    assert roofline.choose_plan(batch=100, n_feats=2048, d=512,
                                family="tied").path is None
    assert roofline.choose_plan(batch=2048, n_feats=2048, d=512,
                                family=None).reason == "family_ineligible"
