"""The port's SAE ops (sparse_coding_tpu_torch/ops) against the JAX package
on the same numpy inputs, for the tied, masked-tied and untied families.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_fused_kernel.py and tests/test_fused_tiled.py do; the port's
side runs the plain PyTorch version of each CUDA kernel, which is what its
wrappers do for CPU tensors. Tolerances, unless a test says otherwise:

- losses and the Adam epilogues: rtol 1e-5 — the same f32 formulas, summed
  in a different order (XLA vs torch CPU matmuls), agree to a few ulps of
  the row sums;
- the residual r = x̂ − x: rtol 1e-5 plus atol 2e-6 — the subtraction
  cancels, so a small r carries the absolute rounding of |x| ~ 1;
- gradients (dW, dE, dWn, db, grad_sq): rtol 2e-4, atol 1e-6 — the JAX
  package's own fused-vs-autodiff bound (tests/test_fused_tiled.py);
- activity counts: exact — at these shapes no pre-activation lies within
  rounding of 0, so both sides see the same ReLU masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.models import sae as jsae
from sparse_coding_tpu.ops import fused_sae as jfs
from sparse_coding_tpu.ops import fused_sae_tiled as jft
from sparse_coding_tpu_torch.models import sae as tsae
from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops import fused_sae as fs
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft
from sparse_coding_tpu_torch.ops import roofline
from torch_port_helpers import ADAM, BATCH_TILE, FEAT_TILE, kernel_inputs

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
RESID_TOL = dict(rtol=1e-5, atol=2e-6)

FAMILIES = ["tied", "masked_tied", "untied"]
# the producers' cases: the untied family with and without a bias decay
PRODUCER_CASES = [("tied", 0.0), ("masked_tied", 0.0), ("untied", 0.0),
                  ("untied", 0.01)]
PRODUCER_IDS = ["tied", "masked_tied", "untied", "untied_bias_decay"]


@pytest.fixture(scope="module")
def inp():
    return kernel_inputs(seed=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=what)


def _close_losses(got, ref):
    for k in ("mse", "l1", "l0"):
        _close(got[k], ref[k], LOSS_TOL, f"loss {k}")


def _mask(inp, family):
    """The family's coef_mask: bool [N, n] when masked, else None."""
    return inp["coef_mask"] if family == "masked_tied" else None


def _fmask(inp, family):
    """The kernels' form of the mask: float32 [N, n], or None."""
    m = _mask(inp, family)
    return None if m is None else m.astype(np.float32)


def _port_resid(inp, family):
    e, bias, x = _t(inp["e"]), _t(inp["bias"]), _t(inp["x"])
    if family == "untied":
        return ft.sae_untied_fwd_plain(e, _t(inp["dec"]), bias, x)
    m = _fmask(inp, family)
    return ft.sae_tied_fwd_plain(e, bias, x,
                                 None if m is None else _t(m))


@pytest.mark.parametrize("family", FAMILIES)
def test_sae_tied_fwd_plain_matches_pallas_forward(inp, family):
    """The fwd kernels' contract: r = x̂ − x, x̂ from the Pallas forward
    (_fwd_call, tied=True with and without the coef_mask, and tied=False)
    and the residual pass after it."""
    n_m, n_f, _ = inp["e"].shape
    m = _fmask(inp, family)
    xhat = jft._fwd_call(
        _j(inp["e"]), _j(inp["dec"]) if family == "untied" else None,
        _j(inp["bias"]).reshape(n_m, 1, n_f),
        None if m is None else _j(m).reshape(n_m, 1, n_f), _j(inp["x"]),
        BATCH_TILE, FEAT_TILE, True, "float32")
    _close(_port_resid(inp, family), np.asarray(xhat) - inp["x"][None],
           RESID_TOL, "residual")


@pytest.mark.parametrize("family", FAMILIES)
def test_sae_tied_bwd_plain_matches_pallas_backward(inp, family):
    """The bwd kernels' contract (_bwd_call), fed the same residual."""
    n_m, n_f, _ = inp["e"].shape
    b = inp["x"].shape[0]
    untied = family == "untied"
    resid = np.asarray(_port_resid(inp, family))
    m = _fmask(inp, family)
    ref = jft._bwd_call(
        _j(inp["alphas"]), _j(inp["e"]), _j(inp["dec"]) if untied else None,
        _j(inp["bias"]).reshape(n_m, 1, n_f),
        None if m is None else _j(m).reshape(n_m, 1, n_f), _j(inp["x"]),
        _j(resid), BATCH_TILE, FEAT_TILE, True, b, "float32")
    args = [_t(inp[k]) for k in ("e", "bias", "alphas", "x")]
    if untied:
        got = ft.sae_untied_bwd_plain(args[0], _t(inp["dec"]), *args[1:],
                                      _t(resid))
        names = ("dE", "dWn")
    else:
        got = ft.sae_tied_bwd_plain(*args, _t(resid),
                                    None if m is None else _t(m))
        names = ("dW",)
    for i, name in enumerate(names):
        _close(got[i], ref[i], GRAD_TOL, name)
    k = len(names)
    _close(got[k], np.asarray(ref[k]).reshape(n_m, n_f), GRAD_TOL, "db")
    np.testing.assert_array_equal(np.asarray(got[k + 1]),
                                  np.asarray(ref[k + 1]).reshape(n_m, n_f))
    loss4 = np.asarray(ref[k + 2]).reshape(n_m, 4)
    _close(got[k + 2][:, :3], loss4[:, :3], LOSS_TOL, "mse/l1/l0")
    _close(got[k + 2][:, 3], loss4[:, 3], GRAD_TOL, "grad_sq")


@pytest.mark.parametrize("family", FAMILIES)
def test_k1_fused_tied_sae_grads(inp, family):
    """K1 (fused_tied_sae_grads, with and without coef_mask) and K5
    (fused_untied_sae_grads) through the plain versions."""
    e, bias, al, x = (inp[k] for k in ("e", "bias", "alphas", "x"))
    if family == "untied":
        ref = jfs.fused_untied_sae_grads(
            _j(e), _j(inp["dec"]), _j(bias), _j(al), _j(x),
            batch_tile=BATCH_TILE, interpret=True)
        got = fs.fused_untied_sae_grads_plain(
            _t(e), _t(inp["dec"]), _t(bias), _t(al), _t(x),
            batch_tile=BATCH_TILE)
        names = ("dE", "dWn", "db")
    else:
        m = _mask(inp, family)
        ref = jfs.fused_tied_sae_grads(
            _j(e), _j(bias), _j(al), _j(x), batch_tile=BATCH_TILE,
            interpret=True, coef_mask=None if m is None else _j(m))
        got = fs.fused_tied_sae_grads_plain(
            _t(e), _t(bias), _t(al), _t(x), batch_tile=BATCH_TILE,
            coef_mask=None if m is None else _t(m))
        names = ("dW", "db")
    _close_losses(got[0], ref[0])
    for i, name in enumerate(names, start=1):
        _close(got[i], ref[i], GRAD_TOL, name)
    np.testing.assert_array_equal(np.asarray(got[-1]), np.asarray(ref[-1]))


def _params(inp, family):
    p = {"encoder": inp["e"], "encoder_bias": inp["bias"]}
    if family == "untied":
        p["decoder"] = inp["dec"]
    return p


def _producer_args(inp, family, bias_decay, to):
    """(params, then the producer's positional args, kwargs) on one side
    (``to`` = _j or _t)."""
    params = {k: to(v) for k, v in _params(inp, family).items()}
    args = [params, to(inp["alphas"])]
    kw = {}
    if family == "untied":
        args.append(to(np.full(inp["alphas"].shape, bias_decay, np.float32)))
    elif family == "masked_tied":
        kw["coef_mask"] = to(inp["coef_mask"])
    return args + [to(inp["x"])], kw


@pytest.mark.parametrize("family,bias_decay", PRODUCER_CASES,
                         ids=PRODUCER_IDS)
def test_k1_producer_chains_the_normalization_vjp(inp, family, bias_decay):
    """The two-stage producers (K1 fused_tied_sae_loss_and_grads, masked
    too; K5 fused_untied_sae_loss_and_grads with its bias decay): losses
    and grads wrt the RAW params, the normalization VJP chained."""
    jf = (jfs.fused_untied_sae_loss_and_grads if family == "untied"
          else jfs.fused_tied_sae_loss_and_grads)
    tf = (fs.fused_untied_sae_loss_and_grads if family == "untied"
          else fs.fused_tied_sae_loss_and_grads)
    jargs, jkw = _producer_args(inp, family, bias_decay, _j)
    targs, tkw = _producer_args(inp, family, bias_decay, _t)
    ref = jf(*jargs, batch_tile=BATCH_TILE, interpret=True, **jkw)
    got = tf(*targs, batch_tile=BATCH_TILE, **tkw)
    _close_losses(got[0], ref[0])
    assert set(got[0]) == set(ref[0])
    if family == "untied":
        _close(got[0]["bias_decay"], ref[0]["bias_decay"], LOSS_TOL,
               "bias_decay")
    for k in jargs[0]:
        _close(got[1][k], ref[1][k], GRAD_TOL, k)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))


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


@pytest.mark.parametrize("family", FAMILIES)
def test_k3_tiled_tied_sae_grads(inp, family):
    """K3 (tiled_tied_sae_grads, with and without coef_mask) and K7
    (tiled_untied_sae_grads), the kernel-grad norm included."""
    e, bias, al, x = (inp[k] for k in ("e", "bias", "alphas", "x"))
    tiles = dict(batch_tile=BATCH_TILE, feat_tile=FEAT_TILE)
    if family == "untied":
        ref = jft.tiled_untied_sae_grads(
            _j(e), _j(inp["dec"]), _j(bias), _j(al), _j(x), interpret=True,
            **tiles)
        got = ft.tiled_untied_sae_grads_plain(
            _t(e), _t(inp["dec"]), _t(bias), _t(al), _t(x), **tiles)
        names = ("dE", "dWn", "db")
    else:
        m = _mask(inp, family)
        ref = jft.tiled_tied_sae_grads(
            _j(e), _j(bias), _j(al), _j(x), interpret=True,
            coef_mask=None if m is None else _j(m), **tiles)
        got = ft.tiled_tied_sae_grads_plain(
            _t(e), _t(bias), _t(al), _t(x),
            coef_mask=None if m is None else _t(m), **tiles)
        names = ("dW", "db")
    _close_losses(got[0], ref[0])
    for i, name in enumerate(names, start=1):
        _close(got[i], ref[i], GRAD_TOL, name)
    np.testing.assert_array_equal(np.asarray(got[-2]), np.asarray(ref[-2]))
    _close(got[-1], ref[-1], GRAD_TOL, "grad_sq (kernel-grad norm, pre-VJP)")


@pytest.mark.parametrize("family,bias_decay", PRODUCER_CASES,
                         ids=PRODUCER_IDS)
def test_k3_producer_reports_the_kernel_grad_norm(inp, family, bias_decay):
    """The tiled producers' 4th output is √grad_sq of the kernel grads
    (before the normalization VJP and, untied, before the bias decay), as
    in the JAX package."""
    jf = (jft.fused_untied_sae_tiled_loss_and_grads if family == "untied"
          else jft.fused_tied_sae_tiled_loss_and_grads)
    tf = (ft.fused_untied_sae_tiled_loss_and_grads if family == "untied"
          else ft.fused_tied_sae_tiled_loss_and_grads)
    jargs, jkw = _producer_args(inp, family, bias_decay, _j)
    targs, tkw = _producer_args(inp, family, bias_decay, _t)
    tiles = dict(batch_tile=BATCH_TILE, feat_tile=FEAT_TILE)
    ref = jf(*jargs, interpret=True, **tiles, **jkw)
    got = tf(*targs, **tiles, **tkw)
    _close_losses(got[0], ref[0])
    for k in jargs[0]:
        _close(got[1][k], ref[1][k], GRAD_TOL, k)
    _close(got[3], ref[3], GRAD_TOL, "gnorm")


@pytest.mark.parametrize("family", ["tied", "untied"])
def test_k4_fused_tied_adam_vjp_update(inp, family):
    """K4 fused_tied_adam_vjp_update and K6 fused_adam_vjp_update
    (un_sq included) through the plain versions."""
    b1, b2, eps = ADAM
    if family == "untied":
        keys = ("e", "dw", "mu", "nu", "dec", "dwn", "mu_d", "nu_d", "lrs",
                "bc1", "bc2")
        jf, tf = jfs.fused_adam_vjp_update, fs.fused_adam_vjp_update_plain
        names = ("E'", "mu_E'", "nu_E'", "D'", "mu_D'", "nu_D'", "un_sq")
    else:
        keys = ("e", "dw", "mu", "nu", "lrs", "bc1", "bc2")
        jf, tf = (jfs.fused_tied_adam_vjp_update,
                  fs.fused_tied_adam_vjp_update_plain)
        names = ("E'", "mu'", "nu'", "un_sq")
    ref = jf(*(_j(inp[k]) for k in keys), ftile=FEAT_TILE, interpret=True,
             b1=b1, b2=b2, eps=eps)
    got = tf(*(_t(inp[k]) for k in keys), ftile=FEAT_TILE, b1=b1, b2=b2,
             eps=eps)
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        _close(g, r, LOSS_TOL, name)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_k4_plain_matches_jax_at_a_wide_row(moments):
    """sae_tied_adam_vjp_plain with the bias group against K4
    fused_tied_adam_vjp_update in interpret mode and the engine's
    _bias_adam_update at a row 2,048 wide (2 members x 16 rows), the width
    from which the CUDA kernel spreads a row over several warps. fp32 and
    bf16 moments (rounded once, the same bits on both sides): E', un_sq,
    fp32 moments and the bias group at LOSS_TOL; bf16 moments within one
    bf16 ulp (2⁻⁷ of each) plus 1e-5 of max|ref|."""
    from types import SimpleNamespace

    from sparse_coding_tpu.ensemble import _bias_adam_update

    b1, b2, eps = ADAM
    inp = kernel_inputs(seed=4, n_members=2, d=2048, n_feats=16, batch=32)
    jmom, tmom = [], []
    for k in ("mu", "nu"):
        j = jnp.asarray(inp[k]).astype(getattr(jnp, moments))
        jmom.append(j)
        tmom.append(_t(np.asarray(j.astype(jnp.float32))).to(
            getattr(torch, moments)))
    hyp = ("lrs", "bc1", "bc2")
    ref = jfs.fused_tied_adam_vjp_update(
        _j(inp["e"]), _j(inp["dw"]), *jmom, *(_j(inp[k]) for k in hyp),
        ftile=8, interpret=True, b1=b1, b2=b2, eps=eps)
    db = inp["dw"][:, :, 0].copy()
    opt = SimpleNamespace(mu={"encoder_bias": _j(inp["mu_b"])},
                          nu={"encoder_bias": _j(inp["nu_b"])})
    ref_b = _bias_adam_update(_j(inp["bias"]), _j(db), opt,
                              *(_j(inp[k]) for k in hyp), b1, b2, eps)
    got = fs.sae_tied_adam_vjp_plain(
        _t(inp["e"]), _t(inp["dw"]), *tmom, *(_t(inp[k]) for k in hyp),
        b1, b2, eps, bias=_t(inp["bias"]), db=_t(db), mu_b=_t(inp["mu_b"]),
        nu_b=_t(inp["nu_b"]))
    _close(got[0], ref[0], LOSS_TOL, "E'")
    _close(got[3], ref[3], LOSS_TOL, "un_sq")
    for name, g, r in zip(("mu'", "nu'"), got[1:3], ref[1:3]):
        assert g.dtype == getattr(torch, moments), name
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        if moments == "float32":
            _close(g, r, LOSS_TOL, name)
            continue
        bound = 2.0**-7 * np.abs(r) + 1e-5 * np.abs(r).max()
        assert (np.abs(g - r) <= bound).all(), name
    for name, g, r in zip(("b'", "mu_b'", "nu_b'"), got[4], ref_b):
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


@pytest.mark.parametrize("bias_decay", [0.0, 0.01])
def test_untied_bias_decay_terms(inp, bias_decay):
    """The decay loss bd·√(Σb² + 1e-16) and its gradient folded into db,
    including a member whose bias is all zero (the safe norm's finite
    gradient there)."""
    bias = inp["bias"].copy()
    bias[1] = 0.0
    bds = np.array([bias_decay, 0.02, 0.0], np.float32)
    ref = jfs.untied_bias_decay_terms(_j(bias), _j(bds), _j(inp["mu_b"]))
    got = fs.untied_bias_decay_terms(_t(bias), _t(bds), _t(inp["mu_b"]))
    _close(got[0], ref[0], LOSS_TOL, "decay loss")
    _close(got[1], ref[1], LOSS_TOL, "db + decay grad")
    assert np.isfinite(np.asarray(got[1])).all()


def _loss_case(inp, family):
    """(JAX signature, port signature, one member's params, buffers) with
    the terms the kernel paths do not take where the family has them: a
    non-identity centering and a bias decay (tied), a bias decay
    (untied); masked, a mask that leaves half the features active."""
    rs = np.random.default_rng(1)
    d = inp["e"].shape[2]
    params = {k: v[0] for k, v in _params(inp, family).items()}
    buffers = {"l1_alpha": np.float32(3e-3), "bias_decay": np.float32(0.01)}
    if family == "tied":
        q, _ = np.linalg.qr(rs.normal(size=(d, d)))
        buffers.update(center_rot=q.astype(np.float32),
                       center_trans=rs.normal(size=d).astype(np.float32),
                       center_scale=rs.uniform(0.5, 2, d).astype(np.float32))
        return jsae.FunctionalTiedSAE, tsae.FunctionalTiedSAE, params, buffers
    if family == "untied":
        return jsae.FunctionalSAE, tsae.FunctionalSAE, params, buffers
    n = inp["e"].shape[1]
    buffers.update(dict_size=np.int32(n // 2),
                   coef_mask=np.arange(n) < n // 2)
    return (jsae.FunctionalMaskedTiedSAE, tsae.FunctionalMaskedTiedSAE,
            params, buffers)


@pytest.mark.parametrize("family", FAMILIES)
def test_tied_sae_loss_and_autograd_match_jax_grad(inp, family):
    """Each family's ``loss`` and its autograd grads vs jax.grad."""
    jsig, tsig, params, buffers = _loss_case(inp, family)
    x = inp["x"]
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(
        jsig.loss, has_aux=True)(
        {k: _j(v) for k, v in params.items()},
        {k: _j(v) for k, v in buffers.items()}, _j(x))
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    loss, aux = tsig.loss(tp, {k: _t(v) for k, v in buffers.items()}, _t(x))
    loss.backward()
    _close(loss.detach(), ref_loss, LOSS_TOL, "loss")
    assert set(aux.losses) == set(ref_aux.losses)
    for k in aux.losses:
        _close(aux.losses[k].detach(), ref_aux.losses[k], LOSS_TOL, k)
    _close(aux.l0, ref_aux.l0, LOSS_TOL, "l0")
    np.testing.assert_array_equal(np.asarray(aux.feat_activity),
                                  np.asarray(ref_aux.feat_activity))
    for k in params:
        _close(tp[k].grad, ref_grads[k], GRAD_TOL, f"grad {k}")


CHUNKED = {  # kernel -> (its parts, the parts that are products)
    "sae_tied_fwd": (_build.TIED_FWD_PARTS, ("codes", "decode")),
    "sae_tied_bwd": (_build.TIED_BWD_PARTS, ("codes", "dpre", "dwx", "dwr")),
    "sae_untied_fwd": (_build.UNTIED_FWD_PARTS, ("codes", "decode")),
    "sae_untied_bwd": (_build.UNTIED_BWD_PARTS,
                       ("codes", "dpre", "de", "dwn")),
}


@pytest.mark.parametrize("kernel", list(CHUNKED))
def test_one_chunk_launches_name_every_part_in_order(inp, kernel):
    """one_chunk_launches (what chip_smoke.py and
    scripts/time_kernel_parts.py time launch by launch) lists each part of
    a chunked kernel once, in the order of its _build tuple, with
    2·N·B·n·d FLOPs for a product and 0 for the other passes; building
    the list launches nothing, and another kernel's name raises."""
    _build.reset_launches()
    e, dec, bias, al, x = (_t(inp[k]) for k in ("e", "dec", "bias",
                                                 "alphas", "x"))
    n_m, n, d = e.shape
    b = x.shape[0]
    r = torch.zeros((n_m, b, d))
    got = ft.one_chunk_launches(kernel, e, bias, x, decoder=dec, alphas=al,
                                resid=r)
    parts, products = CHUNKED[kernel]
    assert tuple(got) == parts
    gemm = 2.0 * n_m * b * n * d
    assert {k: f for k, (_, f) in got.items()} == {
        k: gemm if k[len(kernel) + 1:] in products else 0.0 for k in parts}
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError, match="not a chunked"):
        ft.one_chunk_launches("big_sae_bwd", e, bias, x)


@pytest.mark.parametrize("tiled", [False, True], ids=["k1_k5", "k3_k7"])
@pytest.mark.parametrize("family,bias_decay", PRODUCER_CASES,
                         ids=PRODUCER_IDS)
def test_bf16_compute_producers_match_jax(inp, family, bias_decay, tiled):
    """compute_dtype="bfloat16", which raised before it was ported, through
    the producers the ensemble calls (two-stage and tiled, the
    normalization VJP and the untied bias decay chained): losses rtol 1e-4
    and grads wrt the raw params within 1e-3 of max|ref| of the JAX
    producers in interpret mode (tests/test_torch_port_bf16.py states these
    bounds; worst seen here 1.2e-5, losses 4.7e-7)."""
    if tiled:
        jf = (jft.fused_untied_sae_tiled_loss_and_grads if family == "untied"
              else jft.fused_tied_sae_tiled_loss_and_grads)
        tf = (ft.fused_untied_sae_tiled_loss_and_grads if family == "untied"
              else ft.fused_tied_sae_tiled_loss_and_grads)
        tiles = dict(batch_tile=BATCH_TILE, feat_tile=FEAT_TILE)
    else:
        jf = (jfs.fused_untied_sae_loss_and_grads if family == "untied"
              else jfs.fused_tied_sae_loss_and_grads)
        tf = (fs.fused_untied_sae_loss_and_grads if family == "untied"
              else fs.fused_tied_sae_loss_and_grads)
        tiles = dict(batch_tile=BATCH_TILE)
    jargs, jkw = _producer_args(inp, family, bias_decay, _j)
    targs, tkw = _producer_args(inp, family, bias_decay, _t)
    ref = jf(*jargs, interpret=True, compute_dtype="bfloat16", **tiles,
             **jkw)
    got = tf(*targs, compute_dtype="bfloat16", **tiles, **tkw)
    for k in ref[0]:
        _close(got[0][k], ref[0][k], dict(rtol=1e-4), f"loss {k}")
    for k in jargs[0]:
        g, r = np.asarray(got[1][k]), np.asarray(ref[1][k])
        assert np.abs(g - r).max() <= 1e-3 * np.abs(r).max(), k
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))


BF16_FORMS = {
    "sae_tied_fwd_bf16": ("codes", "decode"),
    "sae_untied_fwd_bf16": ("codes", "decode"),
    "sae_tied_bwd_bf16": ("codes", "dpre", "dwx", "dwr"),
    "sae_untied_bwd_bf16": ("codes", "dpre", "de", "dwn"),
}


@pytest.mark.parametrize("kernel", list(BF16_FORMS))
def test_one_chunk_launches_bf16_name_every_part_in_order(inp, kernel):
    """one_chunk_launches_bf16 lists each part of a bf16 form once, in the
    order of its _build tuple (the call's roundings first), with 2·N·B·n·d
    FLOPs for a product and 0 for the other passes; building the list
    launches nothing, and another kernel's name raises."""
    _build.reset_launches()
    e, dec, bias, al, x = (_t(inp[k]) for k in ("e", "dec", "bias",
                                                 "alphas", "x"))
    n_m, n, d = e.shape
    b = x.shape[0]
    got = ft.one_chunk_launches_bf16(kernel, e, bias, x, decoder=dec,
                                     alphas=al, resid=torch.zeros((n_m, b, d)))
    parts = _build._PARTS[kernel]
    assert tuple(got) == parts and parts[0] == f"{kernel}_round"
    gemm = 2.0 * n_m * b * n * d
    assert {k: f for k, (_, f) in got.items()} == {
        k: gemm if k[len(kernel) + 1:] in BF16_FORMS[kernel] else 0.0
        for k in parts}
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert _build.LIBRARY_OF[parts[0]] == kernel[:-len("_bf16")]
    with pytest.raises(ValueError, match="not a chunked"):
        ft.one_chunk_launches_bf16("sae_tied_fwd", e, bias, x)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch(inp):
    """On CPU tensors every wrapper returns its plain version's result (the
    untied backward: its chunk schedule in plain torch, which
    tests/test_torch_port_untied_bwd_chunks.py holds against JAX) and
    never touches the launch counts; mixed devices or a CPU tensor handed
    to the CUDA checks raise."""
    _build.reset_launches()
    e, dec, bias, al, x = (_t(inp[k]) for k in ("e", "dec", "bias",
                                                 "alphas", "x"))
    cm = _t(inp["coef_mask"].astype(np.float32))
    exact = lambda g, p: torch.testing.assert_close(g, p, rtol=0, atol=0)
    for mask in (None, cm):
        r = ft.sae_tied_fwd(e, bias, x, mask)
        exact(r, ft.sae_tied_fwd_plain(e, bias, x, mask))
        for g, p in zip(ft.sae_tied_bwd(e, bias, al, x, r, mask),
                        ft.sae_tied_bwd_plain(e, bias, al, x, r, mask)):
            exact(g, p)
    r = ft.sae_untied_fwd(e, dec, bias, x)
    exact(r, ft.sae_untied_fwd_plain(e, dec, bias, x))
    for g, p in zip(ft.sae_untied_bwd(e, dec, bias, al, x, r),
                    ft._untied_bwd_chunked_plain(e, dec, bias, al, x, r)):
        exact(g, p)
    adam = [_t(inp[k]) for k in ("e", "dw", "mu", "nu", "lrs", "bc1", "bc2")]
    for g, p in zip(fs.sae_tied_adam_vjp(*adam)[:4],
                    fs.sae_tied_adam_vjp_plain(*adam)[:4]):
        exact(g, p)
    uadam = [_t(inp[k]) for k in ("e", "dw", "mu", "nu", "dec", "dwn",
                                  "mu_d", "nu_d", "lrs", "bc1", "bc2")]
    for g, p in zip(fs.sae_untied_adam_vjp(*uadam),
                    fs.sae_untied_adam_vjp_plain(*uadam)):
        exact(g, p)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError, match="not cuda"):
        _build.check_cuda_tensors("sae_tied_fwd", x=x)
    with pytest.raises(ValueError, match="go together"):
        fs.sae_tied_adam_vjp(*adam, bias=bias)


def test_shape_contract_raises(inp):
    """The JAX divisibility contract (batch % bt, n % ft, n % ftile)
    raises ValueError, as prepare_tiled_batch does; so do the kernels' own
    tile limits, mismatched operands, a total_batch below the call's rows
    and the unported options."""
    e, dec, bias, al, x = (_t(inp[k]) for k in ("e", "dec", "bias",
                                                 "alphas", "x"))
    with pytest.raises(ValueError, match="must be 0"):
        ft.tiled_tied_sae_grads(e, bias, al, x, batch_tile=48, feat_tile=16)
    with pytest.raises(ValueError, match="must be 0"):
        ft.tiled_untied_sae_grads(e, dec, bias, al, x, batch_tile=32,
                                  feat_tile=24)
    with pytest.raises(ValueError, match="tile pair"):
        ft.prepare_tiled_batch(x[:100], e.shape[1], None, None)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        _build.check_kernel_shape("sae_tied_fwd", 100, 64, 32)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        _build.check_kernel_shape("sae_untied_bwd", 128, 64,
                                  _build.MAX_D + 1)
    with pytest.raises(ValueError, match="decoder must be"):
        ft.sae_untied_fwd(e, dec[:, :32], bias, x)
    with pytest.raises(ValueError, match="coef_mask must be"):
        ft.sae_tied_fwd(e, bias, x, torch.ones(3, 32))
    uadam = [_t(inp[k]) for k in ("e", "dw", "mu", "nu", "dec", "dwn",
                                  "mu_d", "nu_d", "lrs", "bc1", "bc2")]
    with pytest.raises(ValueError, match="ftile"):
        fs.fused_adam_vjp_update(*uadam, ftile=48)
    with pytest.raises(NotImplementedError):
        fs.fused_tied_sae_grads(e, bias, al, x, compute_dtype="float16")
    with pytest.raises(ValueError, match="total_batch"):
        fs.fused_untied_sae_grads(e, dec, bias, al, x,
                                  total_batch=x.shape[0] // 2)
    with pytest.raises(ValueError, match="d % 8"):
        _build.check_kernel_shape("sae_tied_fwd", 128, 64, 36, "bfloat16")
    _build.check_kernel_shape("sae_tied_fwd", 128, 64, 36)


def test_roofline_paths_and_flop_model():
    """The port keeps the JAX package's four path labels, the paths each
    family has, and its FLOP model; the card's chooser defaults to
    train_step_tiled (masked: two_stage_tiled), honours a forced path,
    refuses one the family lacks, and resolves unfit shapes to autodiff
    with a reason."""
    from sparse_coding_tpu.ops import roofline as jroof

    assert set(roofline.KERNEL_PATHS) == set(jroof.KERNEL_PATHS)
    assert {f: set(p) for f, p in roofline.FAMILY_PATHS.items()} == \
        {f: set(p) for f, p in jroof.FAMILY_PATHS.items()}
    assert roofline.model_flops_per_activation(32, 2048, 512) == \
        jroof.model_flops_per_activation(32, 2048, 512)
    shape = dict(batch=2048, n_feats=2048, d=512)
    for family, default in (("tied", "train_step_tiled"),
                            ("untied", "train_step_tiled"),
                            ("masked_tied", "two_stage_tiled")):
        plan = roofline.choose_plan(**shape, family=family)
        assert (plan.path, plan.reason) == (default, "default")
        for path in roofline.FAMILY_PATHS[family]:
            assert roofline.choose_plan(**shape, family=family,
                                        forced_path=path).path == path
    for path in ("train_step", "train_step_tiled"):
        with pytest.raises(ValueError, match="two-stage kernels only"):
            roofline.choose_plan(**shape, family="masked_tied",
                                 forced_path=path)
    assert roofline.choose_plan(batch=100, n_feats=2048, d=512,
                                family="untied").path is None
    assert roofline.choose_plan(**shape, family=None).reason == \
        "family_ineligible"
