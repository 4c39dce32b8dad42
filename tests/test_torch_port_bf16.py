"""bf16 compute and bf16 Adam moments in the port's ensemble kernels
(``compute_dtype="bfloat16"``, ``fused_moments_dtype="bfloat16"``) against
the JAX package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_fused_kernel.py does; the port's side runs the plain PyTorch
versions, which round each dot operand to bf16 and back at the JAX
package's cast points and multiply in fp32. Both sides then add the same
exact products in fp32, in other orders, and round the same values (x, the
normalized dictionary or decoder, the raw untied encoder, the codes, r and
dpre) to bf16 — a value within a summation-order rounding of a bf16
rounding boundary may round the other way on one side. Tolerances, with
the worst value seen on the CPU beside each:

- contract parity (K1-K7): grads, db, the Adam epilogues' params and bias
  moments |Δ|max ≤ 1e-3 of max|ref| (``BF16_GRAD_SHARE``; worst 1.1e-5,
  K5's dWn); losses rtol 1e-4 (worst 4.7e-7); grad_sq rtol 2e-3 (worst
  5.9e-7) and the update norms rtol 1e-5 (worst 1.1e-7); activity exact;
- a bf16 moment leaf: that share plus one bf16 ulp of each element (at
  most 2**-7 of it: bf16 keeps 8 significant bits), after a trajectory one
  ulp of the largest element (worst 2.8e-3 of max|ref| after 6 steps);
- the port's bf16 contract against its own fp32 one: losses rtol 2e-2,
  the JAX package's own bf16-versus-f32 bound
  (tests/test_fused_kernel.py:202; worst 3.9e-4); grads ‖Δ‖/‖ref‖ ≤ 5e-2
  (worst 1.9e-2: bf16's 8-bit mantissa moves a pre-activation by ~2**-8
  of its size, which flips the ReLU mask of a feature that close to 0 and
  moves that feature's whole dpre·x term);
- the slice as a whole, 6 steps of ``Ensemble`` on every kernel path:
  per-step losses rtol 1e-4 (worst 4.7e-5), params after the steps
  |Δ|max ≤ 1e-3 of max|ref| (worst 1.8e-4);
- bf16 against fp32 moments: per-step losses rtol 5e-3, the JAX package's
  own bound (tests/test_fused_kernel.py:654; worst 1.2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ensemble import Ensemble as JaxEnsemble
from sparse_coding_tpu.models.sae import FunctionalMaskedTiedSAE as JaxMasked
from sparse_coding_tpu.models.sae import FunctionalSAE as JaxSAE
from sparse_coding_tpu.models.sae import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding_tpu.ops import fused_sae as jfs
from sparse_coding_tpu.ops import fused_sae_tiled as jft
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.models.sae import (
    FunctionalMaskedTiedSAE,
    FunctionalSAE,
    FunctionalTiedSAE,
)
from sparse_coding_tpu_torch.ops import fused_sae as fs
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft
from sparse_coding_tpu_torch.utils import checkpoint as ckpt
from sparse_coding_tpu_torch.utils.carry import (
    members_from_numpy,
    state_from_numpy,
)
from sparse_coding_tpu_torch.utils.orbax_ckpt import AsyncEnsembleCheckpointer
from torch_port_helpers import (
    BATCH_TILE,
    D,
    FEAT_TILE,
    L1S,
    N_FEATS,
    N_MEMBERS,
    batches,
    dict_sizes,
    kernel_inputs,
)

BF16_GRAD_SHARE = 1e-3
LOSS_RTOL = 1e-4
BF16_VS_F32_LOSS_RTOL = 2e-2
BF16_VS_F32_GRAD_FRO = 5e-2
MOMENT_RTOL = 2.0 ** -7
MOMENTS_LOSS_RTOL = 5e-3
BF16 = "bfloat16"
LRS = [1e-3, 2e-3, 3e-3]
N_STEPS = 6

# (members, d, n, batch): the shared small shape and a wider one, with a
# d that is a multiple of 8 and not of 32
SHAPES = [(3, 32, 64, 128), (3, 48, 128, 256)]
SHAPE_IDS = ["d32", "d48"]
BATCH_DTYPES = ["float32", "bfloat16"]


def _inputs(shape, seed=0):
    n_m, d, n, b = shape
    return kernel_inputs(seed=seed, n_members=n_m, d=d, n_feats=n, batch=b)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch_pair(x, batch_dtype):
    """The batch as JAX and the port take it: f32, or both bf16 from the
    same rounding (jnp's astype and torch's .to round to nearest even)."""
    if batch_dtype == "float32":
        return jnp.asarray(x), _t(x)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)


def _share(got, ref, what, share=BF16_GRAD_SHARE):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= share * scale, f"{what}: |Δ|max {err:.3e} > " \
        f"{share} x max|ref| {scale:.3e}"


def _losses(got, ref, rtol=LOSS_RTOL):
    for k in ("mse", "l1", "l0"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=rtol, err_msg=f"loss {k}")


def _mask(inp, masked):
    return inp["coef_mask"] if masked else None


# --- the rounding both sides use ----------------------------------------------

def test_bf16_rounding_matches_jax_bitwise():
    """torch's .to(bfloat16) — the plain versions' cast, and the kernels'
    __float2bfloat16_rn — rounds as jnp's astype: to nearest, ties to even,
    bit for bit on random values, exact ties, infinities and -0; NaN stays
    NaN (its payload is each library's own)."""
    rs = np.random.default_rng(3)
    x = rs.normal(size=4096).astype(np.float32) * 10.0 ** rs.integers(
        -30, 30, 4096)
    ties = (np.arange(256, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    x = np.concatenate([x, ties, [np.nan, np.inf, -0.0]]).astype(np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = _t(x).to(torch.bfloat16).to(torch.float32).numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  ref[~nan].view(np.uint32))


# --- K1-K7 contract parity ----------------------------------------------------

@pytest.mark.parametrize("batch_dtype", BATCH_DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k1_tied_grads_bf16_match_jax(shape, masked, batch_dtype):
    """K1 fused_tied_sae_grads under bf16 compute, with f32 and bf16
    batches, with and without the masked family's coef_mask."""
    inp = _inputs(shape)
    jx, tx = _batch_pair(inp["x"], batch_dtype)
    m = _mask(inp, masked)
    ref = jfs.fused_tied_sae_grads(
        jnp.asarray(inp["e"]), jnp.asarray(inp["bias"]),
        jnp.asarray(inp["alphas"]), jx, batch_tile=BATCH_TILE,
        interpret=True, compute_dtype=BF16,
        coef_mask=None if m is None else jnp.asarray(m))
    got = fs.fused_tied_sae_grads(
        _t(inp["e"]), _t(inp["bias"]), _t(inp["alphas"]), tx,
        compute_dtype=BF16, coef_mask=None if m is None else _t(m))
    _losses(got[0], ref[0])
    _share(got[1], ref[1], "dW")
    _share(got[2], ref[2], "db")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("batch_dtype", BATCH_DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k3_tiled_tied_grads_bf16_match_jax(shape, masked, batch_dtype):
    """K3 tiled_tied_sae_grads under bf16 compute (the feature-tiled
    forward accumulates x̂ over tiles in fp32 on the JAX side)."""
    inp = _inputs(shape)
    jx, tx = _batch_pair(inp["x"], batch_dtype)
    m = _mask(inp, masked)
    ref = jft.tiled_tied_sae_grads(
        jnp.asarray(inp["e"]), jnp.asarray(inp["bias"]),
        jnp.asarray(inp["alphas"]), jx, BATCH_TILE, FEAT_TILE,
        interpret=True, compute_dtype=BF16,
        coef_mask=None if m is None else jnp.asarray(m))
    got = ft.tiled_tied_sae_grads(
        _t(inp["e"]), _t(inp["bias"]), _t(inp["alphas"]), tx, BATCH_TILE,
        FEAT_TILE, compute_dtype=BF16,
        coef_mask=None if m is None else _t(m))
    _losses(got[0], ref[0])
    for name, g, r in zip(("dW", "db"), got[1:3], ref[1:3]):
        _share(g, r, name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]),
                               rtol=2 * BF16_GRAD_SHARE)


@pytest.mark.parametrize("batch_dtype", BATCH_DTYPES)
@pytest.mark.parametrize("tiled", [False, True], ids=["k5", "k7"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k5_k7_untied_grads_bf16_match_jax(shape, tiled, batch_dtype):
    """K5 fused_untied_sae_grads and K7 tiled_untied_sae_grads under bf16
    compute: the raw encoder and the normalized decoder rounded."""
    inp = _inputs(shape)
    jx, tx = _batch_pair(inp["x"], batch_dtype)
    jargs = [jnp.asarray(inp[k]) for k in ("e", "dec", "bias", "alphas")]
    targs = [_t(inp[k]) for k in ("e", "dec", "bias", "alphas")]
    if tiled:
        ref = jft.tiled_untied_sae_grads(*jargs, jx, BATCH_TILE, FEAT_TILE,
                                         interpret=True, compute_dtype=BF16)
        got = ft.tiled_untied_sae_grads(*targs, tx, BATCH_TILE, FEAT_TILE,
                                        compute_dtype=BF16)
        np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]),
                                   rtol=2 * BF16_GRAD_SHARE)
    else:
        ref = jfs.fused_untied_sae_grads(*jargs, jx, batch_tile=BATCH_TILE,
                                         interpret=True, compute_dtype=BF16)
        got = fs.fused_untied_sae_grads(*targs, tx, compute_dtype=BF16)
    _losses(got[0], ref[0])
    for name, g, r in zip(("dE", "dWn", "db"), got[1:4], ref[1:4]):
        _share(g, r, name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def _moments(inp, keys, bf16_moments):
    """The inputs' moments as both sides take them: f32, or rounded to
    bf16 once (the same bits on both sides)."""
    out = []
    for k in keys:
        j = jnp.asarray(inp[k])
        if bf16_moments:
            j = j.astype(jnp.bfloat16)
            out.append((j, _t(np.asarray(j.astype(jnp.float32)))
                        .to(torch.bfloat16)))
        else:
            out.append((j, _t(inp[k])))
    return out


def _moment_close(got, ref, what, trajectory=False):
    """A moment leaf: its dtype, then the grads' share bound — plus, for a
    bf16 leaf, one bf16 ulp of each element (the same fp32 moment a
    summation-order rounding apart may round to a neighbouring bf16); after
    a trajectory, one ulp of the largest element (a step's flip decays by
    b1 or b2 a step while the element shrinks)."""
    bf16 = ref.dtype == jnp.bfloat16
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32), what
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    ulp_of = np.abs(r).max() if trajectory else np.abs(r)
    bound = BF16_GRAD_SHARE * np.abs(r).max() + (
        MOMENT_RTOL * ulp_of if bf16 else 0.0)
    assert (np.abs(g - r) <= bound).all(), \
        f"{what}: |Δ|max {np.abs(g - r).max():.3e}"


@pytest.mark.parametrize("bf16_moments", [False, True],
                         ids=["f32_moments", "bf16_moments"])
@pytest.mark.parametrize("batch_dtype", BATCH_DTYPES)
def test_k2_train_step_bf16_matches_jax(batch_dtype, bf16_moments):
    """K2 fused_tied_sae_train_step under bf16 compute, with fp32 and bf16
    encoder moments (the bias moments stay fp32)."""
    inp = _inputs(SHAPES[1])
    jx, tx = _batch_pair(inp["x"], batch_dtype)
    (jmu, tmu), (jnu, tnu) = _moments(inp, ("mu", "nu"), bf16_moments)
    rest = ("mu_b", "nu_b", "alphas", "lrs", "bc1", "bc2")
    ref = jfs.fused_tied_sae_train_step(
        jnp.asarray(inp["e"]), jnp.asarray(inp["bias"]), jmu, jnu,
        *(jnp.asarray(inp[k]) for k in rest), jx, batch_tile=BATCH_TILE,
        interpret=True, compute_dtype=BF16)
    got = fs.fused_tied_sae_train_step(
        _t(inp["e"]), _t(inp["bias"]), tmu, tnu, *(_t(inp[k]) for k in rest),
        tx, compute_dtype=BF16)
    _losses(got[0], ref[0])
    _share(got[1], ref[1], "E'")
    _share(got[2], ref[2], "b'")
    _moment_close(got[3], ref[3], "mu_e'")
    _moment_close(got[4], ref[4], "nu_e'")
    _share(got[5], ref[5], "mu_b'")
    _share(got[6], ref[6], "nu_b'")
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(ref[7]))


@pytest.mark.parametrize("bf16_moments", [False, True],
                         ids=["f32_moments", "bf16_moments"])
def test_k4_k6_adam_epilogues_match_jax(bf16_moments):
    """K4 fused_tied_adam_vjp_update and K6 fused_adam_vjp_update with
    fp32 and bf16 moments: read widened, updated in fp32, stored rounded,
    the update from this step's fp32 moments."""
    inp = _inputs(SHAPES[1])
    (jmu, tmu), (jnu, tnu), (jmd, tmd), (jnd, tnd) = _moments(
        inp, ("mu", "nu", "mu_d", "nu_d"), bf16_moments)
    hyp = ("lrs", "bc1", "bc2")
    ref = jfs.fused_tied_adam_vjp_update(
        jnp.asarray(inp["e"]), jnp.asarray(inp["dw"]), jmu, jnu,
        *(jnp.asarray(inp[k]) for k in hyp), ftile=FEAT_TILE, interpret=True)
    got = fs.fused_tied_adam_vjp_update(
        _t(inp["e"]), _t(inp["dw"]), tmu, tnu, *(_t(inp[k]) for k in hyp),
        ftile=FEAT_TILE)
    _share(got[0], ref[0], "K4 E'")
    _moment_close(got[1], ref[1], "K4 mu'")
    _moment_close(got[2], ref[2], "K4 nu'")
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-5)

    ref = jfs.fused_adam_vjp_update(
        jnp.asarray(inp["e"]), jnp.asarray(inp["dw"]), jmu, jnu,
        jnp.asarray(inp["dec"]), jnp.asarray(inp["dwn"]), jmd, jnd,
        *(jnp.asarray(inp[k]) for k in hyp), ftile=FEAT_TILE, interpret=True)
    got = fs.fused_adam_vjp_update(
        _t(inp["e"]), _t(inp["dw"]), tmu, tnu, _t(inp["dec"]),
        _t(inp["dwn"]), tmd, tnd, *(_t(inp[k]) for k in hyp),
        ftile=FEAT_TILE)
    for i, name in enumerate(("E'", "mu_e'", "nu_e'", "D'", "mu_d'",
                              "nu_d'")):
        if name.startswith(("mu", "nu")):
            _moment_close(got[i], ref[i], f"K6 {name}")
        else:
            _share(got[i], ref[i], f"K6 {name}")
    np.testing.assert_allclose(got[6].numpy(), np.asarray(ref[6]), rtol=1e-5)


def test_bf16_moment_plain_version_updates_from_fp32_moments():
    """The epilogue's update takes this step's fp32 moments, not their bf16
    roundings (sparse_coding_tpu/ops/fused_sae.py _tied_train_kernel): the
    bf16-moment E' equals the fp32-moment E' bitwise from the same bf16
    moments widened, while the stored moments are those rounded."""
    inp = _inputs(SHAPES[0])
    args = [_t(inp[k]) for k in ("e", "dw")]
    hyp = [_t(inp[k]) for k in ("lrs", "bc1", "bc2")]
    mu = _t(inp["mu"]).to(torch.bfloat16)
    nu = _t(inp["nu"]).to(torch.bfloat16)
    got = fs.sae_tied_adam_vjp(*args, mu, nu, *hyp)
    ref = fs.sae_tied_adam_vjp(*args, mu.float(), nu.float(), *hyp)
    assert torch.equal(got[0], ref[0])
    assert got[1].dtype == torch.bfloat16
    assert torch.equal(got[1], ref[1].to(torch.bfloat16))
    assert torch.equal(got[2], ref[2].to(torch.bfloat16))
    assert torch.equal(got[3], ref[3])


# --- bf16 against fp32 ---------------------------------------------------------

@pytest.mark.parametrize("family", ["tied", "masked_tied", "untied"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bf16_contract_approximates_fp32(shape, family):
    """The port's bf16 contract (K3/K7, the ensemble's default paths)
    against its own fp32 one: the same function, approximated, within the
    JAX package's bf16-versus-f32 bounds."""
    inp = _inputs(shape)
    e, bias, al, x = (_t(inp[k]) for k in ("e", "bias", "alphas", "x"))
    if family == "untied":
        call = lambda cd: ft.tiled_untied_sae_grads(
            e, _t(inp["dec"]), bias, al, x, BATCH_TILE, FEAT_TILE,
            compute_dtype=cd)
    else:
        m = _mask(inp, family == "masked_tied")
        call = lambda cd: ft.tiled_tied_sae_grads(
            e, bias, al, x, BATCH_TILE, FEAT_TILE, compute_dtype=cd,
            coef_mask=None if m is None else _t(m))
    got, ref = call(BF16), call("float32")
    total = lambda o: (o[0]["mse"] + o[0]["l1"]).numpy()
    np.testing.assert_allclose(total(got), total(ref),
                               rtol=BF16_VS_F32_LOSS_RTOL)
    for g, r in zip(got[1:-2], ref[1:-2]):
        assert (torch.linalg.vector_norm(g - r)
                <= BF16_VS_F32_GRAD_FRO * torch.linalg.vector_norm(r))


# --- the Ensemble: moments, the slice, state ---------------------------------

SIGS = {"tied": (JaxTiedSAE, FunctionalTiedSAE),
        "untied": (JaxSAE, FunctionalSAE),
        "masked_tied": (JaxMasked, FunctionalMaskedTiedSAE)}
PATHS = ["two_stage", "train_step", "two_stage_tiled", "train_step_tiled"]
SLICE_CASES = ([(f, p) for f in ("tied", "untied") for p in PATHS]
               + [("masked_tied", p) for p in ("two_stage", "two_stage_tiled")])


def _jax_members(family, seed=0):
    sig = SIGS[family][0]
    keys = jax.random.split(jax.random.PRNGKey(seed), N_MEMBERS)
    kw = {"bias_decay": 0.01} if family == "untied" else {}
    if family == "masked_tied":
        return [sig.init(k, D, n, N_FEATS, l1_alpha=l1)
                for k, n, l1 in zip(keys, dict_sizes(), L1S)]
    return [sig.init(k, D, N_FEATS, l1_alpha=l1, **kw)
            for k, l1 in zip(keys, L1S)]


def _pair(family, path, **opts):
    """A JAX Ensemble (interpret mode) and the port's twin from the same
    members, with the same options."""
    sig, port_sig = SIGS[family]
    jm = _jax_members(family)
    tiles = dict(fused_batch_tile=BATCH_TILE)
    if path.endswith("_tiled"):
        tiles["fused_feat_tile"] = FEAT_TILE
    jens = JaxEnsemble(jm, sig, lr=LRS, donate=False, use_fused=True,
                       fused_interpret=True, fused_path=path, **tiles,
                       **opts)
    tens = Ensemble(members_from_numpy(jax.device_get(jm)), port_sig, lr=LRS,
                    device="cpu", use_fused=True, fused_path=path, **opts)
    return jens, tens


def _params_close(jens, tens, what):
    s = jax.device_get(jens.state)
    for k in s.params:
        _share(tens.state.params[k], s.params[k], f"{what}: {k}")


@pytest.mark.parametrize("batch_dtype", BATCH_DTYPES)
@pytest.mark.parametrize("case", SLICE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_slice_bf16_compute_matches_jax(case, batch_dtype):
    """The slice as a whole: ``Ensemble(..., fused_compute_dtype=
    "bfloat16")`` on each kernel path of each family, f32 or bf16 batches,
    6 steps from one init against the JAX Ensemble with the same options;
    the port keeps a bf16 batch bf16 into its kernels."""
    family, path = case
    jens, tens = _pair(family, path, fused_compute_dtype=BF16)
    for i, b in enumerate(batches(seed=2, n=N_STEPS)):
        jb, tb = _batch_pair(b, batch_dtype)
        ja, ta = jens.step_batch(jb), tens.step_batch(tb)
        for k in ja.losses:
            np.testing.assert_allclose(ta.losses[k].numpy(),
                                       np.asarray(ja.losses[k]),
                                       rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
        np.testing.assert_array_equal(ta.feat_activity.numpy(),
                                      np.asarray(ja.feat_activity))
    assert tens.fused_path == jens.fused_path == path
    _params_close(jens, tens, f"after {N_STEPS} steps")


@pytest.mark.parametrize("path", ["train_step", "train_step_tiled"])
@pytest.mark.parametrize("family", ["tied", "untied"])
def test_bf16_moments_match_jax(family, path):
    """``fused_moments_dtype="bfloat16"`` (with bf16 compute and bf16
    batches, bench.py's last variant): the encoder and decoder moments are
    bf16 by name and the bias moments fp32 on both sides; the trajectory
    tracks the JAX Ensemble's, and the losses stay within rtol 5e-3 of the
    fp32-moment run's."""
    opts = dict(fused_compute_dtype=BF16, fused_moments_dtype=BF16)
    jens, tens = _pair(family, path, **opts)
    _, tref = _pair(family, path, fused_compute_dtype=BF16)
    for k, v in tens.state.mu.items():
        want = torch.bfloat16 if k in ("encoder", "decoder") else torch.float32
        assert v.dtype == want and tens.state.nu[k].dtype == want, k
        assert jens.state.opt_state.mu[k].dtype == (
            jnp.bfloat16 if want == torch.bfloat16 else jnp.float32)
    for i, b in enumerate(batches(seed=4, n=N_STEPS)):
        jb, tb = _batch_pair(b, BF16)
        ja, ta, tr = (jens.step_batch(jb), tens.step_batch(tb),
                      tref.step_batch(tb))
        np.testing.assert_allclose(ta.losses["loss"].numpy(),
                                   np.asarray(ja.losses["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(ta.losses["loss"].numpy(),
                                   tr.losses["loss"].numpy(),
                                   rtol=MOMENTS_LOSS_RTOL)
    _params_close(jens, tens, f"after {N_STEPS} steps")
    s = jax.device_get(jens.state)
    for k in ("encoder", "decoder"):
        if k in s.params:
            _moment_close(tens.state.mu[k], s.opt_state.mu[k], f"mu {k}",
                          trajectory=True)
            _moment_close(tens.state.nu[k], s.opt_state.nu[k], f"nu {k}",
                          trajectory=True)


@pytest.mark.parametrize("opts", [
    dict(fused_moments_dtype="float16"),
    dict(fused_moments_dtype=BF16),
    dict(fused_moments_dtype=BF16, fused_path="two_stage"),
    dict(fused_moments_dtype=BF16, fused_path="two_stage_tiled"),
], ids=["float16", "no_path", "two_stage", "two_stage_tiled"])
def test_moments_misuse_raises_as_jax(opts):
    """The JAX package's ValueErrors, word for word, for the same misuses
    of fused_moments_dtype."""
    jm = _jax_members("tied")
    with pytest.raises(ValueError) as jerr:
        JaxEnsemble(jm, JaxTiedSAE, fused_interpret=True, **opts)
    with pytest.raises(ValueError) as terr:
        Ensemble(members_from_numpy(jax.device_get(jm)), FunctionalTiedSAE,
                 device="cpu", **opts)
    assert str(terr.value) == str(jerr.value)


def test_bf16_moment_state_carries_and_checkpoints_bitwise(tmp_path):
    """A bf16-moment state keeps its leaves' dtypes and bits through
    utils/carry (from the JAX Ensemble's state), both checkpoint backends
    (msgpack's save_ensemble and the orbax deferred-swap writer) and
    resume: the restored run's next steps equal the uninterrupted run's
    bitwise."""
    opts = dict(fused_compute_dtype=BF16, fused_moments_dtype=BF16)
    jens, tens = _pair("untied", "train_step_tiled", **opts)
    data = batches(seed=5, n=4)
    for b in data[:2]:
        jens.step_batch(jnp.asarray(b))
    s = jax.device_get(jens.state)
    assert s.opt_state.mu["encoder"].dtype == jnp.bfloat16
    tens.state = state_from_numpy(
        params=s.params, buffers=s.buffers, mu=s.opt_state.mu,
        nu=s.opt_state.nu, count=s.opt_state.count, lrs=s.lrs, live=s.live,
        step=s.step, static_buffers=s.static_buffers, sig_name=s.sig_name)
    for k in ("encoder", "decoder"):
        for tree, jtree in ((tens.state.mu, s.opt_state.mu),
                            (tens.state.nu, s.opt_state.nu)):
            assert tree[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tree[k].view(torch.int16).numpy(),
                np.asarray(jtree[k]).view(np.int16))
    assert tens.state.mu["encoder_bias"].dtype == torch.float32

    def fresh():
        return Ensemble(members_from_numpy(jax.device_get(
            _jax_members("untied"))), FunctionalSAE, lr=LRS, device="cpu",
            use_fused=True, fused_path="train_step_tiled", **opts)

    def same_state(a, b):
        for tree in ("params", "mu", "nu"):
            for k, v in getattr(a.state, tree).items():
                w = getattr(b.state, tree)[k]
                assert v.dtype == w.dtype and torch.equal(v, w), (tree, k)

    ckpt.save_ensemble(tens, tmp_path / "m.tensors")
    writer = AsyncEnsembleCheckpointer()
    writer.save(tens, tmp_path / "o.tensors")
    writer.close()
    assert ((tmp_path / "m.tensors").read_bytes()
            == (tmp_path / "o.tensors").read_bytes())
    for name in ("m.tensors", "o.tensors"):
        back = fresh()
        ckpt.restore_ensemble(back, tmp_path / name)
        same_state(back, tens)
    resumed = fresh()
    ckpt.restore_ensemble(resumed, tmp_path / "m.tensors")
    for b in data[2:]:
        ta = tens.step_batch(torch.from_numpy(b))
        ra = resumed.step_batch(torch.from_numpy(b))
        assert torch.equal(ta.losses["loss"], ra.losses["loss"])
    same_state(resumed, tens)
