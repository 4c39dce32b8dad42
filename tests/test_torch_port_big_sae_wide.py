"""The giant SAE's kernels (K8 ``big_sae_forward``, K9 ``big_sae_backward``)
at an LM's MLP width: d = 2048 (Pythia-70M's d_mlp) and 4096 (the widest
the port's kernels take, ``_build.BIG_MAX_D``), on the CPU.

The JAX kernels run in Pallas interpret mode at small batch and feature
counts; the port's wrappers run their plain versions (CPU tensors) on the
same seeded numpy inputs. Tolerances: fp32 x̂ rtol 1e-5 and grads rtol
2e-4 (``test_torch_port_big_sae.py``'s bounds, the JAX package's
fused-vs-autodiff bound); bf16 every output within 1e-3 of max|ref|
(``test_torch_port_big_sae_bf16.py``'s ``BF16_GRAD_SHARE``) and dctr
within 1e-4 (its ``DCTR_SHARE``), l0 exact. Then the gate: the tile pick,
the kernels' shape check and the trainer's fused choice admit d ≤ 4096
and refuse beyond, naming the sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_big_sae as jfb
from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops import fused_big_sae as tfb
from sparse_coding_tpu_torch.train import big_sae as tbs

B, N = 64, 64
WIDE = (2048, 4096)
BF16 = "bfloat16"
OUTPUTS = ("dE", "dWn", "dt", "dctr_enc", "c_totals", "l1_l0")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _inputs(d: int, seed: int = 0):
    """Raw params (a unit dictionary, an encoder, small thresholds and
    centre), a centered batch and a residual, as numpy."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dictionary = rs.normal(size=(N, d))
    dictionary /= np.linalg.norm(dictionary, axis=-1, keepdims=True)
    p = {"dict": f32(dictionary),
         "encoder": f32(rs.normal(size=(d, N)) / np.sqrt(d)),
         "threshold": f32(rs.normal(size=N) * 0.05),
         "centering": f32(rs.normal(size=d) * 0.1)}
    xc = f32(rs.normal(size=(B, d)))
    r = f32(rs.normal(size=(B, d)) * 0.3)
    return p, xc, r


def _share(got, ref, what: str, share: float) -> None:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= share * scale, (f"{what}: |Δ|max {err:.3e} > {share} x "
                                  f"{scale:.3e}")


@pytest.mark.parametrize("compute_dtype", ["float32", BF16])
@pytest.mark.parametrize("d", WIDE)
def test_wide_forward_matches_jax(d, compute_dtype):
    p, xc, _ = _inputs(d)
    want = jfb.big_sae_forward(p, jnp.asarray(xc), batch_tile=32,
                               feat_tile=32, interpret=True,
                               compute_dtype=compute_dtype)
    tp = {k: _t(v) for k, v in p.items()}
    got = tfb.big_sae_forward(tp, _t(xc), compute_dtype=compute_dtype)
    if compute_dtype == BF16:
        _share(got, want, "x̂", 1e-3)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", BF16])
@pytest.mark.parametrize("d", WIDE)
def test_wide_backward_matches_jax(d, compute_dtype):
    p, xc, r = _inputs(d, seed=1)
    alpha = np.float32(3e-3)
    want = jfb.big_sae_backward(p, jnp.asarray(alpha), jnp.asarray(xc),
                                jnp.asarray(r), batch_tile=32, feat_tile=32,
                                interpret=True, compute_dtype=compute_dtype)
    got = tfb.big_sae_backward({k: _t(v) for k, v in p.items()},
                               torch.tensor(alpha), _t(xc), _t(r),
                               compute_dtype=compute_dtype)
    for name, g, w in zip(OUTPUTS, got, want):
        if name == "l1_l0":
            assert float(g[1]) == float(w[1]), "l0"
            np.testing.assert_allclose(float(g[0]), float(w[0]), rtol=1e-5)
        elif compute_dtype == BF16:
            _share(g, w, name, 1e-4 if name == "dctr_enc" else 1e-3)
        elif name == "c_totals":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("d", [1024, 1025, 1032, 1500, 2048, 3072, 4096,
                               4097, 4104, 5120])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
def test_tile_pick_and_shape_check_admit_up_to_4096(d, itemsize):
    """pick_big_sae_tiles admits BigSAEArgs' batch and features at d
    exactly when the kernels' shape check does: d ≤ 4096 (and d % 8 == 0
    in bf16); beyond, the check names the sizes the kernels take."""
    compute = BF16 if itemsize == 2 else "float32"
    takes = d <= 4096 and (itemsize == 4 or d % 8 == 0)
    assert _build.BIG_MAX_D == _build.MAX_D == 4096
    assert (tfb.pick_big_sae_tiles(65536, 16384, d, itemsize)
            is not None) == takes
    if takes:
        _build.check_big_shape("big_sae_fwd", 65536, 16384, d, compute)
    else:
        with pytest.raises(ValueError, match=r"d <= 4096|d % 8"):
            _build.check_big_shape("big_sae_fwd", 65536, 16384, d, compute)


@pytest.mark.parametrize("d", [2048, 4096])
def test_trainer_takes_the_kernels_at_wide_d(d):
    """use_fused=True at d = 2048 and 4096 runs the kernels' path (their
    plain versions here) and agrees with autodiff on the step's metrics;
    the auto choice at BigSAEArgs' batch and features takes the kernels
    there, as at d = 1024."""
    gen = torch.Generator().manual_seed(0)
    state, _, _ = tbs.init_big_sae(gen, d, N, 1e-3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, d)).astype(np.float32))
    metrics = {}
    for fused in (True, False):
        step = tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3),
                                     torch.tensor(1e-3), use_fused=fused)
        metrics[fused] = step(state, x)[1]
    for k, v in metrics[True].items():
        np.testing.assert_allclose(float(v), float(metrics[False][k]),
                                   rtol=1e-4, err_msg=k)
    assert tbs.fused_auto_choice(
        "auto", tfb.pick_big_sae_tiles(65536, 16384, d) is not None,
        65536, 16384)


def test_trainer_refuses_past_4096_naming_the_sizes():
    """use_fused=True at d = 4104 raises, naming 1 <= d <= 4096."""
    gen = torch.Generator().manual_seed(0)
    d = 4104
    state, _, _ = tbs.init_big_sae(gen, d, N, 1e-3, device="cpu")
    step = tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3), torch.tensor(1e-3),
                                 use_fused=True)
    with pytest.raises(ValueError, match="1 <= d <= 4096"):
        step(state, torch.zeros((B, d)))
    with pytest.raises(ValueError, match="d <= 4096"):
        tfb.fused_big_sae_loss_and_grads(
            state.params, torch.zeros((B, d)),
            1e-3, False)
