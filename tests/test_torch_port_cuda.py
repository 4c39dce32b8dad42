"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs. Card only: every test carries the
``cuda`` marker and skips without a card. This file imports no JAX (the
card's host has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: rtol 1e-5 of max|ref| for the residual, losses and the Adam
epilogue (the same f32 formulas summed in another order); rtol 1e-3 of
max|ref| for gradients and activity exact — at these small shapes no
pre-activation lies within rounding of 0 (chip_smoke.py states the bounds
at the main path's shapes, where a few masks can flip)."""

import math

import pytest
import torch

from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops import fused_sae as fs
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

SHAPES = [(3, 96, 96, 40), (2, 64, 64, 300), (2, 32, 64, 600)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _inputs(card, n_m, b, n, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    lim = math.sqrt(6.0 / (n + d))
    t = lambda *s: torch.randn(s, generator=g)
    return {
        "e": ((torch.rand((n_m, n, d), generator=g) * 2 - 1) * lim).to(card),
        "bias": (t(n_m, n) * 0.01).to(card),
        "alphas": torch.logspace(-3, -1, n_m).to(card),
        "x": t(b, d).to(card),
        "dw": (t(n_m, n, d) * 1e-3).to(card),
        "mu": (t(n_m, n, d) * 1e-3).to(card),
        "nu": ((torch.rand((n_m, n, d), generator=g) + 0.5) * 1e-6).to(card),
        "lrs": torch.full((n_m,), 1e-3).to(card),
        "bc1": torch.full((n_m,), 0.5).to(card),
        "bc2": torch.full((n_m,), 0.01).to(card),
    }


def _close(got, ref, rtol):
    err = float((got - ref).abs().max())
    assert err <= rtol * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fwd_and_bwd_kernels_match_plain(card, shape):
    i = _inputs(card, *shape)
    _build.reset_launches()
    r = ft.sae_tied_fwd(i["e"], i["bias"], i["x"])
    _close(r, ft.sae_tied_fwd_plain(i["e"], i["bias"], i["x"]), 1e-5)
    got = ft.sae_tied_bwd(i["e"], i["bias"], i["alphas"], i["x"], r)
    ref = ft.sae_tied_bwd_plain(i["e"], i["bias"], i["alphas"], i["x"], r)
    torch.cuda.synchronize()
    _close(got[0], ref[0], 1e-3)
    _close(got[1], ref[1], 1e-3)
    assert torch.equal(got[2], ref[2])
    _close(got[3], ref[3], 1e-4)
    assert _build.LAUNCHES["sae_tied_fwd"] == 1
    assert _build.LAUNCHES["sae_tied_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
def test_adam_vjp_kernel_matches_plain(card, with_bias):
    i = _inputs(card, 3, 32, 96, 200)
    args = [i[k] for k in ("e", "dw", "mu", "nu", "lrs", "bc1", "bc2")]
    kw = {}
    if with_bias:
        kw = dict(bias=i["bias"], db=i["dw"][:, :, 0].contiguous(),
                  mu_b=i["mu"][:, :, 1].contiguous(),
                  nu_b=i["nu"][:, :, 1].contiguous())
    got = fs.sae_tied_adam_vjp(*args, **kw)
    ref = fs.sae_tied_adam_vjp_plain(*args, **kw)
    for g, r in zip(got[:4], ref[:4]):
        _close(g, r, 1e-5)
    if with_bias:
        for g, r in zip(got[4], ref[4]):
            _close(g, r, 1e-5)


@pytest.mark.cuda
def test_nan_propagates_through_the_kernels(card):
    """A NaN row must reach the losses (the sentinel keys on them): the
    kernels' ReLU and norm clip keep NaN, as torch.relu and clamp do."""
    i = _inputs(card, 2, 64, 64, 40)
    i["e"][1, 5, 0] = float("nan")
    r = ft.sae_tied_fwd(i["e"], i["bias"], i["x"])
    loss4 = ft.sae_tied_bwd(i["e"], i["bias"], i["alphas"], i["x"], r)[3]
    torch.cuda.synchronize()
    assert torch.isfinite(loss4[0]).all()
    assert not torch.isfinite(loss4[1, :2]).all()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    i = _inputs(card, 2, 64, 64, 40)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"][:48])
    with pytest.raises(ValueError, match="not contiguous"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"].t().contiguous().t())
    with pytest.raises(ValueError, match="float32"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"].half())
    with pytest.raises(ValueError, match="split between"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"].cpu())


@pytest.mark.cuda
def test_ensemble_refuses_a_shape_the_kernels_do_not_take(card):
    """On the card an eligible bucket at d=1024 (above the kernels' limit)
    raises at its first step; with use_fused=False it trains on autodiff
    and launches no kernel."""
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE

    g = torch.Generator().manual_seed(0)
    members = [FunctionalTiedSAE.init(g, 1024, 64, l1_alpha=l1)
               for l1 in (1e-3, 1e-2)]
    x = torch.randn((64, 1024), generator=g).to(card)
    with pytest.raises(ValueError, match="do not take"):
        Ensemble(members, FunctionalTiedSAE, device=card).step_batch(x)
    _build.reset_launches()
    aux = Ensemble(members, FunctionalTiedSAE, device=card,
                   use_fused=False).step_batch(x)
    torch.cuda.synchronize()
    assert torch.isfinite(aux.losses["loss"]).all()
    assert all(v == 0 for v in _build.LAUNCHES.values())
