"""The port's CUDA kernels on the card (the tied kernels with and without
the masked family's coef_mask, the untied ones — the four chunked
ensemble kernels, the tied and untied forwards and backwards, also in
several chunks —, and the giant single SAE's pair, also in several
chunks; and their bf16 forms), each held against its plain PyTorch
version on the same inputs. Card only:
every test carries the ``cuda`` marker and skips without a card. This file
imports no JAX (the card's host has none), so it runs there on its own:

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

SHAPES = [(3, 96, 96, 40), (2, 64, 64, 300), (2, 32, 64, 600),
          (2, 32, 64, 768)]
FAMILIES = ["tied", "masked_tied", "untied"]


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
        "dec": ((torch.rand((n_m, n, d), generator=g) * 2 - 1) * lim)
        .to(card),
        # mixed dictionary sizes: member i keeps its first n/(i+1) features
        "cm": (torch.arange(n)[None, :]
               < (n // torch.arange(1, n_m + 1))[:, None]).float().to(card),
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


def _fwd_bwd(i, family, plain=False):
    """(fwd, bwd) of the family as closures over ``i``: the kernels'
    wrappers, or their plain versions."""
    e, bias, al, x = i["e"], i["bias"], i["alphas"], i["x"]
    if family == "untied":
        fwd, bwd = ((ft.sae_untied_fwd_plain, ft.sae_untied_bwd_plain)
                    if plain else (ft.sae_untied_fwd, ft.sae_untied_bwd))
        return (lambda: fwd(e, i["dec"], bias, x),
                lambda r: bwd(e, i["dec"], bias, al, x, r))
    cm = i["cm"] if family == "masked_tied" else None
    fwd, bwd = ((ft.sae_tied_fwd_plain, ft.sae_tied_bwd_plain) if plain
                else (ft.sae_tied_fwd, ft.sae_tied_bwd))
    return (lambda: fwd(e, bias, x, cm),
            lambda r: bwd(e, bias, al, x, r, cm))


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fwd_and_bwd_kernels_match_plain(card, shape, family):
    i = _inputs(card, *shape)
    kfwd, kbwd = _fwd_bwd(i, family)
    pfwd, pbwd = _fwd_bwd(i, family, plain=True)
    _build.reset_launches()
    r = kfwd()
    _close(r, pfwd(), 1e-5)
    got, ref = kbwd(r), pbwd(r)
    torch.cuda.synchronize()
    for g, rf in zip(got[:-2], ref[:-2]):  # the weight grads, db
        _close(g, rf, 1e-3)
    assert torch.equal(got[-2], ref[-2])
    _close(got[-1], ref[-1], 1e-4)
    prefix = "sae_untied" if family == "untied" else "sae_tied"
    assert _build.LAUNCHES[f"{prefix}_fwd"] == 1
    assert _build.LAUNCHES[f"{prefix}_bwd"] == 1


@pytest.mark.cuda
def test_untied_adam_vjp_kernel_matches_plain(card):
    i = _inputs(card, 3, 32, 96, 200)
    args = [i[k] for k in ("e", "dw", "mu", "nu", "dec")]
    args += [i["dw"].flip(0).contiguous(), i["mu"].flip(0).contiguous(),
             i["nu"].flip(0).contiguous()]
    args += [i[k] for k in ("lrs", "bc1", "bc2")]
    got = fs.sae_untied_adam_vjp(*args)
    ref = fs.sae_untied_adam_vjp_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


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


# sae_tied_adam_vjp at widths that take each row layout: one warp a row
# (1, 40), two (600, 1000), four (2048), eight (4096, kMaxD) and the
# widths past it, whose threads read the rest of the row again in each
# pass (4100: fp32 rows on 16 bytes, bf16 ones not; 5000)
ADAM_WIDTHS = [1, 40, 600, 1000, 2048, 4096, 4100, 5000]
MOMENTS = ["float32", "bfloat16"]


def _adam_args(card, d, moments, with_bias, seed=0):
    """(args, kw) of sae_tied_adam_vjp on 2 members x 16 rows x d: the
    moments in ``moments``, the bias group when ``with_bias``."""
    i = _inputs(card, 2, 32, 16, d, seed)
    h = getattr(torch, moments)
    args = (i["e"], i["dw"], i["mu"].to(h), i["nu"].to(h), i["lrs"],
            i["bc1"], i["bc2"])
    kw = {}
    if with_bias:
        kw = dict(bias=i["bias"], db=i["dw"][:, :, 0].contiguous(),
                  mu_b=i["mu"][:, :, -1].contiguous(),
                  nu_b=i["nu"][:, :, -1].contiguous())
    return args, kw


def _adam_close(got, ref):
    """The epilogue against its plain version: E', un_sq and the bias
    group within rtol 1e-5 of max|ref|; a moment fp32 within the same, bf16
    within one bf16 ulp (2⁻⁷ of it) plus 1e-5 of max|ref| (its fp32 value a
    few ulps apart may round to the neighbouring bf16)."""
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            bound = (b.float().abs() * 2.0**-7
                     + 1e-5 * float(b.float().abs().max()))
            assert bool(((a.float() - b.float()).abs() <= bound).all())
        else:
            _close(a, b, 1e-5)
    assert (got[4] is None) == (ref[4] is None)
    for a, b in zip(got[4] or (), ref[4] or ()):
        _close(a, b, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("d", ADAM_WIDTHS)
def test_adam_vjp_kernel_matches_plain_at_every_width(card, d, moments,
                                                      with_bias):
    """The tied Adam epilogue, fp32 and bf16 moments, with and without the
    bias group, against its plain version; one launch of the moments'
    form."""
    args, kw = _adam_args(card, d, moments, with_bias)
    _build.reset_launches()
    got = fs.sae_tied_adam_vjp(*args, **kw)
    torch.cuda.synchronize()
    name = ("sae_tied_adam_vjp_bf16" if moments == "bfloat16"
            else "sae_tied_adam_vjp")
    assert _build.LAUNCHES[name] == 1
    _adam_close(got, fs.sae_tied_adam_vjp_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("d", [40, 2048])
def test_adam_vjp_kernel_takes_tensors_off_16_bytes(card, d, moments):
    """E, dW, mu and nu each one element past a 16-byte boundary (the
    kernel then loads and stores an element at a time) give the plain
    version's values, and the aligned call's bits."""
    args, kw = _adam_args(card, d, moments, True)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    moved = [shifted(t) if t.dim() == 3 else t for t in args]
    assert all(t.data_ptr() % 16 for t in moved if t.dim() == 3)
    got = fs.sae_tied_adam_vjp(*moved, **kw)
    _adam_close(got, fs.sae_tied_adam_vjp_plain(*args, **kw))
    want = fs.sae_tied_adam_vjp(*args, **kw)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("d", [512, 2048, 5000])
def test_adam_vjp_kernel_repeats_bitwise_and_keeps_nan(card, d, moments):
    """Two calls give the same bits; a NaN in one row's dW makes that
    row's E', moments and its member's un_sq NaN, as in the plain version,
    and leaves every other row as the plain version has it."""
    args, kw = _adam_args(card, d, moments, True)
    got = fs.sae_tied_adam_vjp(*args, **kw)
    again = fs.sae_tied_adam_vjp(*args, **kw)
    for a, b in zip((*got[:4], *got[4]), (*again[:4], *again[4])):
        assert torch.equal(a, b)
    dw = args[1].clone()
    dw[1, 5, d // 2] = float("nan")
    args = (args[0], dw, *args[2:])
    got = fs.sae_tied_adam_vjp(*args, **kw)
    ref = fs.sae_tied_adam_vjp_plain(*args, **kw)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a.isnan(), b.isnan())
        assert bool(a[1, 5].isnan().all())
    assert bool(got[3][1].isnan()) and bool(got[3][0].isfinite())
    rows = torch.arange(16, device=card) != 5
    _adam_close((*(t[:, rows] for t in got[:3]), got[3][:1], got[4]),
                (*(t[:, rows] for t in ref[:3]), ref[3][:1], ref[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_nan_propagates_through_the_kernels(card, family):
    """A NaN row must reach the losses (the sentinel keys on them): the
    kernels' ReLU and norm clip keep NaN, as torch.relu and clamp do —
    through the raw encoder and the normalized decoder alike."""
    i = _inputs(card, 2, 64, 64, 40)
    i["e"][1, 5, 0] = float("nan")
    if family == "masked_tied":
        i["cm"][1, 5] = 1.0  # the NaN row is an active one
    if family == "untied":
        i["dec"][0, 7, 3] = float("nan")
    fwd, bwd = _fwd_bwd(i, family)
    loss4 = bwd(fwd())[-1]
    torch.cuda.synchronize()
    if family == "untied":  # both members hold a NaN
        assert not torch.isfinite(loss4[0, :2]).all()
    else:
        assert torch.isfinite(loss4[0]).all()
    assert not torch.isfinite(loss4[1, :2]).all()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    i = _inputs(card, 2, 64, 64, 40)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"][:48])
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        ft.sae_untied_fwd(i["e"], i["dec"], i["bias"], i["x"][:48])
    with pytest.raises(ValueError, match="float32"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"], i["cm"].bool())
    with pytest.raises(ValueError, match="split between"):
        ft.sae_untied_bwd(i["e"], i["dec"], i["bias"], i["alphas"], i["x"],
                          torch.zeros((2, 64, 40)))
    with pytest.raises(ValueError, match="not contiguous"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"].t().contiguous().t())
    with pytest.raises(ValueError, match="float32"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"].half())
    with pytest.raises(ValueError, match="split between"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_ensemble_refuses_a_shape_the_kernels_do_not_take(card, tied):
    """On the card an eligible bucket at d=4097 (just above the kernels'
    limit) raises at its first step; with use_fused=False it trains on
    autodiff and launches no kernel."""
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import (
        FunctionalSAE,
        FunctionalTiedSAE,
    )

    sig = FunctionalTiedSAE if tied else FunctionalSAE
    g = torch.Generator().manual_seed(0)
    d = _build.MAX_D + 1
    members = [sig.init(g, d, 64, l1_alpha=l1) for l1 in (1e-3, 1e-2)]
    x = torch.randn((64, d), generator=g).to(card)
    with pytest.raises(ValueError, match="do not take"):
        Ensemble(members, sig, device=card).step_batch(x)
    _build.reset_launches()
    aux = Ensemble(members, sig, device=card, use_fused=False).step_batch(x)
    torch.cuda.synchronize()
    assert torch.isfinite(aux.losses["loss"]).all()
    assert all(v == 0 for v in _build.LAUNCHES.values())


# --- the forwards' chunked launches (sae_tied_fwd, sae_untied_fwd) ------------

def _check_fwd(kernel, fwd, plain, n_chunks):
    """Two calls of a forward's wrapper ``fwd`` against its plain version
    (rtol 1e-5 of max|ref|), bitwise equal to each other; the norms
    launched once a call, codes and decode once per chunk."""
    _build.reset_launches()
    got, again, want = fwd(), fwd(), plain()
    torch.cuda.synchronize()
    _close(got, want, 1e-5)
    assert torch.equal(got, again)
    parts = list(_build._PARTS[kernel])
    assert len(parts) == 3
    assert _build.LAUNCHES[kernel] == 2
    assert {k: _build.LAUNCHES[k] for k in parts} == {
        k: 2 * (1 if k == kernel + "_norms" else n_chunks) for k in parts}


def _check_untied_fwd(i, n_chunks):
    args = (i["e"], i["dec"], i["bias"], i["x"])
    _check_fwd("sae_untied_fwd", lambda: ft.sae_untied_fwd(*args),
               lambda: ft.sae_untied_fwd_plain(*args), n_chunks)


def _check_tied_fwd(i, masked, n_chunks):
    args = (i["e"], i["bias"], i["x"], i["cm"] if masked else None)
    _check_fwd("sae_tied_fwd", lambda: ft.sae_tied_fwd(*args),
               lambda: ft.sae_tied_fwd_plain(*args), n_chunks)


FWD_SHAPES = [(3, 64, 96, 37), (4, 96, 64, 40), (5, 32, 64, 600),
              (3, 64, 32, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
def test_untied_fwd_matches_plain(card, shape):
    """One chunk of every member (N = 3-5) at d = 37 (no 16-byte copies
    of Wn, x or r), 40, 600 and 768."""
    _check_untied_fwd(_inputs(card, *shape, seed=1), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
def test_tied_fwd_matches_plain(card, shape, masked):
    """One chunk of every member at d = 37, 40, 600 and 768, with and
    without the masked family's coef_mask."""
    _check_tied_fwd(_inputs(card, *shape, seed=1), masked, 1)


# (members, batch, n_feats, d, members a chunk, rows a chunk): whole
# members a chunk (the last holds fewer), or one member's batch in row
# chunks (the last shorter); d a multiple of 4 or not
UNTIED_FWD_CHUNK_CASES = [(5, 64, 96, 300, 2, 64), (3, 32, 64, 768, 2, 32),
                          (3, 160, 64, 40, 1, 64), (3, 96, 32, 37, 1, 64)]


def _fwd_chunk_case(monkeypatch, case):
    """Lower the cap so the case's members, or one member's batch, split
    into chunks, one of them short; returns the chunk count."""
    n_m, b, n, _, z, rows = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 4 * n * z * rows)
    chunks = ft.fwd_chunks(n_m, b, n)
    assert len(chunks) >= 2
    assert any(mh - ml < z or bh - bl < rows for ml, mh, bl, bh in chunks)
    return len(chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("case", UNTIED_FWD_CHUNK_CASES, ids=str)
def test_untied_fwd_chunks_match_plain(card, monkeypatch, case):
    """sae_untied_fwd with the workspace cap lowered so that the members,
    or one member's batch, split into chunks."""
    n_chunks = _fwd_chunk_case(monkeypatch, case)
    _check_untied_fwd(_inputs(card, *case[:4], seed=3), n_chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("case", UNTIED_FWD_CHUNK_CASES, ids=str)
def test_tied_fwd_chunks_match_plain(card, monkeypatch, case, masked):
    """sae_tied_fwd with the workspace cap lowered so that the members, or
    one member's batch, split into chunks, with and without a coef_mask."""
    n_chunks = _fwd_chunk_case(monkeypatch, case)
    _check_tied_fwd(_inputs(card, *case[:4], seed=3), masked, n_chunks)


@pytest.mark.cuda
def test_tied_fwd_coef_mask_in_member_chunks(card, monkeypatch):
    """The coefficient mask of the feature-major codes is the feature's
    (the product's row), in every member chunk: four members of 32
    features and 96 rows in chunks of two members, member z keeping its
    first 32/(z+1) features, against the plain version; and each member's
    x̂ = r + x is the decode of its kept features alone."""
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 4 * 32 * 96 * 2)
    assert len(ft.fwd_chunks(4, 96, 32)) == 2
    i = _inputs(card, 4, 96, 32, 40, seed=5)
    _check_tied_fwd(i, True, 2)
    r = ft.sae_tied_fwd(i["e"], i["bias"], i["x"], i["cm"])
    for z in range(4):
        keep = int(i["cm"][z].sum())
        assert keep == 32 // (z + 1)
        sub = ft.sae_tied_fwd_plain(i["e"][z:z + 1, :keep].contiguous(),
                                    i["bias"][z:z + 1, :keep].contiguous(),
                                    i["x"])
        _close(r[z:z + 1], sub, 1e-5)


@pytest.mark.cuda
def test_tied_fwd_nan_propagates_through_member_chunks(card, monkeypatch):
    """A NaN in one member's dictionary row reaches every row of that
    member's residual, and no other member's, when the members run in
    separate chunks."""
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 4 * 64 * 96)
    i = _inputs(card, 2, 96, 64, 40)
    i["e"][1, 5, 0] = float("nan")
    assert len(ft.fwd_chunks(2, 96, 64)) == 2
    r = ft.sae_tied_fwd(i["e"], i["bias"], i["x"])
    torch.cuda.synchronize()
    assert torch.isfinite(r[0]).all()
    assert torch.isnan(r[1]).all()


# --- the untied backward's chunked launches (sae_untied_bwd) ------------------

def _untied_bwd_args(card, n_m, b, n, d, seed=0):
    i = _inputs(card, n_m, b, n, d, seed=seed)
    r = ft.sae_untied_fwd_plain(i["e"], i["dec"], i["bias"], i["x"])
    return i["e"], i["dec"], i["bias"], i["alphas"], i["x"], r.contiguous()


def _check_untied_bwd(args, n_chunks):
    """Two sae_untied_bwd calls against the plain version: weight grads and
    db rtol 1e-3, activity exact, mse/l1/l0 rtol 1e-5 (torch on the card
    divides by a scalar as a multiply by its reciprocal, the kernel
    divides), grad_sq rtol 1e-3; the two calls bitwise; each part launched
    once per chunk (norms and loss once a call)."""
    _build.reset_launches()
    got = ft.sae_untied_bwd(*args)
    again = ft.sae_untied_bwd(*args)
    want = ft.sae_untied_bwd_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):  # dE, dWn, db
        _close(g, w, 1e-3)
    assert torch.equal(got[3], want[3])
    for k, rtol in enumerate((1e-5, 1e-5, 1e-5, 1e-3)):
        _close(got[4][:, k], want[4][:, k], rtol)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    once = ("sae_untied_bwd_norms", "sae_untied_bwd_loss")
    assert _build.LAUNCHES["sae_untied_bwd"] == 2
    assert all(_build.LAUNCHES[k] == 2 * (1 if k in once else n_chunks)
               for k in _build.UNTIED_BWD_PARTS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 96, 40), (4, 96, 64, 300),
                                   (3, 32, 64, 600), (3, 64, 32, 768)],
                         ids=str)
def test_untied_bwd_matches_plain(card, shape):
    """One chunk of every member (N >= 3, distinct alphas) at d = 40, 300,
    600 and 768."""
    _check_untied_bwd(_untied_bwd_args(card, *shape), 1)


# (members, batch, n_feats, d, members a chunk, rows a chunk) -> chunks:
# whole members a chunk (the last holds fewer), or one member's batch in
# chunks (the last shorter); d a multiple of 4 (16-byte copies) or not
UNTIED_CHUNK_CASES = [(5, 64, 96, 300, 2, 64), (3, 32, 64, 768, 2, 32),
                      (3, 160, 64, 40, 1, 64), (3, 96, 32, 37, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", UNTIED_CHUNK_CASES, ids=str)
def test_untied_bwd_chunks_match_plain(card, monkeypatch, case):
    """sae_untied_bwd with the workspace cap lowered so that the members,
    or one member's batch, split into chunks."""
    n_m, b, n, d, z, rows = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 2 * 4 * n * z * rows)
    chunks = ft.bwd_chunks(n_m, b, n)
    assert len(chunks) >= 2
    assert any(mh - ml < z or bh - bl < rows for ml, mh, bl, bh in chunks)
    _check_untied_bwd(_untied_bwd_args(card, n_m, b, n, d, seed=2),
                      len(chunks))


# --- the tied backward's chunked launches (sae_tied_bwd) ----------------------

def _tied_bwd_args(card, n_m, b, n, d, masked, seed=0):
    i = _inputs(card, n_m, b, n, d, seed=seed)
    cm = i["cm"] if masked else None
    r = ft.sae_tied_fwd_plain(i["e"], i["bias"], i["x"], cm)
    return i["e"], i["bias"], i["alphas"], i["x"], r.contiguous(), cm


def _check_tied_bwd(args, n_chunks):
    """Two sae_tied_bwd calls against the plain version: dW and db rtol
    1e-3, activity exact, mse/l1/l0 rtol 1e-5, grad_sq rtol 1e-3; the two
    calls bitwise; each part launched once per chunk (norms and loss once
    a call)."""
    _build.reset_launches()
    got = ft.sae_tied_bwd(*args)
    again = ft.sae_tied_bwd(*args)
    want = ft.sae_tied_bwd_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[:2], want[:2]):  # dW, db
        _close(g, w, 1e-3)
    assert torch.equal(got[2], want[2])
    for k, rtol in enumerate((1e-5, 1e-5, 1e-5, 1e-3)):
        _close(got[3][:, k], want[3][:, k], rtol)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    once = ("sae_tied_bwd_norms", "sae_tied_bwd_loss")
    assert _build.LAUNCHES["sae_tied_bwd"] == 2
    assert {k: _build.LAUNCHES[k] for k in _build.TIED_BWD_PARTS} == {
        k: 2 * (1 if k in once else n_chunks) for k in _build.TIED_BWD_PARTS}


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("shape", [(3, 64, 96, 37), (4, 96, 64, 40),
                                   (3, 32, 64, 600), (3, 64, 32, 768)],
                         ids=str)
def test_tied_bwd_matches_plain(card, shape, masked):
    """One chunk of every member (N >= 3, distinct alphas) at d = 37 (no
    16-byte copies of x, r or dW), 40, 600 and 768, with and without the
    masked family's coef_mask."""
    _check_tied_bwd(_tied_bwd_args(card, *shape, masked), 1)


# (members, batch, n_feats, d, members a chunk, rows a chunk): whole
# members a chunk (the last holds fewer), or one member's batch in row
# chunks (the last shorter); d a multiple of 4 or not
TIED_CHUNK_CASES = [(5, 64, 96, 300, 2, 64), (3, 32, 64, 768, 2, 32),
                    (3, 160, 64, 40, 1, 64), (3, 96, 32, 37, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("case", TIED_CHUNK_CASES, ids=str)
def test_tied_bwd_chunks_match_plain(card, monkeypatch, case, masked):
    """sae_tied_bwd with the workspace cap lowered so that the members, or
    one member's batch, split into chunks."""
    n_m, b, n, d, z, rows = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 2 * 4 * n * z * rows)
    chunks = ft.bwd_chunks(n_m, b, n)
    assert len(chunks) >= 2
    assert any(mh - ml < z or bh - bl < rows for ml, mh, bl, bh in chunks)
    _check_tied_bwd(_tied_bwd_args(card, n_m, b, n, d, masked, seed=4),
                    len(chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
def test_tied_bwd_nan_propagates_through_row_chunks(card, monkeypatch,
                                                    masked):
    """A NaN in one member's dictionary row reaches that member's losses
    and grad sum of squares, and only that member's, when each member's
    batch runs in row chunks."""
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 2 * 4 * 64 * 32)
    e, bias, al, x, r, cm = _tied_bwd_args(card, 2, 96, 64, 40, masked)
    e[1, 5, 0] = float("nan")
    if masked:
        cm[1, 5] = 1.0  # the NaN row is an active one
    assert len(ft.bwd_chunks(2, 96, 64)) == 6
    loss4 = ft.sae_tied_bwd(e, bias, al, x, r, cm)[-1]
    torch.cuda.synchronize()
    assert torch.isfinite(loss4[0]).all()
    assert not torch.isfinite(loss4[1, [1, 3]]).any()


# --- the giant single SAE's kernels (big_sae_fwd, big_sae_bwd) ----------------

BIG_SHAPES = [(32, 32, 40), (64, 64, 128), (32, 96, 300), (64, 32, 640),
              (32, 64, 1024), (32, 64, 2048), (32, 64, 4096)]


def _big_inputs(card, b, n, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"dict": torch.randn((n, d), generator=g),
              "encoder": torch.randn((d, n), generator=g) / math.sqrt(d),
              "threshold": torch.randn((n,), generator=g) * 0.1,
              "centering": torch.randn((d,), generator=g) * 0.1}
    x = torch.randn((b, d), generator=g)
    return {k: v.to(card) for k, v in params.items()}, x.to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BIG_SHAPES, ids=str)
def test_big_sae_kernels_match_plain(card, shape):
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    p, x = _big_inputs(card, *shape)
    xc = (x - p["centering"]).contiguous()
    alpha = torch.tensor(3e-3, device=card)
    _build.reset_launches()
    xhat = fb.big_sae_forward(p, xc)
    ref = fb.big_sae_forward_plain(p, xc)
    _close(xhat, ref, 1e-5)
    r = (ref - x).contiguous()
    got = fb.big_sae_backward(p, alpha, xc, r)
    want = fb.big_sae_backward_plain(p, alpha, xc, r)
    torch.cuda.synchronize()
    for g, w in zip(got[:5], want[:5]):  # dE, dWn, dt, dctr, c_totals
        _close(g, w, 1e-3)
    _close(got[5][:1], want[5][:1], 1e-5)  # l1
    assert torch.equal(got[5][1], want[5][1])  # l0: no mask flips here
    assert _build.LAUNCHES["big_sae_fwd"] == 1
    assert _build.LAUNCHES["big_sae_bwd"] == 1
    # one chunk at these shapes: each of K8's and K9's launches once
    assert all(_build.LAUNCHES[k] == 1
               for k in (*_build.BIG_FWD_PARTS, *_build.BWD_PARTS))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_big_sae_kernels_refuse_past_the_widest_d(card, bf16):
    """d = BIG_MAX_D + 8 (4104) raises on the card naming the sizes the
    kernels take, and launches nothing."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    p, x = _big_inputs(card, 32, 32, _build.BIG_MAX_D + 8)
    _build.reset_launches()
    with pytest.raises(ValueError, match=f"d <= {_build.BIG_MAX_D}"):
        fb.big_sae_forward(p, x, compute_dtype=BF16 if bf16 else "float32")
    assert all(v == 0 for v in _build.LAUNCHES.values())


# (batch, n_feats, d, rows per chunk): 1, 2 and 3 chunks, the last one
# short where there are several; d = 1024, and d not a multiple of 4
# (4-byte copies of Wn and x̂)
BIG_FWD_CHUNK_CASES = [(64, 32, 129, 64), (96, 160, 1024, 64),
                       (160, 96, 37, 64), (96, 64, 300, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIG_FWD_CHUNK_CASES, ids=str)
def test_big_sae_forward_chunks_match_plain(card, monkeypatch, case):
    """K8 with the workspace cap lowered so the batch splits into chunks
    against the plain version (rtol 1e-5 of max|ref|); two calls give the
    same bits; each launch runs once per chunk."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    b, n, d, rows = case
    monkeypatch.setattr(fb, "WORKSPACE_BYTES", 4 * n * rows)
    chunks = fb.fwd_chunks(b, n)
    assert len(chunks) == -(-b // rows)
    p, x = _big_inputs(card, b, n, d, seed=2)
    xc = (x - p["centering"]).contiguous()
    _build.reset_launches()
    got = fb.big_sae_forward(p, xc)
    again = fb.big_sae_forward(p, xc)
    want = fb.big_sae_forward_plain(p, xc)
    torch.cuda.synchronize()
    _close(got, want, 1e-5)
    assert torch.equal(got, again)
    assert _build.LAUNCHES["big_sae_fwd"] == 2
    assert all(_build.LAUNCHES[k] == 2 * len(chunks)
               for k in _build.BIG_FWD_PARTS)


# (batch, n_feats, d, rows per chunk): several chunks, the last one short,
# d a multiple of 4 (16-byte copies) or not (4-byte copies)
BIG_CHUNK_CASES = [(224, 64, 300, 96), (160, 96, 37, 64),
                   (96, 160, 1024, 64), (288, 32, 129, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIG_CHUNK_CASES, ids=str)
def test_big_sae_backward_chunks_match_plain(card, monkeypatch, case):
    """K9 with the workspace cap lowered so the batch splits into chunks
    (the last one short) against the unchunked plain version; two calls
    give the same bits; each launch runs once per chunk."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    b, n, d, rows = case
    monkeypatch.setattr(fb, "WORKSPACE_BYTES", 2 * 4 * n * rows)
    n_chunks = len(fb.bwd_chunks(b, n))
    assert n_chunks >= 2 and b % rows
    p, x = _big_inputs(card, b, n, d, seed=1)
    xc = (x - p["centering"]).contiguous()
    r = (fb.big_sae_forward_plain(p, xc) - x).contiguous()
    alpha = torch.tensor(3e-3, device=card)
    _build.reset_launches()
    got = fb.big_sae_backward(p, alpha, xc, r)
    again = fb.big_sae_backward(p, alpha, xc, r)
    want = fb.big_sae_backward_plain(p, alpha, xc, r)
    torch.cuda.synchronize()
    for g, w in zip(got[:5], want[:5]):
        _close(g, w, 1e-3)
    _close(got[5][:1], want[5][:1], 1e-5)
    assert torch.equal(got[5][1], want[5][1])
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert _build.LAUNCHES["big_sae_bwd"] == 2
    assert _build.LAUNCHES["big_sae_bwd_dctr"] == 2
    assert all(_build.LAUNCHES[k] == 2 * n_chunks
               for k in _build.BWD_PARTS if k != "big_sae_bwd_dctr")


@pytest.mark.cuda
def test_big_sae_nan_propagates(card, monkeypatch):
    """A NaN in the encoder reaches x-hat and the l1 sum, as through
    torch.relu (the kernels' ReLU keeps NaN): with the cap lowered so both
    kernels run the batch in 3 chunks, every element of x-hat is NaN (each
    row's code of that feature is)."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    monkeypatch.setattr(fb, "WORKSPACE_BYTES", 4 * 32 * 32)
    p, x = _big_inputs(card, 96, 32, 40)
    assert len(fb.fwd_chunks(96, 32)) == len(fb.bwd_chunks(96, 32)) == 3
    p["encoder"][3, 5] = float("nan")
    xhat = fb.big_sae_forward(p, x)
    scal = fb.big_sae_backward(p, torch.tensor(1e-3, device=card), x,
                               (xhat.nan_to_num() - x).contiguous())[5]
    torch.cuda.synchronize()
    assert torch.isnan(xhat).all()
    assert torch.isnan(scal[0]) and torch.isfinite(scal[1])


@pytest.mark.cuda
def test_big_sae_wrappers_refuse_what_the_kernels_do_not_take(card):
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    p, x = _big_inputs(card, 64, 64, 40)
    alpha = torch.tensor(1e-3, device=card)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        fb.big_sae_forward(p, x[:48])
    wide, xw = _big_inputs(card, 32, 32, _build.BIG_MAX_D + 8)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        fb.big_sae_forward(wide, xw)
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        fb.big_sae_backward(wide, alpha, xw, xw)
    with pytest.raises(ValueError, match="split between"):
        fb.big_sae_backward(p, alpha, x, x.cpu())
    with pytest.raises(ValueError, match="not contiguous"):
        fb.big_sae_forward(p, x.t().contiguous().t())
    with pytest.raises(ValueError, match="float32"):
        fb.big_sae_forward(p, x.half())
    with pytest.raises(ValueError, match="no kernel tiles"):
        fb.fused_big_sae_loss_and_grads(p, x[:48], 1e-3, False)


# --- the bf16 forms (compute_dtype="bfloat16", bf16 Adam moments) -------------
# Each against its plain bf16 version (the same operands rounded at the same
# points, fp32 products summed in another order): rtol 1e-3 of max|ref| —
# a code or dpre within that rounding of a bf16 rounding boundary rounds to
# the neighbouring bf16 on one side (chip_smoke.py's RTOL_BF16) — and
# activity exact at these shapes.

BF16 = "bfloat16"
BF16_SHAPES = [(3, 96, 96, 40), (2, 64, 64, 600), (2, 32, 64, 768)]


def _bf16_fwd_bwd(i, family, plain=False, x=None):
    e, bias, al = i["e"], i["bias"], i["alphas"]
    x = i["x"] if x is None else x
    if family == "untied":
        fwd, bwd = ((ft.sae_untied_fwd_plain, ft.sae_untied_bwd_plain)
                    if plain else (ft.sae_untied_fwd, ft.sae_untied_bwd))
        return (lambda: fwd(e, i["dec"], bias, x, BF16),
                lambda r: bwd(e, i["dec"], bias, al, x, r, BF16))
    cm = i["cm"] if family == "masked_tied" else None
    fwd, bwd = ((ft.sae_tied_fwd_plain, ft.sae_tied_bwd_plain) if plain
                else (ft.sae_tied_fwd, ft.sae_tied_bwd))
    return (lambda: fwd(e, bias, x, cm, BF16),
            lambda r: bwd(e, bias, al, x, r, cm, BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("batch_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_bf16_fwd_and_bwd_kernels_match_plain(card, shape, family,
                                              batch_dtype):
    """The bf16 forms of the forwards and backwards against their plain
    bf16 versions, with fp32 and bf16 batches; each form launches once a
    call and no fp32 form launches; two calls give the same bits."""
    i = _inputs(card, *shape)
    x = i["x"] if batch_dtype == "float32" else i["x"].to(torch.bfloat16)
    kfwd, kbwd = _bf16_fwd_bwd(i, family, x=x)
    pfwd, pbwd = _bf16_fwd_bwd(i, family, plain=True, x=x)
    _build.reset_launches()
    r = kfwd()
    got = kbwd(r)
    torch.cuda.synchronize()
    base = "sae_untied" if family == "untied" else "sae_tied"
    assert _build.LAUNCHES[f"{base}_fwd_bf16"] == 1
    assert _build.LAUNCHES[f"{base}_bwd_bf16"] == 1
    assert _build.LAUNCHES[f"{base}_fwd"] == _build.LAUNCHES[f"{base}_bwd"] == 0
    _close(r, pfwd(), 1e-3)
    ref = pbwd(r)
    k = len(got) - 3
    for g, rf in zip(got[:k + 1], ref[:k + 1]):
        _close(g, rf, 1e-3)
    assert torch.equal(got[k + 1], ref[k + 1])
    _close(got[k + 2], ref[k + 2], 1e-3)
    again = kbwd(kfwd())
    assert all(torch.equal(u, v) for u, v in zip(got, again))


# (members, batch, n, d, members a chunk, rows a chunk) under a lowered
# workspace cap: member chunks, and row chunks of one member
BF16_CHUNK_CASES = [(5, 64, 96, 304, 2, 64), (3, 32, 64, 768, 2, 32),
                    (3, 160, 64, 40, 1, 64), (2, 224, 96, 1032, 1, 96),
                    (22, 64, 64, 40, 21, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("case", BF16_CHUNK_CASES, ids=str)
def test_bf16_bwd_chunks_match_plain(card, monkeypatch, tied, case):
    """The bf16 backwards in several member and row chunks (the workspace
    cap lowered; 12 bytes a code) against their plain bf16 versions, each
    part launched once a chunk (the rounding passes, norms and loss once
    a call)."""
    n_m, b, n, d, z, rows = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 12 * n * z * rows)
    chunks = ft.bwd_chunks(n_m, b, n, BF16)
    assert len(chunks) >= 2
    i = _inputs(card, n_m, b, n, d, seed=2)
    family = "tied" if tied else "untied"
    kfwd, kbwd = _bf16_fwd_bwd(i, family)
    pfwd, pbwd = _bf16_fwd_bwd(i, family, plain=True)
    r = pfwd()
    _build.reset_launches()
    got = kbwd(r)
    torch.cuda.synchronize()
    ref = pbwd(r)
    k = len(got) - 3
    for g, rf in zip(got[:k + 1], ref[:k + 1]):
        _close(g, rf, 1e-3)
    assert torch.equal(got[k + 1], ref[k + 1])
    parts = _build.TIED_BWD_BF16_PARTS if tied else _build.UNTIED_BWD_BF16_PARTS
    rounds = 2 if tied else 3  # x and r (and the raw untied encoder)
    once = {p: 1 for p in parts if p.endswith(("_norms", "_loss"))}
    want = {p: once.get(p, len(chunks)) for p in parts}
    want[parts[0]] = rounds
    assert {p: _build.LAUNCHES[p] for p in parts} == want


# (members = Z, rows, n, d) of one chunk off the products' tiles (128 x
# 128, or 128 x 256 from K = 1024 where the epilogue only stores; K steps
# of 64): d = 40, 600, 1032; rows and n multiples of 32 but not of 128;
# rows = 1056 takes the wide tile in dwx, de and dwn, d = 1032 in codes
BF16_PRODUCT_CASES = [(1, 160, 96, 40), (21, 96, 160, 600),
                      (1, 224, 96, 1032), (21, 160, 96, 1032),
                      (2, 1056, 160, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("shape", BF16_PRODUCT_CASES, ids=str)
def test_bf16_bwd_products_match_plain(card, shape, tied):
    """Each of a bf16 backward's four products (codes, dpre and the two
    weight grads, on the TMA + wgmma template), launched through
    one_chunk_launches_bf16's parts on one chunk of Z members, against the
    same product of the same bf16 operands summed in fp32 by torch: rtol
    1e-5 of max|ref| (exact bf16 products, fp32 sums in another order);
    the bf16 copies the fp32 outputs rounded; two runs bitwise equal; each
    part counted once a run (the rounding pass once a rounded tensor)."""
    n_m, b, n, d = shape
    i = _inputs(card, n_m, b, n, d, seed=3)
    e, bias, al, x, dec = i["e"], i["bias"], i["alphas"], i["x"], i["dec"]
    kernel = "sae_tied_bwd_bf16" if tied else "sae_untied_bwd_bf16"
    r = (ft.sae_tied_fwd_plain(e, bias, x, None, BF16) if tied else
         ft.sae_untied_fwd_plain(e, dec, bias, x, BF16)).contiguous()
    buf = {}
    parts = ft.one_chunk_launches_bf16(kernel, e, bias, x, decoder=dec,
                                       alphas=al, resid=r, buffers=buf)
    names = list(parts)[:6]  # round, norms, codes, dpre, two weight grads
    _build.reset_launches()
    runs = []
    for _ in range(2):
        for name in names:
            parts[name][0]()
        torch.cuda.synchronize()
        runs.append([t.clone() for t in (buf["c"], buf["cb"], buf["g"],
                                         buf["gb"], *buf["grads"])])
    assert all(torch.equal(u, v) for u, v in zip(*runs))
    rounds = 2 if tied else 3  # x and r (and the raw untied encoder)
    assert {p: _build.LAUNCHES[p] for p in names} == {
        p: 2 * (rounds if p == names[0] else 1) for p in names}
    f = lambda t: t.float()
    xb, wb, rb, c, g = buf["xb"], buf["wb"], buf["rb"], buf["c"], buf["g"]
    enc = wb if tied else buf["eb"]
    _close(c, torch.relu(f(xb) @ f(enc).transpose(1, 2) + bias[:, None, :]),
           1e-5)
    assert torch.equal(buf["cb"], c.to(torch.bfloat16))
    coef = torch.tensor(2.0 / (b * d), dtype=torch.float32).item()
    _close(g, (coef * (f(rb) @ f(wb).transpose(1, 2)) + al[:, None, None] / b)
           * (c > 0), 1e-5)
    assert torch.equal(buf["gb"], g.to(torch.bfloat16))
    dwx = f(buf["gb"]).transpose(1, 2) @ f(xb)
    dwr = coef * (f(buf["cb"]).transpose(1, 2) @ f(rb))
    if tied:
        _close(buf["grads"][0], dwx + dwr, 1e-5)
    else:
        _close(buf["grads"][0], dwx, 1e-5)
        _close(buf["grads"][1], dwr, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("batch_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["tied", "masked", "untied"])
@pytest.mark.parametrize("shape", BF16_PRODUCT_CASES, ids=str)
def test_bf16_fwd_products_match_plain(card, shape, form, batch_dtype):
    """A bf16 forward's two products (codes and decode, on the TMA + wgmma
    template), launched through one_chunk_launches_bf16's parts on one
    chunk of Z members (the masked codes through tied_fwd_bf16_codes with
    the coefficient mask), against torch's fp32 sums of the same bf16
    operands. Ctb [Z, n, rows]: each code the bf16 rounding of a value
    within rtol 1e-5 of max|ref| of the reference code (the backward's
    bound on its fp32 codes, carried through the rounding, which is
    monotone: a code near a rounding boundary may round to the other
    side, a small one by several of its ulps); a ReLU flip only where the
    reference lies within that of 0, at most one per million codes (at
    least one allowed). r from the kernel's own Ctb: rtol 1e-5 of
    max|ref|. Two runs bitwise equal; each part counted once a run (the
    rounding pass once a rounded tensor)."""
    n_m, b, n, d = shape
    i = _inputs(card, n_m, b, n, d, seed=4)
    e, bias, dec = i["e"], i["bias"], i["dec"]
    x = i["x"] if batch_dtype == "float32" else i["x"].to(torch.bfloat16)
    tied = form != "untied"
    kernel = "sae_tied_fwd_bf16" if tied else "sae_untied_fwd_bf16"
    cm = i["cm"] if form == "masked" else None
    buf = {}
    parts = ft.one_chunk_launches_bf16(kernel, e, bias, x, decoder=dec,
                                       buffers=buf)
    if cm is not None:
        parts[f"{kernel}_codes"] = (lambda: ft.tied_fwd_bf16_codes(
            buf["xb"], buf["wb"], bias, cm, buf["ct"]), 0.0)
    names = list(parts)  # round, norms, codes, decode
    assert names == [f"{kernel}_{p}"
                     for p in ("round", "norms", "codes", "decode")]
    _build.reset_launches()
    runs = []
    for _ in range(2):
        for name in names:
            parts[name][0]()
        torch.cuda.synchronize()
        runs.append([buf["ct"].clone(), buf["r"].clone()])
    assert all(torch.equal(u, v) for u, v in zip(*runs))
    rounds = (batch_dtype == "float32") + (not tied)  # x, the raw encoder
    assert {p: _build.LAUNCHES[p] for p in names} == {
        p: 2 * (rounds if p == names[0] else 1) for p in names}
    f = lambda t: t.float()
    xb, wb = buf["xb"], buf["wb"]
    enc = wb if tied else buf["eb"]
    ct = buf["ct"].view(n_m, n, b)
    ref = torch.relu(f(enc) @ f(xb).t() + bias[:, :, None])
    if cm is not None:
        ref = ref * cm[:, :, None]
    tol = 1e-5 * float(ref.abs().max())
    got = f(ct)
    flip = (got > 0) != (ref > 0)
    assert int(flip.sum()) <= max(1, int(1e-6 * ref.numel())), int(flip.sum())
    assert bool((ref[flip].abs() <= tol).all())
    lo = f((ref - tol).clamp_min(0.0).to(torch.bfloat16))
    hi = f((ref + tol).to(torch.bfloat16))
    if cm is not None:
        lo, hi = lo * cm[:, :, None], hi * cm[:, :, None]
    inside = (lo <= got) & (got <= hi)
    assert bool(inside.all()), (int((~inside).sum()),
                                int((ct != ref.to(torch.bfloat16)).sum()))
    _close(buf["r"], f(ct).transpose(1, 2) @ f(wb) - f(x), 1e-5)


@pytest.mark.cuda
def test_bf16_moment_epilogues_match_plain(card):
    """The Adam epilogues with bf16 moments against their plain versions:
    params within rtol 1e-5, each moment within one bf16 ulp (at most 2⁻⁷
    of it) plus 1e-5 of max|ref| (the fp32 moments a few ulps apart may
    round to neighbouring bf16 values), the moments returned bf16."""
    i = _inputs(card, 3, 64, 96, 40)
    h = lambda t: t.to(torch.bfloat16)
    args = (i["e"], i["dw"], h(i["mu"]), h(i["nu"]), i["lrs"], i["bc1"],
            i["bc2"])
    uargs = (i["e"], i["dw"], h(i["mu"]), h(i["nu"]), i["dec"], i["dw"],
             h(i["mu"]), h(i["nu"]), i["lrs"], i["bc1"], i["bc2"])
    _build.reset_launches()
    got = fs.sae_tied_adam_vjp(*args)
    ugot = fs.sae_untied_adam_vjp(*uargs)
    assert _build.LAUNCHES["sae_tied_adam_vjp_bf16"] == 1
    assert _build.LAUNCHES["sae_untied_adam_vjp_bf16"] == 1
    assert _build.LAUNCHES["sae_tied_adam_vjp"] == 0
    for g, rf in ((got[:4], fs.sae_tied_adam_vjp_plain(*args)[:4]),
                  (ugot, fs.sae_untied_adam_vjp_plain(*uargs))):
        for a, b in zip(g, rf):
            assert a.dtype == b.dtype
            if a.dtype == torch.bfloat16:
                bound = (b.float().abs() * 2.0**-7
                         + 1e-5 * float(b.float().abs().max()))
                assert bool(((a.float() - b.float()).abs() <= bound).all())
            else:
                _close(a, b, 1e-5)


@pytest.mark.cuda
def test_bf16_forms_refuse_what_they_do_not_take(card):
    """d must divide by 8 under bf16 compute (ValueError before any
    launch), and the moments must share one dtype."""
    i = _inputs(card, 2, 64, 64, 36)
    with pytest.raises(ValueError, match="d % 8"):
        ft.sae_tied_fwd(i["e"], i["bias"], i["x"], None, BF16)
    with pytest.raises(ValueError, match="moments must"):
        fs.sae_tied_adam_vjp(i["e"], i["dw"], i["mu"].to(torch.bfloat16),
                             i["nu"], i["lrs"], i["bc1"], i["bc2"])


# --- the giant single SAE's bf16 forms (big_sae_fwd_bf16, big_sae_bwd_bf16) ---
# Each against its plain bf16 version on the same card inputs: rtol 1e-3 of
# max|ref| (a code or dpre within a summation-order rounding of a bf16
# rounding boundary rounds to the neighbouring bf16 on one side), the l1
# sum rtol 1e-5, l0 exact at these shapes (no pre-activation within
# rounding of 0).

BIG_BF16_SHAPES = [s for s in BIG_SHAPES if s[2] % 8 == 0]
# (batch, n_feats, d, rows per K9 chunk): several chunks, the last one
# short; K8 in the chunks its 2-byte codes take under the same cap
BIG_BF16_CHUNK_CASES = [(224, 64, 296, 96), (160, 96, 40, 64),
                        (96, 160, 1024, 64), (288, 32, 128, 128)]


def _big_bf16_check(fb, p, xc, r, got_fwd, got_bwd):
    _close(got_fwd, fb.big_sae_forward_plain(p, xc, BF16), 1e-3)
    want = fb.big_sae_backward_plain(p, torch.tensor(3e-3, device=xc.device),
                                     xc, r, BF16)
    for g, w in zip(got_bwd[:5], want[:5]):  # dE, dWn, dt, dctr, c_totals
        _close(g, w, 1e-3)
    _close(got_bwd[5][:1], want[5][:1], 1e-5)
    assert torch.equal(got_bwd[5][1], want[5][1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BIG_BF16_SHAPES, ids=str)
def test_big_sae_bf16_kernels_match_plain(card, shape):
    """K8's and K9's bf16 forms against their plain bf16 versions; each
    form launches once a call and no fp32 big-SAE kernel does; two calls
    give the same bits."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    p, x = _big_inputs(card, *shape)
    xc = (x - p["centering"]).contiguous()
    alpha = torch.tensor(3e-3, device=card)
    r = (fb.big_sae_forward_plain(p, xc, BF16) - x).contiguous()
    _build.reset_launches()
    xhat = fb.big_sae_forward(p, xc, compute_dtype=BF16)
    got = fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["big_sae_fwd_bf16"] == 1
    assert _build.LAUNCHES["big_sae_bwd_bf16"] == 1
    assert all(_build.LAUNCHES[k] == 0 for k in (
        "big_sae_fwd", "big_sae_bwd", *_build.BIG_FWD_PARTS,
        *_build.BWD_PARTS))
    _big_bf16_check(fb, p, xc, r, xhat, got)
    again = fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(xhat, fb.big_sae_forward(p, xc, compute_dtype=BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIG_BF16_CHUNK_CASES, ids=str)
def test_big_sae_bf16_chunks_match_plain(card, monkeypatch, case):
    """Both bf16 forms with the workspace cap lowered so the batch splits
    into chunks (the last one short) against the unchunked plain bf16
    versions; each part launches once a chunk, the rounding passes once per
    rounded tensor (xc, E, Wn; and r) and dctr once a call; two calls give
    the same bits."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    b, n, d, rows = case
    monkeypatch.setattr(fb, "WORKSPACE_BYTES", 12 * n * rows)
    n_fwd, n_bwd = len(fb.fwd_chunks(b, n, BF16)), len(fb.bwd_chunks(b, n, BF16))
    assert n_bwd >= 2 and b % rows
    p, x = _big_inputs(card, b, n, d, seed=3)
    xc = (x - p["centering"]).contiguous()
    r = (fb.big_sae_forward_plain(p, xc, BF16) - x).contiguous()
    alpha = torch.tensor(3e-3, device=card)
    _build.reset_launches()
    xhat = fb.big_sae_forward(p, xc, compute_dtype=BF16)
    got = fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16)
    torch.cuda.synchronize()
    want = {k: n_fwd for k in _build.BIG_FWD_BF16_PARTS}
    want["big_sae_fwd_bf16_round"] = 3
    want.update({k: n_bwd for k in _build.BWD_BF16_PARTS})
    want.update({"big_sae_bwd_bf16_round": 4, "big_sae_bwd_bf16_dctr": 1})
    assert {k: _build.LAUNCHES[k] for k in want} == want
    _big_bf16_check(fb, p, xc, r, xhat, got)
    again = fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


# (rows of one chunk, n_feats, d) of K9 bf16's products: the trainer's
# 5,440-row chunk (42.5 tiles of 128; K = 5,440 puts de and dwn on the
# 128 x 256 tile also where they add), its last chunk's 256 rows and 96
# rows; its n = 16,384 and 96 (not a multiple of 128); its d = 1,024 (the
# codes' 128 x 256 tile) and 40 (one zero-filled K step)
BIG_BF16_PRODUCT_CASES = [(rows, n, d) for rows in (5440, 256, 96)
                          for n in (16384, 96) for d in (1024, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BIG_BF16_PRODUCT_CASES, ids=str)
def test_big_sae_bf16_products_match_plain(card, shape):
    """K9 bf16's four products (codes, dpre, de and dwn on the TMA + wgmma
    template), each launched through its wrapper on one chunk that starts
    32 rows into its operands, against the same product of the same bf16
    operands summed in fp32 by torch: rtol 1e-5 of max|ref| (exact bf16
    products, fp32 sums in another order); Cb and Gb the fp32 outputs
    rounded; de and dwn as the first chunk's (stored) and as a later
    one's (added to what is there; dwn times coef as the last); two runs
    bitwise equal, each launch counted once a run."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    rows, n, d = shape
    gen = torch.Generator().manual_seed(4)
    f32 = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).to(card)
    h = lambda *s, scale=1.0: f32(*s, scale=scale).to(torch.bfloat16)
    xb = h(32 + rows, d)[32:]
    rb = h(32 + rows, d, scale=0.1)[32:]
    eb, wnb = h(d, n, scale=d ** -0.5), h(n, d, scale=d ** -0.5)
    t = f32(n, scale=0.1)
    de0, dwn0 = f32(d, n, scale=0.1), f32(n, d, scale=1e-3)
    alpha = torch.tensor([3e-3], device=card)
    batch = 4 * rows
    coef = torch.tensor(2.0 / (batch * d), dtype=torch.float32).item()
    c, g = (torch.empty((rows, n), device=card) for _ in range(2))
    cb, gb = (torch.empty((rows, n), dtype=torch.bfloat16, device=card)
              for _ in range(2))

    def run():
        fb.bwd_bf16_codes(xb, eb, t, c, cb)
        fb.bwd_bf16_dpre(rb, wnb, c, alpha, g, gb, batch, coef)
        de, de_acc = torch.empty_like(de0), de0.clone()
        dwn, dwn_last = torch.empty_like(dwn0), dwn0.clone()
        fb.bwd_bf16_de(xb, gb, de, True)
        fb.bwd_bf16_de(xb, gb, de_acc, False)
        fb.bwd_bf16_dwn(cb, rb, dwn, True, False, coef)
        fb.bwd_bf16_dwn(cb, rb, dwn_last, False, True, coef)
        torch.cuda.synchronize()
        return [v.clone() for v in (c, cb, g, gb)] + [de, de_acc, dwn,
                                                      dwn_last]

    _build.reset_launches()
    first, second = run(), run()
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    assert {k: _build.LAUNCHES[f"big_sae_bwd_bf16_{k}"]
            for k in ("codes", "dpre", "de", "dwn")} == {
        "codes": 2, "dpre": 2, "de": 4, "dwn": 4}
    c, cb, g, gb, de, de_acc, dwn, dwn_last = first
    f = lambda v: v.float()
    _close(c, torch.relu(f(xb) @ f(eb) + t), 1e-5)
    assert torch.equal(cb, c.to(torch.bfloat16))
    _close(g, (coef * (f(rb) @ f(wnb).T) + alpha / batch) * (c > 0), 1e-5)
    assert torch.equal(gb, g.to(torch.bfloat16))
    de_ref, dwn_ref = f(xb).T @ f(gb), f(cb).T @ f(rb)
    _close(de, de_ref, 1e-5)
    _close(de_acc, de0 + de_ref, 1e-5)
    _close(dwn, dwn_ref, 1e-5)
    _close(dwn_last, coef * (dwn0 + dwn_ref), 1e-5)


# (batch, n_feats, d, rows per K9 chunk): the trainer's n and d in its
# 5,440-row chunks, two whole and a short one; a small shape in 3 chunks
BIG_BF16_CODES_CASES = [(11136, 16384, 1024, 5440), (224, 96, 40, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIG_BF16_CODES_CASES, ids=str)
def test_big_sae_bf16_whole_batch_codes_equal_chunked(card, monkeypatch,
                                                      case):
    """One codes launch over the whole batch (chip_smoke.py counts ReLU
    flips from it) gives every code the bits that the chunked call's codes
    launches give it: the tile a product takes depends on its K (= d) and
    its epilogue, not on the rows. Two K9 bf16 calls over those chunks
    give the same bits."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    b, n, d, rows = case
    monkeypatch.setattr(fb, "WORKSPACE_BYTES", 12 * n * rows)
    chunks = fb.bwd_chunks(b, n, BF16)
    assert len(chunks) == 3 and chunks[0] == (0, rows)
    p, x = _big_inputs(card, b, n, d, seed=5)
    xc = (x - p["centering"]).contiguous()
    xb, eb = xc.to(torch.bfloat16), p["encoder"].to(torch.bfloat16)
    t = p["threshold"]
    whole = torch.empty((b, n), device=card)
    wholeb = torch.empty((b, n), dtype=torch.bfloat16, device=card)
    fb.bwd_bf16_codes(xb, eb, t, whole, wholeb)
    c = torch.empty((rows, n), device=card)
    cb = torch.empty((rows, n), dtype=torch.bfloat16, device=card)
    for lo, hi in chunks:
        fb.bwd_bf16_codes(xb[lo:hi], eb, t, c, cb)
        torch.cuda.synchronize()
        assert torch.equal(c[:hi - lo], whole[lo:hi])
        assert torch.equal(cb[:hi - lo], wholeb[lo:hi])
    del whole, wholeb
    r = (torch.randn((b, d), generator=torch.Generator().manual_seed(6))
         * 0.1).to(card)
    alpha = torch.tensor(3e-3, device=card)
    _build.reset_launches()
    got = fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16)
    again = fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert all(bool(torch.isfinite(v).all()) for v in got)
    assert _build.LAUNCHES["big_sae_bwd_bf16_codes"] == 2 * len(chunks)


@pytest.mark.cuda
def test_big_sae_bf16_forms_refuse_what_they_do_not_take(card):
    """Under bf16 compute d must divide by 8 (ValueError before any launch),
    and the kernels take fp32 inputs only, as the fp32 forms."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    p, x = _big_inputs(card, 64, 64, 36)
    alpha = torch.tensor(1e-3, device=card)
    _build.reset_launches()
    with pytest.raises(ValueError, match="d % 8"):
        fb.big_sae_forward(p, x, compute_dtype=BF16)
    with pytest.raises(ValueError, match="d % 8"):
        fb.big_sae_backward(p, alpha, x, x, compute_dtype=BF16)
    with pytest.raises(ValueError, match="no kernel tiles"):
        fb.fused_big_sae_loss_and_grads(p, x, 1e-3, False,
                                        compute_dtype=BF16)
    assert not any(_build.LAUNCHES.values())
    p, x = _big_inputs(card, 64, 64, 40)
    with pytest.raises(ValueError, match="float32"):
        fb.big_sae_forward(p, x.to(torch.bfloat16), compute_dtype=BF16)


# -- the model zoo's families and PCA on the card --------------------------------


def _zoo_members():
    """(name, signature, two members) for every family that trains on
    autodiff; members drawn on the CPU from one generator."""
    from sparse_coding_tpu_torch.models import (
        lista,
        positive,
        rica,
        sae,
        semilinear,
        topk,
    )

    d, n = 64, 128
    g = torch.Generator().manual_seed(0)
    rot = torch.linalg.qr(torch.randn(d, d, generator=g))[0]
    specs = [
        ("tied_centered", sae.FunctionalTiedCenteredSAE,
         lambda l1: sae.FunctionalTiedCenteredSAE.init(g, d, n, l1)),
        ("thresholding", sae.FunctionalThresholdingSAE,
         lambda l1: sae.FunctionalThresholdingSAE.init(g, d, n, l1)),
        ("masked_untied", sae.FunctionalMaskedSAE,
         lambda l1: sae.FunctionalMaskedSAE.init(g, d, 96, n, l1)),
        ("reverse", sae.FunctionalReverseSAE,
         lambda l1: sae.FunctionalReverseSAE.init(g, d, n, l1)),
        ("centered_tied", sae.FunctionalTiedSAE,
         lambda l1: sae.FunctionalTiedSAE.init(
             g, d, n, l1, rotation=rot, translation=torch.full((d,), 0.1),
             scaling=torch.full((d,), 2.0))),
        ("topk", topk.TopKEncoder,
         lambda l1: topk.TopKEncoder.init(g, d, n, k=8)),
        ("lista", lista.FunctionalLISTADenoisingSAE,
         lambda l1: lista.FunctionalLISTADenoisingSAE.init(g, d, n, l1)),
        ("residual", lista.FunctionalResidualDenoisingSAE,
         lambda l1: lista.FunctionalResidualDenoisingSAE.init(g, d, n, l1)),
        ("positive", positive.FunctionalPositiveTiedSAE,
         lambda l1: positive.FunctionalPositiveTiedSAE.init(g, d, n, l1)),
        ("semilinear", semilinear.SemiLinearSAE,
         lambda l1: semilinear.SemiLinearSAE.init(g, d, n, l1)),
        ("rica", rica.RICA, lambda l1: rica.RICA.init(g, d, n, l1 * 10)),
    ]
    return [(name, sig, [make(1e-3), make(4e-3)])
            for name, sig, make in specs]


@pytest.mark.cuda
def test_group_step_on_the_card_matches_the_cpu(card):
    """One step of each family's group on the card against the same step
    on the CPU: losses rtol 1e-4; each updated leaf within 1e-4 of its
    norm (chip_smoke phase 6's bound: Adam's first step is ±lr·sign(g), so
    a gradient within rounding of 0 may step the other way). A centered
    tied bucket resolves to autodiff as an ineligible family on the card,
    not as a shape the kernels refuse."""
    from sparse_coding_tpu_torch.ensemble import EnsembleGroup

    x = torch.randn(256, 64, generator=torch.Generator().manual_seed(1))
    for name, sig, members in _zoo_members():
        out = {}
        for dev in ("cpu", card):
            group = EnsembleGroup.build(sig, members, lr=1e-3, device=dev)
            aux = group.step_batch(x.to(dev))
            out[str(dev)] = (group, aux)
        (gc, ac), (gg, ag) = out["cpu"], out[str(card)]
        assert list(gg.ensembles) == list(gc.ensembles)
        for bucket, ens in gg.ensembles.items():
            assert ens.fused_path is None
            assert ens.path_resolved == {("autodiff", "family_ineligible"): 1}
            _close(ag[bucket].losses["loss"].cpu(),
                   ac[bucket].losses["loss"], 1e-4)
            for k, v in ens.state.params.items():
                ref = gc.ensembles[bucket].state.params[k]
                err = float(torch.linalg.vector_norm(v.cpu() - ref))
                assert err <= 1e-4 * float(torch.linalg.vector_norm(ref)), \
                    (name, k, err)


@pytest.mark.cuda
def test_batched_pca_on_the_card_matches_float64_eigh(card):
    """BatchedPCA on the card: its eigh against a float64 numpy eigh of
    the same (its own fp32) covariance — eigenvalues and rotᵀ·diag(λ)·rot
    within 1e-5 of the largest eigenvalue, the fp32 solver's rounding —
    and that covariance and mean against float64 sums over the same rows,
    within 5e-4 of the largest eigenvalue: each entry is an fp32 sum of
    4096 products a batch, merged over 8 batches (a sum of K terms may
    round by K·2⁻²⁴ = 2.4e-4 of its size)."""
    import numpy as np

    from sparse_coding_tpu_torch.models.pca import BatchedPCA

    g = torch.Generator().manual_seed(2)
    d = 512
    mix = torch.randn(d, d, generator=g) * torch.linspace(0.1, 2.0, d)
    acts = torch.randn(32768, d, generator=g) @ mix + 0.3
    pca = BatchedPCA(d, device=card)
    for lo in range(0, acts.shape[0], 4096):
        pca.train_batch(acts[lo:lo + 4096].to(card))
    lam, vec = (t.double().cpu().numpy() for t in pca.get_pca())
    cov32 = pca.state.cov.double().cpu().numpy()
    cov32 = (cov32 + cov32.T) / 2
    ref_lam, _ = np.linalg.eigh(cov32)
    solver = 1e-5 * np.abs(ref_lam).max()
    np.testing.assert_allclose(lam, ref_lam, atol=solver)
    np.testing.assert_allclose(vec @ np.diag(lam) @ vec.T, cov32,
                               atol=solver)
    x = acts.double().numpy()
    sums = 5e-4 * np.abs(ref_lam).max()
    np.testing.assert_allclose(cov32, np.cov(x.T, bias=True), atol=sums)
    np.testing.assert_allclose(pca.get_mean().cpu().numpy(), x.mean(axis=0),
                               atol=1e-4)


@pytest.mark.cuda
def test_pca_defaults_to_the_card(card, tmp_path, monkeypatch):
    """BatchedPCA, PCAState.create and fit_pca with no device run on the
    card, and centered_l1_range with no device fits its whitening there
    (the sweep CLI's path)."""
    import numpy as np

    from sparse_coding_tpu_torch.config import EnsembleArgs
    from sparse_coding_tpu_torch.data.chunk_store import ChunkWriter
    from sparse_coding_tpu_torch.models import pca as tpca
    from sparse_coding_tpu_torch.train.experiments import (
        centered_l1_range_experiment,
    )

    d = 32
    acts = np.random.default_rng(3).normal(size=(1024, d)).astype(np.float32)
    assert tpca.BatchedPCA(d).state.cov.device.type == "cuda"
    assert tpca.PCAState.create(d).mean.device.type == "cuda"
    assert tpca.fit_pca(acts, batch_size=256).cov.device.type == "cuda"
    writer = ChunkWriter(tmp_path / "store", d, chunk_size_gb=512 * d * 4
                         / 2**30, dtype="float32")
    writer.add(acts)
    writer.finalize()
    seen = []
    train_batch = tpca.BatchedPCA.train_batch

    def record(self, a):
        seen.append(self.state.cov.device.type)
        train_batch(self, a)

    monkeypatch.setattr(tpca.BatchedPCA, "train_batch", record)
    cfg = EnsembleArgs(dataset_folder=str(tmp_path / "store"),
                       batch_size=128, learned_dict_ratio=2.0)
    (ens, _, _), = centered_l1_range_experiment(cfg, l1_range=[1e-3])
    assert seen == ["cuda"]
    assert ens.device.type == "cuda"


# --- the data-sharded form (total_batch != batch) -----------------------------
# A call on one data shard normalizes by the batch of every shard together
# (total_batch); its outputs are partial sums that an all-reduce over the
# data axis completes. Each backward at total_batch = 3·b against its plain
# version with the same total_batch, at the bounds above (fp32 grads rtol
# 1e-3, bf16 everything rtol 1e-3, losses rtol 1e-5), with the ReLU mask
# flips counted: activity may differ by a flipped code (at most one per
# million codes, at least one allowed), and the grads are held on the
# features with no flip. Members and rows in several chunks too.

TOTAL_BATCH_CASES = [(3, 96, 96, 40, None), (2, 64, 64, 600, None),
                     (5, 64, 96, 304, (2, 64)), (3, 160, 64, 40, (1, 64))]


def _flip_features(got_act, ref_act, codes: int):
    """The (member, feature) pairs whose activity differs (ReLU flips),
    after checking their count."""
    flips = (got_act - ref_act).abs()
    assert float(flips.sum()) <= max(1.0, 1e-6 * codes), float(flips.sum())
    return flips == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["float32", BF16])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("case", TOTAL_BATCH_CASES, ids=str)
def test_total_batch_bwd_kernels_match_plain(card, monkeypatch, case, family,
                                             cd):
    n_m, b, n, d, chunk = case
    if chunk is not None:
        per_code = 4 * 2 if cd == "float32" else 12
        monkeypatch.setattr(ft, "WORKSPACE_BYTES",
                            per_code * n * chunk[0] * chunk[1])
        assert len(ft.bwd_chunks(n_m, b, n, cd)) >= 2
    i = _inputs(card, n_m, b, n, d, seed=5)
    e, bias, al, x = i["e"], i["bias"], i["alphas"], i["x"]
    tb = 3 * b
    if family == "untied":
        r = ft.sae_untied_fwd_plain(e, i["dec"], bias, x, cd).contiguous()
        args = (e, i["dec"], bias, al, x, r, cd)
        kernel, plain, n_grads = ft.sae_untied_bwd, ft.sae_untied_bwd_plain, 2
    else:
        cm = i["cm"] if family == "masked_tied" else None
        r = ft.sae_tied_fwd_plain(e, bias, x, cm, cd).contiguous()
        args = (e, bias, al, x, r, cm, cd)
        kernel, plain, n_grads = ft.sae_tied_bwd, ft.sae_tied_bwd_plain, 1
    _build.reset_launches()
    got = kernel(*args, total_batch=tb)
    whole = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args, total_batch=tb)
    base = "sae_untied_bwd" if family == "untied" else "sae_tied_bwd"
    assert _build.LAUNCHES[base + ("_bf16" if cd == BF16 else "")] == 2
    clean = _flip_features(got[n_grads + 1], ref[n_grads + 1], n_m * b * n)
    for g, w in zip(got[:n_grads + 1], ref[:n_grads + 1]):  # grads, db
        _close(g[clean], w[clean], 1e-3)
    loss_rtol = 1e-5 if cd == "float32" else 1e-3
    for k in range(3):  # mse, l1, l0: a shard's share of the global terms
        _close(got[-1][:, k], ref[-1][:, k], loss_rtol)
        _close(got[-1][:, k] * tb, whole[-1][:, k] * b, loss_rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["float32", BF16])
@pytest.mark.parametrize("shape", [(64, 32, 40), (96, 64, 1024)], ids=str)
def test_total_batch_big_sae_backward_matches_plain(card, shape, cd):
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    p, x = _big_inputs(card, *shape)
    xc = (x - p["centering"]).contiguous()
    alpha = torch.tensor(3e-3, device=card)
    r = (fb.big_sae_forward_plain(p, xc, cd) - x).contiguous()
    tb = 4 * shape[0]
    _build.reset_launches()
    got = fb.big_sae_backward(p, alpha, xc, r, total_batch=tb,
                              compute_dtype=cd)
    torch.cuda.synchronize()
    want = fb.big_sae_backward_plain(p, alpha, xc, r, cd, total_batch=tb)
    assert _build.LAUNCHES["big_sae_bwd" + ("_bf16" if cd == BF16 else "")] \
        == 1
    codes = shape[0] * shape[1]
    assert abs(float(got[5][1] - want[5][1])) <= max(1.0, 1e-6 * codes)
    for g, w in zip(got[1:5], want[1:5]):  # dWn, dt, dctr, c_totals
        _close(g, w, 1e-3)
    _close(got[0], want[0], 1e-3)  # dE
    _close(got[5][:1], want[5][:1], 1e-5 if cd == "float32" else 1e-3)


# -- serving: CUDA-graph programs (sparse_coding_tpu_torch/serve/engine.py) ---


def _serving_registry(card):
    from sparse_coding_tpu_torch.models.learned_dict import TiedSAE, UntiedSAE
    from sparse_coding_tpu_torch.serve import ModelRegistry

    g = torch.Generator().manual_seed(24)
    t = lambda *s: torch.randn(s, generator=g)
    reg = ModelRegistry(device=card)
    reg.register("single", UntiedSAE(encoder=t(96, 40), encoder_bias=t(96),
                                     dictionary=t(96, 40)))
    reg.register_stack("stack", [TiedSAE(dictionary=t(96, 40),
                                         encoder_bias=0.1 * t(96))
                                 for _ in range(3)])
    return reg


def _serving_payload(op, rows, seed):
    import numpy as np

    r = np.random.default_rng(seed)
    if op == "decode":
        return (r.random((rows, 96)) * (r.random((rows, 96)) < 0.1)).astype(
            np.float32)
    return r.normal(size=(rows, 40)).astype(np.float32)


def _serving_eager(eng, model, op, x, bucket):
    """The op's eager program on the card at the same padded bucket."""
    from sparse_coding_tpu_torch.serve.engine import (
        build_bucket_program,
        op_rows_axis,
    )

    entry = eng._registry.get(model)
    fn, spec = build_bucket_program(entry, op, bucket, torch.float32, 8)
    padded = torch.zeros(spec.shape, device=eng.device)
    padded[:x.shape[0]] = torch.from_numpy(x).to(eng.device)
    with torch.no_grad():
        out = fn(eng._entry_tree(model), padded)
    sl = (slice(None),) * op_rows_axis(entry, op) + (slice(0, x.shape[0]),)
    return tuple(o[sl].cpu() for o in (out if isinstance(out, tuple)
                                         else (out,)))


SERVE_OPS = ("encode", "decode", "topk", "predict", "neighbors", "vote")


@pytest.mark.cuda
def test_serving_programs_are_cuda_graphs_bitwise_eager(card):
    """Every (model, op, bucket) program is a captured CUDA graph; each
    replay at a partial bucket equals the eager op at the same padded
    bucket bit for bit, and replays capture nothing."""
    from sparse_coding_tpu_torch.obs import get_registry
    from sparse_coding_tpu_torch.serve import ServingEngine

    reg = _serving_registry(card)
    captures = get_registry().counter("xcache.captures")
    with ServingEngine(reg, buckets=(8, 32), ops=SERVE_OPS, topk_k=8,
                       device=card) as eng:
        n = eng.warmup()
        assert n == (5 + 6) * 2
        progs = eng.program_cache.compiled
        assert all(p.captured.graph is not None for p in progs.values())
        before = captures.value
        for (model, op, bucket) in sorted(progs):
            x = _serving_payload(op, bucket - 3, seed=bucket)
            got = eng.run_padded(model, op, x)[1]
            got = got if isinstance(got, tuple) else (got,)
            for g, w in zip(got, _serving_eager(eng, model, op, x, bucket)):
                assert torch.equal(torch.from_numpy(g).view(torch.int32),
                                   w.view(torch.int32)), (model, op, bucket)
        assert captures.value == before
        assert eng.stats()["recompiles"] == 0
        assert eng.program_cache.pool_bytes() != 0


@pytest.mark.cuda
def test_two_replicas_replay_a_shared_table_concurrently(card):
    """Two engines over one ProgramCache replay the same graphs from two
    threads at once (every replay under the table's lock): every result
    bitwise the eager op's."""
    import threading

    from sparse_coding_tpu_torch.serve import ServingEngine
    from sparse_coding_tpu_torch.serve.engine import ProgramCache

    reg = _serving_registry(card)
    table = ProgramCache()
    engines = [ServingEngine(reg, buckets=(8, 32), ops=("encode", "topk"),
                             topk_k=8, program_cache=table, device=card)
               for _ in range(2)]
    assert engines[0].warmup() == 8 and engines[1].warmup() == 0
    jobs = [("stack" if i % 2 else "single", ("encode", "topk")[i % 3 % 2],
             int(r)) for i, r in enumerate([5, 29, 8, 1, 32, 17] * 4)]
    errors = []

    def run(eng, part):
        try:
            for i, (model, op, rows) in part:
                x = _serving_payload(op, rows, seed=i)
                bucket = 8 if rows <= 8 else 32
                got = eng.run_padded(model, op, x)[1]
                got = got if isinstance(got, tuple) else (got,)
                for g, w in zip(got, _serving_eager(eng, model, op, x,
                                                    bucket)):
                    if not torch.equal(torch.from_numpy(g).view(torch.int32),
                                       w.view(torch.int32)):
                        errors.append((i, model, op, rows))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(
        eng, list(enumerate(jobs))[k::2])) for k, eng in enumerate(engines)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for eng in engines:
        eng.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert errors == []


@pytest.mark.cuda
def test_memory_gauges_create_no_context_on_another_card(card):
    """``update_memory_gauges`` samples the cards this process allocated
    on, and creates no context on any other card of the host."""
    from sparse_coding_tpu_torch import obs
    from sparse_coding_tpu_torch.obs.registry import Registry

    torch.ones(1, device=card)
    n = torch.cuda.device_count()

    def contexts():
        return [i for i in range(n) if torch._C._cuda_hasPrimaryContext(i)]

    before = contexts()
    used = [i for i in range(n) if torch.cuda.memory_stats(i).get(
        "allocated_bytes.all.peak", 0)]
    reg = Registry()
    assert obs.update_memory_gauges(reg) == len(used) >= 1
    assert contexts() == before
    sampled = {k for k in reg.snapshot()["gauges"]
               if k.startswith("cuda.mem.bytes_limit")}
    assert sampled == {f"cuda.mem.bytes_limit{{device={i}}}" for i in used}
