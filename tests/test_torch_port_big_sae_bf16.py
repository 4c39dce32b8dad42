"""bf16 compute in the port's giant single SAE (``compute_dtype=
"bfloat16"`` of ``ops/fused_big_sae.py``, ``make_big_sae_step(
fused_compute_dtype="bfloat16")``) against the JAX package on the same
numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the
port's side runs the plain PyTorch versions (K9: its chunk schedule),
which round each dot operand to bf16 and back at the JAX package's cast
points — xc, the raw encoder, the normalized dictionary, r, the codes and
dpre — and multiply in fp32. Both sides add the same exact products in
fp32, in other orders, and round the same values to bf16 — a code or
dpre within a summation-order rounding of a bf16 rounding boundary rounds
to the neighbouring bf16 on one side, which moves its terms by 2⁻⁸ of
themselves. Tolerances, with the worst value seen on the CPU beside each:

- the kernels (K8, K9 in one chunk and, with the workspace cap lowered,
  in 3–4): every output, dctr included, |Δ|max ≤ 1e-3 of max|ref|
  (``BF16_GRAD_SHARE``, PR 13's bound; worst 5.9e-4, K8's x̂ at d=1024,
  and 5.6e-4, K9's dE — one code on a rounding boundary each); dctr
  within 1e-4 (``DCTR_SHARE``; worst 4.6e-5), which the fp32 form's
  reordering −E·Σ_b dpre misses (1.3e-4–3.4e-4 with E rounded); l0
  exact;
- the loss-and-grads contract, tied and untied, in 1 and 4 chunks: the
  loss, mse, sparsity and l0 rtol 1e-5 (worst 1.1e-7); grads within
  ``BF16_GRAD_SHARE`` (worst 2.6e-4, the encoder's), the centering grad
  within ``DCTR_SHARE`` (worst 1.2e-5); c_totals and the
  per-example mses rtol 1e-4 (worst 8.9e-6);
- 20 steps of ``make_big_sae_step`` with K9 in 4 chunks against the JAX
  step: per-step metrics rtol 5e-4 (worst 7.9e-5, l0); after the steps,
  params |Δ|max ≤ 5e-3 of max|ref| (worst 9.5e-4, the tied encoder) and
  Adam's first moments ≤ 1e-2 (worst 3.5e-3) — Adam's early steps are
  ±lr·sign(g), so an element whose gradient moved by one such rounding
  steps differently, and the steps grow it (one chunk: the same values);
  c_totals rtol 1e-3, worst losses rtol 1e-4;
- the port's bf16 contract against its own fp32 one: the JAX package's
  own bf16-versus-f32 bound (tests/test_fused_big_sae.py:151-172: loss
  rtol 2e-2, grads rtol 0.15 with an absolute floor of 6e-2 of max|ref|;
  worst 1.4e-4 of the loss, 4.3e-2 of max|dE|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_big_sae as jfb
from sparse_coding_tpu.train import big_sae as jbs
from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops import fused_big_sae as tfb
from sparse_coding_tpu_torch.train import big_sae as tbs
from sparse_coding_tpu_torch.utils.carry import big_state_from_numpy
from torch_port_helpers import batches

B, N, D = 256, 256, 128
L1 = 1e-3
ALPHA = np.float32(3e-3)
N_WORST = 32
N_STEPS = 20
BF16 = "bfloat16"
BF16_GRAD_SHARE = 1e-3
# dctr (and the centering grad that carries it) is held closer: the JAX
# kernel sums the ROUNDED dpre against the rounded encoder, and the fp32
# form's reordering −E·Σ_b dpre, rounded or not, lands 1.3e-4–1.8e-3 of
# max|ref| away from it at these shapes
DCTR_SHARE = 1e-4
LOSS_RTOL = 1e-5
STEP_RTOL = 5e-4
STEP_PARAM_SHARE = 5e-3
STEP_MU_SHARE = 1e-2
BF16_VS_F32_LOSS_RTOL = 2e-2
BF16_VS_F32_GRAD_RTOL = 0.15
BF16_VS_F32_GRAD_FLOOR = 6e-2
OUTPUTS = ("dE", "dWn", "dt", "dctr_enc", "c_totals", "l1_l0")

# (batch, n_feats, d, rows per K9 chunk) -> chunk lengths under the bf16
# form's 12 bytes a code; d a multiple of 8, as the bf16 kernels need
CHUNK_CASES = {
    (96, 96, 40, 32): [32, 32, 32],
    (160, 96, 40, 64): [64, 64, 32],
    (224, 64, 296, 96): [96, 96, 32],
    (256, 256, 128, 64): [64, 64, 64, 64],
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _params(seed: int = 0, tied: bool = False, n: int = N,
            d: int = D) -> dict:
    """Raw big-SAE params (numpy): a unit dictionary, an encoder (its
    transpose when tied), small thresholds and a small centre."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dictionary = rs.normal(size=(n, d))
    dictionary /= np.linalg.norm(dictionary, axis=-1, keepdims=True)
    encoder = dictionary.T if tied else rs.normal(size=(d, n)) / np.sqrt(d)
    return {"dict": f32(dictionary), "encoder": f32(encoder),
            "threshold": f32(rs.normal(size=n) * 0.05),
            "centering": f32(rs.normal(size=d) * 0.1)}


def _share(got, ref, what: str, share: float = BF16_GRAD_SHARE) -> None:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= share * scale, (f"{what}: |Δ|max {err:.3e} > {share} x "
                                  f"max|ref| {scale:.3e}")


def _residual_inputs(b, n, d, tied, seed=0):
    """Params, the centered batch and the residual r (x̂ − x, or x̂ + ctr −
    x when tied) from the JAX bf16 forward, as numpy."""
    p = _params(seed, tied, n, d)
    x = np.random.default_rng(seed + 1).normal(size=(b, d)).astype(np.float32)
    xc = (x - p["centering"]).astype(np.float32)
    xhat = np.asarray(jfb.big_sae_forward(p, jnp.asarray(xc), batch_tile=32,
                                          feat_tile=32, interpret=True,
                                          compute_dtype=BF16))
    r = (xhat + p["centering"] - x if tied else xhat - x).astype(np.float32)
    return p, xc, r


# --- K8 and K9 ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(B, N, D), (96, 96, 40), (64, 64, 1024)],
                         ids=str)
def test_bf16_forward_matches_jax(shape):
    """K8's bf16 form on CPU tensors is its plain bf16 version, bit for bit,
    and matches the JAX big_sae_forward with compute_dtype bfloat16."""
    b, n, d = shape
    p = _params(1, n=n, d=d)
    xc = np.random.default_rng(2).normal(size=(b, d)).astype(np.float32)
    want = jfb.big_sae_forward(p, jnp.asarray(xc), batch_tile=32,
                               feat_tile=32, interpret=True,
                               compute_dtype=BF16)
    tp = {k: _t(v) for k, v in p.items()}
    got = tfb.big_sae_forward(tp, _t(xc), compute_dtype=BF16)
    assert torch.equal(got, tfb.big_sae_forward_plain(tp, _t(xc), BF16))
    _share(got, want, "x̂")


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_bf16_backward_matches_jax(tied):
    """K9's bf16 form (its chunk schedule, one chunk here) and its unchunked
    plain version against the JAX big_sae_backward in bf16: every output,
    dctr explicitly (the rounded dpre against the rounded encoder)."""
    p, xc, r = _residual_inputs(B, N, D, tied)
    want = jfb.big_sae_backward(p, jnp.asarray(ALPHA), jnp.asarray(xc),
                                jnp.asarray(r), batch_tile=64, feat_tile=128,
                                interpret=True, compute_dtype=BF16)
    tp = {k: _t(v) for k, v in p.items()}
    args = (tp, torch.tensor(ALPHA), _t(xc), _t(r))
    assert len(tfb.bwd_chunks(B, N, BF16)) == 1
    for got in (tfb.big_sae_backward(*args, compute_dtype=BF16),
                tfb.big_sae_backward_plain(*args, compute_dtype=BF16)):
        for name, g, w in zip(OUTPUTS[:5], got, want):
            _share(g, w, name, DCTR_SHARE if name == "dctr_enc"
                   else BF16_GRAD_SHARE)
        _share(got[5][:1], want[5][:1], "l1")
        assert float(got[5][1]) == float(want[5][1])  # l0


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("case", list(CHUNK_CASES), ids=str)
def test_bf16_backward_chunks_match_jax(monkeypatch, case, tied):
    """K9's bf16 chunk schedule with the workspace cap lowered to ``rows``
    rows of C, G and their bf16 roundings (12 bytes a code): the chunk
    lengths, every output against the JAX kernel, dctr included, and two
    calls bit for bit."""
    b, n, d, rows = case
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 12 * n * rows)
    chunks = tfb.bwd_chunks(b, n, BF16)
    assert [hi - lo for lo, hi in chunks] == CHUNK_CASES[case]
    p, xc, r = _residual_inputs(b, n, d, tied, seed=4)
    want = jfb.big_sae_backward(p, jnp.asarray(ALPHA), jnp.asarray(xc),
                                jnp.asarray(r), batch_tile=32, feat_tile=32,
                                interpret=True, compute_dtype=BF16)
    tp = {k: _t(v) for k, v in p.items()}
    args = (tp, torch.tensor(ALPHA), _t(xc), _t(r))
    got = tfb.big_sae_backward(*args, compute_dtype=BF16)
    for name, g, w in zip(OUTPUTS[:5], got, want):
        _share(g, w, name, DCTR_SHARE if name == "dctr_enc"
               else BF16_GRAD_SHARE)
    _share(got[5][:1], want[5][:1], "l1")
    assert float(got[5][1]) == float(want[5][1])
    again = tfb.big_sae_backward(*args, compute_dtype=BF16)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_bf16_chunk_rows_at_the_trainers_shape(monkeypatch):
    """At BigSAEArgs' shape (batch 65,536, 16,384 features) the bf16 forms'
    codes fit the 1 GiB cap in 2 K8 chunks of 32,768 rows (2 bytes a code)
    and 13 K9 chunks of 5,440 rows (12 bytes), the last one 256 rows."""
    b, n = 65536, 16384
    assert tfb.fwd_chunks(b, n, BF16) == [(0, 32768), (32768, 65536)]
    assert tfb.bwd_chunk_rows(b, n, BF16) == 5440
    chunks = tfb.bwd_chunks(b, n, BF16)
    assert len(chunks) == 13 and chunks[-1] == (65280, 65536)
    assert 12 * 5440 * n <= tfb.WORKSPACE_BYTES < 12 * 5472 * n
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 1024)
    assert tfb.bwd_chunk_rows(b, n, BF16) == tfb.fwd_chunk_rows(b, n, BF16) == 32


# --- the loss-and-grads contract ------------------------------------------------

@pytest.mark.parametrize("rows", [None, 64], ids=["1chunk", "4chunks"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_bf16_loss_and_grads_match_jax(monkeypatch, tied, rows):
    """fused_big_sae_loss_and_grads with compute_dtype bfloat16 against the
    JAX function in interpret mode: loss, aux and the grads wrt the raw
    params (the centering grad carries dctr), K9 in 1 and 4 chunks."""
    if rows is not None:
        monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 12 * N * rows)
        assert len(tfb.bwd_chunks(B, N, BF16)) == B // rows
    p = _params(5, tied)
    x = np.random.default_rng(6).normal(size=(B, D)).astype(np.float32)
    jl, jaux, jg = jfb.fused_big_sae_loss_and_grads(
        p, jnp.asarray(x), jnp.float32(L1), tied, interpret=True,
        compute_dtype=BF16)
    tl, taux, tg = tfb.fused_big_sae_loss_and_grads(
        {k: _t(v) for k, v in p.items()}, _t(x), L1, tied,
        compute_dtype=BF16)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("mse", "sparsity", "l0_mean"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("mse_losses", "c_totals_delta"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in tbs.PARAM_NAMES:
        _share(tg[k], jg[k], k,
               DCTR_SHARE if k == "centering" else BF16_GRAD_SHARE)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_bf16_contract_tracks_fp32(tied):
    """The port's bf16 contract against its own fp32 one at the JAX
    package's bf16-versus-f32 bound (tests/test_fused_big_sae.py:151-172):
    bf16 keeps 8 significant bits, which moves pre-activations by ~2⁻⁸ of
    their size and flips the ReLU masks of codes that close to 0."""
    p = {k: _t(v) for k, v in _params(7, tied).items()}
    x = _t(np.random.default_rng(8).normal(size=(B, D)))
    lf, _, gf = tfb.fused_big_sae_loss_and_grads(p, x, L1, tied)
    lh, _, gh = tfb.fused_big_sae_loss_and_grads(p, x, L1, tied,
                                                 compute_dtype=BF16)
    np.testing.assert_allclose(float(lh), float(lf),
                               rtol=BF16_VS_F32_LOSS_RTOL)
    for k in tbs.PARAM_NAMES:
        ref = gf[k].numpy()
        atol = BF16_VS_F32_GRAD_FLOOR * max(float(np.abs(ref).max()), 1e-3)
        np.testing.assert_allclose(gh[k].numpy(), ref,
                                   rtol=BF16_VS_F32_GRAD_RTOL, atol=atol,
                                   err_msg=k)
    assert not torch.equal(gh["encoder"], gf["encoder"])  # bf16 ran


# --- the step -------------------------------------------------------------------

def _carry(js) -> tbs.BigSAEState:
    adam = js.opt_state[0]
    np_ = lambda tree: {k: np.array(v) for k, v in tree.items()}
    return big_state_from_numpy(
        params=np_(js.params), mu=np_(adam.mu), nu=np_(adam.nu),
        count=np.array(adam.count), c_totals=np.array(js.c_totals),
        worst_losses=np.array(js.worst_losses),
        worst_vectors=np.array(js.worst_vectors), step=np.array(js.step),
        tied=js.tied)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_bf16_step_trajectory_matches_jax(monkeypatch, tied):
    """20 steps of make_big_sae_step(use_fused=True, fused_compute_dtype=
    "bfloat16") from the JAX state's numbers, K9 in 4 chunks, against the
    JAX step (fused_interpret=True) on the same batches: per-step metrics,
    then params, Adam's first moments and the tracking buffers."""
    import jax

    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 12 * N * 64)
    assert len(tfb.bwd_chunks(B, N, BF16)) == 4
    state, optimizer, l1 = jbs.init_big_sae(jax.random.PRNGKey(3), D, N,
                                            l1_alpha=L1, tied=tied,
                                            n_worst=N_WORST)
    ported = _carry(state)
    jstep = jbs.make_big_sae_step(optimizer, l1, use_fused=True,
                                  fused_interpret=True,
                                  fused_compute_dtype=BF16)
    tstep = tbs.make_big_sae_step(tbs.BigSAEAdam(lr=1e-3), torch.tensor(L1),
                                  use_fused=True, fused_compute_dtype=BF16)
    for i, x in enumerate(batches(seed=9, n=N_STEPS, batch=B, d=D)):
        state, jm = jstep(state, jnp.asarray(x))
        ported, tm = tstep(ported, _t(x))
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm[k]), float(v), rtol=STEP_RTOL,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    want = _carry(state)
    for k in tbs.PARAM_NAMES:
        _share(ported.params[k], want.params[k], k, STEP_PARAM_SHARE)
        _share(ported.mu[k], want.mu[k], f"mu {k}", STEP_MU_SHARE)
    assert int(ported.count) == int(want.count) == N_STEPS
    np.testing.assert_allclose(ported.c_totals.numpy(),
                               want.c_totals.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ported.worst_losses.numpy(),
                               want.worst_losses.numpy(), rtol=1e-4,
                               atol=1e-7)


# --- gating -----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(65536, 16384, 1024), (256, 256, 128),
                                   (64, 32, 40), (64, 32, 36), (96, 64, 300),
                                   (96, 64, 1032), (100, 256, 128)], ids=str)
def test_bf16_pick_tiles_admits_what_the_bf16_kernels_take(shape):
    """pick_big_sae_tiles(compute_itemsize=2) admits a shape exactly when the
    bf16 forms' shape check does (the fp32 contract and d % 8 == 0)."""
    tiles = tfb.pick_big_sae_tiles(*shape, compute_itemsize=2)
    try:
        _build.check_big_shape("big_sae_fwd_bf16", *shape, BF16)
        takes = True
    except ValueError:
        takes = False
    assert (tiles is not None) == takes
    assert takes == (shape[2] % 8 == 0 and shape[2] <= 4096
                     and shape[0] % 32 == 0)


def test_bf16_gating():
    """float16 compute and a total_batch below the rows raise; the step takes
    bfloat16 and refuses, with use_fused=True, a d the bf16 forms do not
    take; on the CPU "auto" stays autodiff and launches nothing."""
    p = {k: _t(v) for k, v in _params(0).items()}
    x = _t(np.random.default_rng(1).normal(size=(B, D)))
    with pytest.raises(NotImplementedError, match="float16"):
        tfb.fused_big_sae_loss_and_grads(p, x, L1, False,
                                         compute_dtype="float16")
    with pytest.raises(ValueError, match="total_batch"):
        tfb.fused_big_sae_loss_and_grads(p, x, L1, False, total_batch=B // 2,
                                         compute_dtype=BF16)
    with pytest.raises(NotImplementedError, match="float16"):
        tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3), L1,
                              fused_compute_dtype="float16")
    state, _, _ = tbs.init_big_sae(torch.Generator().manual_seed(0), 36, 64,
                                   L1, device="cpu")
    step = tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3), torch.tensor(L1),
                                 use_fused=True, fused_compute_dtype=BF16)
    with pytest.raises(ValueError, match="d % 8"):
        step(state, torch.zeros((64, 36)))
    state, _, _ = tbs.init_big_sae(torch.Generator().manual_seed(0), D, N,
                                   L1, device="cpu")
    _build.reset_launches()
    _, m = tbs.make_big_sae_step(tbs.BigSAEAdam(1e-3), torch.tensor(L1),
                                 fused_compute_dtype=BF16)(state, x)
    assert np.isfinite(float(m["loss"]))
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("kernel", ["big_sae_fwd_bf16", "big_sae_bwd_bf16"])
def test_bf16_one_chunk_launches_name_every_part_in_order(monkeypatch,
                                                          kernel):
    """one_chunk_launches lists each part of a bf16 form once, in the order
    of its _build tuple, on the first chunk of its bf16 schedule: 0 FLOPs
    for the rounding pass and the sums, 2·rows·n·d for a product, 2·n·d for
    dctr; building the list launches nothing."""
    b, n, d = 96, 64, 40
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 12 * n * 32)
    fwd = kernel == "big_sae_fwd_bf16"
    rows = 96 if fwd else 32  # 12·n·32 bytes hold 192 rows of bf16 Cᵀ
    p = {k: _t(v) for k, v in _params(0, n=n, d=d).items()}
    xc = _t(np.random.default_rng(0).normal(size=(b, d)))
    _build.reset_launches()
    got = tfb.one_chunk_launches(kernel, p, xc, r=torch.zeros_like(xc),
                                 alpha=torch.tensor(1e-3))
    parts = _build.BIG_FWD_BF16_PARTS if fwd else _build.BWD_BF16_PARTS
    assert tuple(got) == parts
    products = ("codes", "decode", "dpre", "de", "dwn")
    want = {k: 2.0 * rows * n * d if k.rsplit("_", 1)[1] in products
            else 0.0 for k in parts}
    if not fwd:
        want["big_sae_bwd_bf16_dctr"] = 2.0 * n * d
    assert {k: f for k, (_, f) in got.items()} == want
    assert all(v == 0 for v in _build.LAUNCHES.values())
