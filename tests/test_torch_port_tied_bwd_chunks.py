"""The tied backward's chunk schedule, checked on the CPU. On the card
``sae_tied_bwd`` normalizes the dictionary once, then takes whole members
a chunk while their codes and dpre fit the workspace cap
``WORKSPACE_BYTES``, else one member's batch in chunks added in order;
``bwd_chunks`` is that schedule. With the cap lowered so that (a) five
members split into chunks of two, the last holding one, and (b) one
member's batch splits into chunks, the last one short, the schedule is
asserted, and the CPU wrapper (the plain version; the card tests hold the
chunk arithmetic against it) is held against the JAX
``tiled_tied_sae_grads`` (Pallas interpret mode) on the same numpy
inputs, with and without the masked family's coef_mask. Tolerances:
gradients and grad_sq rtol 2e-4 / atol 1e-6 (the JAX fused-vs-autodiff
bound), losses rtol 1e-5, activity exact; two calls bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_sae_tiled as jft
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft
from torch_port_helpers import kernel_inputs

GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
BATCH_TILE, FEAT_TILE = 32, 32

# (members, batch, n_feats, members a chunk, rows a chunk) -> chunk sizes
# as (members, rows)
CASES = {
    (5, 64, 64, 2, 64): [(2, 64), (2, 64), (1, 64)],
    (2, 160, 64, 1, 64): [(1, 64), (1, 64), (1, 32)] * 2,
}


def _inputs(n_m, b, n, d):
    inp = kernel_inputs(seed=5, n_members=n_m, d=d, n_feats=n, batch=b)
    inp["alphas"] = np.geomspace(1e-3, 3e-2, n_m).astype(np.float32)
    return inp


@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("d", [40, 300])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_chunked_tied_bwd_matches_jax(monkeypatch, case, d, masked):
    n_m, b, n, z, rows = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 2 * 4 * n * z * rows)
    chunks = ft.bwd_chunks(n_m, b, n)
    assert [(mh - ml, bh - bl) for ml, mh, bl, bh in chunks] == CASES[case]
    inp = _inputs(n_m, b, n, d)
    names = ("e", "bias", "alphas", "x")
    mask = inp["coef_mask"] if masked else None
    want = jft.tiled_tied_sae_grads(
        *(jnp.asarray(inp[k]) for k in names), batch_tile=BATCH_TILE,
        feat_tile=FEAT_TILE, interpret=True,
        coef_mask=None if mask is None else jnp.asarray(mask))
    args = [torch.from_numpy(inp[k]) for k in names]
    cm = None if mask is None else torch.from_numpy(mask)
    got = ft.tiled_tied_sae_grads(*args, batch_tile=BATCH_TILE,
                                  feat_tile=FEAT_TILE, coef_mask=cm)
    for k in ("mse", "l1", "l0"):
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                   **LOSS_TOL, err_msg=k)
    for name, g, w in zip(("dW", "db"), got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               **GRAD_TOL, err_msg="grad_sq")
    fm = None if cm is None else cm.float()
    resid = ft.sae_tied_fwd_plain(*args[:2], args[3], fm)
    first = ft.sae_tied_bwd(*args, resid, fm)
    again = ft.sae_tied_bwd(*args, resid, fm)
    for g, a in zip(first, again):
        assert torch.equal(g, a)


# (members, batch, n_feats) -> members a chunk under the real 1 GiB cap
REAL_SCHEDULES = {
    (32, 2048, 2048): 32,  # the canonical sweep: one chunk, exactly 1 GiB
    (32, 2048, 8192): 8,  # ratio 16: 4 chunks
    (7, 2048, 16384): 4,  # the masked dictionary-ratio bucket: 4 + 3
}


@pytest.mark.parametrize("case", list(REAL_SCHEDULES), ids=str)
def test_schedule_at_the_main_shapes(case):
    """At the main paths' shapes the backwards take whole members, as many
    a chunk as the 1 GiB cap holds of their C and G, the last chunk
    holding the rest."""
    n_m, b, n = case
    z = REAL_SCHEDULES[case]
    assert 2 * 4 * z * b * n <= ft.WORKSPACE_BYTES < 2 * 4 * (z + 1) * b * n
    assert ft.bwd_chunks(n_m, b, n) == [(m, min(m + z, n_m), 0, b)
                                        for m in range(0, n_m, z)]
