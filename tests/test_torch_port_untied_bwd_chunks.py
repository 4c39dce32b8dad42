"""The untied backward's chunk schedule on the CPU. ``sae_untied_bwd`` on
CPU tensors runs the kernels' schedule in plain torch: whole members a
chunk while their codes and dpre fit the workspace cap
``WORKSPACE_BYTES``, else one member's batch in chunks added in
order. Held against the JAX ``tiled_untied_sae_grads`` (Pallas interpret
mode) on the same numpy inputs, with the cap lowered so that (a) five
members split into chunks of two, the last holding one, and (b) one
member's batch splits into chunks, the last one short. Tolerances:
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
    inp = kernel_inputs(seed=3, n_members=n_m, d=d, n_feats=n, batch=b)
    inp["alphas"] = np.geomspace(1e-3, 3e-2, n_m).astype(np.float32)
    return inp


@pytest.mark.parametrize("d", [40, 300])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_chunked_untied_bwd_matches_jax(monkeypatch, case, d):
    n_m, b, n, z, rows = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 2 * 4 * n * z * rows)
    chunks = ft.bwd_chunks(n_m, b, n)
    assert [(mh - ml, bh - bl) for ml, mh, bl, bh in chunks] == CASES[case]
    inp = _inputs(n_m, b, n, d)
    names = ("e", "dec", "bias", "alphas", "x")
    want = jft.tiled_untied_sae_grads(
        *(jnp.asarray(inp[k]) for k in names), batch_tile=BATCH_TILE,
        feat_tile=FEAT_TILE, interpret=True)
    args = [torch.from_numpy(inp[k]) for k in names]
    got = ft.tiled_untied_sae_grads(*args, batch_tile=BATCH_TILE,
                                    feat_tile=FEAT_TILE)
    for k in ("mse", "l1", "l0"):
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                   **LOSS_TOL, err_msg=k)
    for name, g, w in zip(("dE", "dWn", "db"), got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               **GRAD_TOL, err_msg="grad_sq")
    resid = ft.sae_untied_fwd_plain(*args[:3], args[4])
    first = ft.sae_untied_bwd(*args, resid)
    again = ft.sae_untied_bwd(*args, resid)
    for g, a in zip(first, again):
        assert torch.equal(g, a)


# (members, batch, n_feats, cap in bytes) -> chunks
SCHEDULES = {
    (32, 2048, 2048, 2**30): [(0, 32, 0, 2048)],  # the canonical sweep
    (32, 2048, 8192, 2**30): [(m, m + 8, 0, 2048)  # ratio 16
                              for m in range(0, 32, 8)],
    (5, 64, 96, 2 * 4 * 64 * 96 * 2): [(0, 2, 0, 64), (2, 4, 0, 64),
                                       (4, 5, 0, 64)],
    (2, 160, 64, 2 * 4 * 64 * 64): [(m, m + 1, lo, min(lo + 64, 160))
                                    for m in range(2)
                                    for lo in (0, 64, 128)],
    (3, 96, 32, 100): [(m, m + 1, lo, lo + 32) for m in range(3)
                       for lo in (0, 32, 64)],  # under one 32-row chunk
}


@pytest.mark.parametrize("case", list(SCHEDULES), ids=str)
def test_schedule_covers_every_member_and_row_once_in_order(monkeypatch,
                                                             case):
    """Enumerated chunk by chunk (members, then rows), the chunks visit
    every (member, row) once in (member, row) order; each chunk's C and G
    fit the cap unless one 32-row chunk of one member does not."""
    n_m, b, n, cap = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", cap)
    chunks = ft.bwd_chunks(n_m, b, n)
    assert chunks == SCHEDULES[case]
    visited = [(m, row) for ml, mh, bl, bh in chunks
               for m in range(ml, mh) for row in range(bl, bh)]
    assert visited == [(m, row) for m in range(n_m) for row in range(b)]
    for ml, mh, bl, bh in chunks:
        assert (bh - bl) % 32 == 0
        assert 2 * 4 * (mh - ml) * (bh - bl) * n <= max(cap, 2 * 4 * 32 * n)
