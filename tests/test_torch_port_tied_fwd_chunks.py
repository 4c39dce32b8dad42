"""The tied forward's chunk schedule, and its contract on the CPU. On CUDA
tensors ``sae_tied_fwd`` normalizes the dictionary once, then takes whole
members a chunk while their feature-major codes fit the workspace cap
``WORKSPACE_BYTES``, else one member's batch in row chunks, each writing
its own rows of the residual; ``fwd_chunks`` is that schedule (the untied
forward's too). It is asserted at the main paths' shapes and with the cap
lowered so that (a) five members split into chunks of two, the last
holding one, and (b) one member's batch splits into chunks, the last one
short. The chunks sum nothing across one another, so on CPU tensors the
wrapper takes the plain version, held here against the JAX ``_fwd_call``
(``tied=True``, with and without the masked family's coef_mask, Pallas
interpret mode) minus x on the same numpy inputs at those shapes.
Tolerance: the residual within atol 1e-7 + rtol 1e-5 of max|ref| (the same
f32 products summed in another order); two calls bitwise. The kernels'
chunks are held against the plain version on the card
(tests/test_torch_port_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_sae_tiled as jft
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft
from torch_port_helpers import kernel_inputs

RTOL, ATOL = 1e-5, 1e-7
BATCH_TILE, FEAT_TILE = 32, 32

# (members, batch, n_feats, members a chunk, rows a chunk) -> chunk sizes
# as (members, rows)
CASES = {
    (5, 64, 64, 2, 64): [(2, 64), (2, 64), (1, 64)],
    (2, 160, 64, 1, 64): [(1, 64), (1, 64), (1, 32)] * 2,
}


@pytest.mark.parametrize("masked", [False, True], ids=["tied", "masked"])
@pytest.mark.parametrize("d", [40, 300])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_tied_fwd_matches_jax(monkeypatch, case, d, masked):
    n_m, b, n, z, rows = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", 4 * n * z * rows)
    chunks = ft.fwd_chunks(n_m, b, n)
    assert [(mh - ml, bh - bl) for ml, mh, bl, bh in chunks] == CASES[case]
    inp = kernel_inputs(seed=6, n_members=n_m, d=d, n_feats=n, batch=b)
    mask = inp["coef_mask"].astype(np.float32) if masked else None
    x = jnp.asarray(inp["x"])
    want = np.asarray(jft._fwd_call(
        jnp.asarray(inp["e"]), None,
        jnp.asarray(inp["bias"]).reshape(n_m, 1, n),
        None if mask is None else jnp.asarray(mask).reshape(n_m, 1, n), x,
        BATCH_TILE, FEAT_TILE, True, "float32") - x[None])
    args = [torch.from_numpy(inp[k]) for k in ("e", "bias", "x")]
    cm = None if mask is None else torch.from_numpy(mask)
    got = ft.sae_tied_fwd(*args, cm)
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ATOL + RTOL * float(np.abs(want).max()), err
    assert torch.equal(got, ft.sae_tied_fwd(*args, cm))


# (members, batch, n_feats) -> the forwards' chunks under the real 1 GiB cap
REAL_SCHEDULES = {
    # the canonical sweep: one chunk of every member, 512 MiB of codes
    (32, 2048, 2048): [(0, 32, 0, 2048)],
    # ratio 16: 2 chunks of 16 members, 1 GiB each
    (32, 2048, 8192): [(0, 16, 0, 2048), (16, 32, 0, 2048)],
    # the masked dictionary-ratio bucket: one chunk, 896 MiB
    (7, 2048, 16384): [(0, 7, 0, 2048)],
}


@pytest.mark.parametrize("case", list(REAL_SCHEDULES), ids=str)
def test_fwd_schedule_at_the_main_shapes(case):
    """At the main paths' shapes the forwards take whole members, as many a
    chunk as the 1 GiB cap holds of their codes."""
    n_m, b, n = case
    chunks = ft.fwd_chunks(n_m, b, n)
    assert chunks == REAL_SCHEDULES[case]
    assert all(4 * (mh - ml) * b * n <= ft.WORKSPACE_BYTES
               for ml, mh, _, _ in chunks)
