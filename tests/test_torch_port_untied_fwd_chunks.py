"""The untied forward's chunk schedule, and its contract on the CPU.
On CUDA tensors ``sae_untied_fwd`` runs whole members a chunk while their
codes fit the workspace cap ``WORKSPACE_BYTES``, else one member's
batch in row chunks, each writing its own rows of the residual; the
schedule is checked here with the cap lowered. The chunks sum nothing
across one another, so on CPU tensors the wrapper takes the plain version,
held here against the JAX ``_fwd_call`` (``tied=False``, Pallas interpret
mode) minus x on the same numpy inputs, at the shapes the schedule tests
split (five members; a 160-row batch) and at d = 40 and 300. Tolerance:
the residual within atol 1e-7 + rtol 1e-5 of max|ref| (the same f32
products summed in another order). The kernels' chunks are held against
the plain version on the card (tests/test_torch_port_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_sae_tiled as jft
from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft
from torch_port_helpers import kernel_inputs

RTOL, ATOL = 1e-5, 1e-7
BATCH_TILE, FEAT_TILE = 32, 32


@pytest.mark.parametrize("d", [40, 300])
@pytest.mark.parametrize("shape", [(5, 64, 64), (2, 160, 64)], ids=str)
def test_untied_fwd_matches_jax(shape, d):
    n_m, b, n = shape
    inp = kernel_inputs(seed=5, n_members=n_m, d=d, n_feats=n, batch=b)
    x = jnp.asarray(inp["x"])
    want = np.asarray(jft._fwd_call(
        jnp.asarray(inp["e"]), jnp.asarray(inp["dec"]),
        jnp.asarray(inp["bias"]).reshape(n_m, 1, n), None, x, BATCH_TILE,
        FEAT_TILE, True, "float32") - x[None])
    got = ft.sae_untied_fwd(*[torch.from_numpy(inp[k])
                              for k in ("e", "dec", "bias", "x")])
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ATOL + RTOL * float(np.abs(want).max()), err


# (members, batch, n_feats, cap in bytes) -> chunks
SCHEDULES = {
    (32, 2048, 2048, 2**30): [(0, 32, 0, 2048)],  # the canonical sweep
    (32, 2048, 8192, 2**30): [(m, m + 16, 0, 2048)  # ratio 16
                              for m in (0, 16)],
    (5, 64, 96, 4 * 64 * 96 * 2): [(0, 2, 0, 64), (2, 4, 0, 64),
                                   (4, 5, 0, 64)],
    (2, 160, 64, 4 * 64 * 64): [(m, m + 1, lo, min(lo + 64, 160))
                                for m in range(2) for lo in (0, 64, 128)],
    (3, 96, 32, 100): [(m, m + 1, lo, lo + 32) for m in range(3)
                       for lo in (0, 32, 64)],  # under one 32-row chunk
}


@pytest.mark.parametrize("case", list(SCHEDULES), ids=str)
def test_fwd_schedule_covers_every_member_and_row_once_in_order(
        monkeypatch, case):
    """Enumerated chunk by chunk (members, then rows), the chunks visit
    every (member, row) once in (member, row) order; each chunk's codes
    fit the cap unless one 32-row chunk of one member does not."""
    n_m, b, n, cap = case
    monkeypatch.setattr(ft, "WORKSPACE_BYTES", cap)
    chunks = ft.fwd_chunks(n_m, b, n)
    assert chunks == SCHEDULES[case]
    visited = [(m, row) for ml, mh, bl, bh in chunks
               for m in range(ml, mh) for row in range(bl, bh)]
    assert visited == [(m, row) for m in range(n_m) for row in range(b)]
    for ml, mh, bl, bh in chunks:
        assert (bh - bl) % 32 == 0
        assert 4 * (mh - ml) * (bh - bl) * n <= max(cap, 4 * 32 * n)
