"""K8's chunk schedule, its per-launch list, and its contract on the CPU.
On CUDA tensors ``big_sae_forward`` walks the batch in chunks of
``fwd_chunk_rows`` rows whose feature-major codes fit the workspace cap
``WORKSPACE_BYTES`` (K9's cap too), each chunk writing its own rows of x̂;
the schedule is checked here at the trainer's shape and with the cap
lowered (chunk lengths with a short last chunk). The chunks sum nothing
across one another, so on CPU tensors the wrapper returns the plain
version, held here against the JAX ``big_sae_forward`` (Pallas interpret
mode) on the same numpy inputs at the shapes the schedule tests split.
Tolerance: rtol 1e-5, atol 1e-5 of each element (as
tests/test_torch_port_big_sae.py: the same f32 products summed in another
order); two calls bitwise. The kernels' chunks are held against the plain
version on the card (tests/test_torch_port_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_big_sae as jfb
from sparse_coding_tpu_torch.config import BigSAEArgs
from sparse_coding_tpu_torch.ops import _build
from sparse_coding_tpu_torch.ops import fused_big_sae as tfb

# (batch, n_feats, d, rows per chunk) -> chunk lengths
CASES = {
    (96, 96, 40, 32): [32, 32, 32],
    (160, 64, 300, 64): [64, 64, 32],
    (224, 32, 129, 96): [96, 96, 32],
    (64, 64, 1024, 64): [64],
}


def _inputs(b, n, d, seed=0):
    """Raw params (a unit dictionary, an N(0, 1/d) encoder, small
    thresholds) and a centered batch, as numpy."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dictionary = rs.normal(size=(n, d))
    dictionary /= np.linalg.norm(dictionary, axis=-1, keepdims=True)
    p = {"dict": f32(dictionary),
         "encoder": f32(rs.normal(size=(d, n)) / np.sqrt(d)),
         "threshold": f32(rs.normal(size=n) * 0.05),
         "centering": f32(rs.normal(size=d) * 0.1)}
    return p, f32(rs.normal(size=(b, d)))


@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_fwd_schedule_covers_every_row_once_in_order(monkeypatch, case):
    """With the cap lowered to ``rows`` rows of codes, the chunks are
    ``rows`` long but the last, visit every batch row once in order, and
    each chunk's [n, rows] codes fit the cap."""
    b, n, _, rows = case
    cap = 4 * n * rows
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", cap)
    chunks = tfb.fwd_chunks(b, n)
    assert [hi - lo for lo, hi in chunks] == CASES[case]
    assert [i for lo, hi in chunks for i in range(lo, hi)] == list(range(b))
    assert all(4 * (hi - lo) * n <= cap and (hi - lo) % 32 == 0
               for lo, hi in chunks)


@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_forward_matches_jax(monkeypatch, case):
    """On CPU tensors big_sae_forward is big_sae_forward_plain, bit for bit
    and twice over, and both match the JAX big_sae_forward."""
    b, n, d, rows = case
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 4 * n * rows)
    p, xc = _inputs(b, n, d)
    want = np.asarray(jfb.big_sae_forward(p, jnp.asarray(xc), batch_tile=32,
                                          feat_tile=32, interpret=True))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tfb.big_sae_forward(tp, torch.from_numpy(xc))
    assert torch.equal(got, tfb.big_sae_forward_plain(tp,
                                                      torch.from_numpy(xc)))
    assert torch.equal(got, tfb.big_sae_forward(tp, torch.from_numpy(xc)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_chunks_at_the_trainers_shape(monkeypatch):
    """At BigSAEArgs' defaults (batch 65,536, 16,384 features) one cap
    serves both kernels: K8's chunk is 16,384 rows whose codes are exactly
    the 1 GiB cap (4 equal chunks), K9's 8,192 rows whose C and G are (8
    chunks). A chunk is never under 32 rows nor over the batch."""
    cfg = BigSAEArgs()
    b, n = cfg.batch_size, cfg.n_feats
    rows = tfb.fwd_chunk_rows(b, n)
    assert rows == 16384 == 2 * tfb.bwd_chunk_rows(b, n)
    assert rows * n * 4 == tfb.WORKSPACE_BYTES == 2**30
    assert tfb.fwd_chunks(b, n) == [(lo, lo + rows)
                                    for lo in range(0, b, rows)]
    assert tfb.fwd_chunk_rows(64, n) == 64
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 1024)
    assert tfb.fwd_chunk_rows(b, n) == 32


PARTS = {"big_sae_fwd": (_build.BIG_FWD_PARTS, ("codes", "decode")),
         "big_sae_bwd": (_build.BWD_PARTS, ("codes", "dpre", "de", "dwn"))}


@pytest.mark.parametrize("kernel", list(PARTS))
def test_one_chunk_launches_name_every_part_in_order(monkeypatch, kernel):
    """fused_big_sae.one_chunk_launches (what chip_smoke.py and
    scripts/time_kernel_parts.py time launch by launch) lists each part of
    K8 or K9 once, in the order of its _build tuple, on the first chunk of
    the kernel's schedule: 2·rows·n·d FLOPs for a product, 2·n·d for K9's
    dctr matvec, 0 for its sums; building the list launches nothing, and
    another kernel's name raises."""
    b, n, d = 96, 64, 40
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 2 * 4 * n * 64)
    rows = 64 if kernel == "big_sae_bwd" else 96
    p, xc = _inputs(b, n, d)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xc = torch.from_numpy(xc)
    _build.reset_launches()
    got = tfb.one_chunk_launches(kernel, tp, xc, r=torch.zeros_like(xc),
                                 alpha=torch.tensor(1e-3))
    parts, products = PARTS[kernel]
    assert tuple(got) == parts
    want = {k: 2.0 * rows * n * d if k[len(kernel) + 1:] in products
            else 0.0 for k in parts}
    if kernel == "big_sae_bwd":
        want["big_sae_bwd_dctr"] = 2.0 * n * d
    assert {k: f for k, (_, f) in got.items()} == want
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError, match="not a chunked"):
        tfb.one_chunk_launches("sae_tied_fwd", tp, xc)
