"""K9's chunk schedule on the CPU. ``big_sae_backward`` on CPU tensors runs
the kernels' schedule in plain torch: the batch in chunks of
``bwd_chunk_rows`` rows (the workspace cap ``WORKSPACE_BYTES``), each
chunk's products and sums added in order. Held against the JAX
``big_sae_backward`` (Pallas interpret mode) with the cap lowered so the
batch splits into several chunks, one of them short, for the untied and
the tied residual. Tolerances: rtol 2e-4 / atol 1e-6 (the JAX
fused-vs-autodiff bound), c_totals rtol 1e-4; two calls bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ops import fused_big_sae as jfb
from sparse_coding_tpu_torch.config import BigSAEArgs
from sparse_coding_tpu_torch.ops import fused_big_sae as tfb

# (batch, n_feats, d, rows per chunk) -> chunk lengths
CASES = {
    (96, 96, 40, 32): [32, 32, 32],
    (64, 64, 300, 32): [32, 32],
    (160, 96, 40, 64): [64, 64, 32],
    (224, 64, 300, 96): [96, 96, 32],
}
ALPHA = np.float32(3e-3)


def _inputs(b, n, d, tied, seed=0):
    """Raw params, the centered batch and the residual r (x̂ − x, or
    x̂ + ctr − x when tied) from the JAX forward, as numpy."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dictionary = rs.normal(size=(n, d))
    dictionary /= np.linalg.norm(dictionary, axis=-1, keepdims=True)
    encoder = dictionary.T if tied else rs.normal(size=(d, n)) / np.sqrt(d)
    p = {"dict": f32(dictionary), "encoder": f32(encoder),
         "threshold": f32(rs.normal(size=n) * 0.05),
         "centering": f32(rs.normal(size=d) * 0.1)}
    x = f32(rs.normal(size=(b, d)))
    xc = f32(x - p["centering"])
    xhat = np.asarray(jfb.big_sae_forward(p, jnp.asarray(xc), batch_tile=32,
                                          feat_tile=32, interpret=True))
    r = f32(xhat + p["centering"] - x if tied else xhat - x)
    return p, xc, r


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_chunked_backward_matches_jax(monkeypatch, case, tied):
    b, n, d, rows = case
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 2 * 4 * n * rows)
    chunks = tfb.bwd_chunks(b, n)
    assert [hi - lo for lo, hi in chunks] == CASES[case]
    p, xc, r = _inputs(b, n, d, tied)
    want = jfb.big_sae_backward(p, jnp.asarray(ALPHA), jnp.asarray(xc),
                                jnp.asarray(r), batch_tile=32, feat_tile=32,
                                interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    args = (tp, torch.tensor(ALPHA), torch.from_numpy(xc),
            torch.from_numpy(r))
    got = tfb.big_sae_backward(*args)
    names = ("dE", "dWn", "dt", "dctr_enc", "c_totals", "l1_l0")
    for name, g, w in zip(names, got, want):
        if name == "c_totals":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                       atol=1e-6, err_msg=name)
    again = tfb.big_sae_backward(*args)
    for name, g, a in zip(names, got, again):
        assert torch.equal(g, a), name


def test_chunk_rows_at_the_trainers_shape(monkeypatch):
    """At BigSAEArgs' defaults (batch 65,536, 16,384 features) a chunk is
    8,192 rows and its two workspaces are exactly the 1 GiB cap: 8 equal
    chunks. A chunk is never under 32 rows nor over the batch."""
    cfg = BigSAEArgs()
    b, n = cfg.batch_size, cfg.n_feats
    rows = tfb.bwd_chunk_rows(b, n)
    assert rows == 8192
    assert 2 * rows * n * 4 == tfb.WORKSPACE_BYTES == 2**30
    assert tfb.bwd_chunks(b, n) == [(lo, lo + 8192)
                                    for lo in range(0, b, 8192)]
    assert tfb.bwd_chunk_rows(64, n) == 64
    monkeypatch.setattr(tfb, "WORKSPACE_BYTES", 1024)
    assert tfb.bwd_chunk_rows(b, n) == 32
