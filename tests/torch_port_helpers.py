"""Shared inputs of the PyTorch port's parity tests (tests/test_torch_port_*).

Every input is a seeded numpy array handed to both sides — the JAX package
(its Pallas kernels in interpret mode) and the port (its plain PyTorch
versions on the CPU) — so the two compute on identical numbers."""

import numpy as np

N_MEMBERS, D, N_FEATS, BATCH = 3, 32, 64, 128
BATCH_TILE, FEAT_TILE = 32, 16
L1S = (1e-3, 1e-2, 3e-2)
ADAM = (0.9, 0.999, 1e-8)


def kernel_inputs(seed: int = 0, n_members: int = N_MEMBERS, d: int = D,
                  n_feats: int = N_FEATS, batch: int = BATCH) -> dict:
    """Raw dictionaries (glorot scale), small biases, an L1 grid, a batch,
    a kernel-side dW, and a mid-training Adam state (count 7), all f32."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    lim = np.sqrt(6.0 / (n_feats + d))
    b1, b2, _ = ADAM
    count_inc = np.full((n_members,), 8, np.int32)
    return {
        "e": f32(rs.uniform(-lim, lim, (n_members, n_feats, d))),
        "bias": f32(rs.uniform(-0.05, 0.05, (n_members, n_feats))),
        "alphas": f32(np.resize(L1S, n_members)),
        "x": f32(rs.normal(size=(batch, d))),
        "dw": f32(rs.normal(size=(n_members, n_feats, d)) * 1e-3),
        "mu": f32(rs.normal(size=(n_members, n_feats, d)) * 1e-3),
        "nu": f32(rs.uniform(0.5, 1.5, (n_members, n_feats, d)) * 1e-6),
        "mu_b": f32(rs.normal(size=(n_members, n_feats)) * 1e-3),
        "nu_b": f32(rs.uniform(0.5, 1.5, (n_members, n_feats)) * 1e-6),
        "lrs": f32(np.linspace(1e-3, 3e-3, n_members)),
        "bc1": f32(1.0 - np.float32(b1) ** count_inc.astype(np.float32)),
        "bc2": f32(1.0 - np.float32(b2) ** count_inc.astype(np.float32)),
    }


def batches(seed: int, n: int, batch: int = BATCH, d: int = D) -> np.ndarray:
    """[n, batch, d] training batches: sparse nonnegative codes over a
    random unit dictionary, so the SAEs have something to learn."""
    rs = np.random.default_rng(seed)
    feats = rs.normal(size=(2 * d, d))
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    codes = rs.uniform(size=(n, batch, 2 * d)) * (
        rs.uniform(size=(n, batch, 2 * d)) < 0.1)
    return (codes @ feats).astype(np.float32)
