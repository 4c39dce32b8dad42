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
    a kernel-side dW, and a mid-training Adam state (count 7), all f32;
    then the untied decoder with its dWn and moments, and a masked-tied
    coefficient mask (bool)."""
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
        # untied: a raw decoder, its kernel-side dWn and its Adam moments
        "dec": f32(rs.uniform(-lim, lim, (n_members, n_feats, d))),
        "dwn": f32(rs.normal(size=(n_members, n_feats, d)) * 1e-3),
        "mu_d": f32(rs.normal(size=(n_members, n_feats, d)) * 1e-3),
        "nu_d": f32(rs.uniform(0.5, 1.5, (n_members, n_feats, d)) * 1e-6),
        # masked-tied: mixed dictionary sizes padded to n_feats
        "coef_mask": (np.arange(n_feats)[None, :]
                      < np.resize(dict_sizes(n_feats), n_members)[:, None]),
    }


def dict_sizes(n_stack: int = N_FEATS) -> list[int]:
    """The masked-tied members' dictionary sizes: a quarter, a half and
    all of the padded stack."""
    return [n_stack // 4, n_stack // 2, n_stack]


def batches(seed: int, n: int, batch: int = BATCH, d: int = D) -> np.ndarray:
    """[n, batch, d] training batches: sparse nonnegative codes over a
    random unit dictionary, so the SAEs have something to learn."""
    rs = np.random.default_rng(seed)
    feats = rs.normal(size=(2 * d, d))
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    codes = rs.uniform(size=(n, batch, 2 * d)) * (
        rs.uniform(size=(n, batch, 2 * d)) < 0.1)
    return (codes @ feats).astype(np.float32)


def run_world(tmp_path, case: str, n_procs: int, *args, timeout: float = 240):
    """Start ``n_procs`` ranks of tests/torch_port_world.py CASE, each
    joining one gloo world through a FileStore under ``tmp_path`` (no TCP
    port: concurrent test workers never collide); wait for all, kill any
    survivor, fail on any rank's exit code, and return every rank's
    result (rank order)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import torch
    from conftest import stripped_cpu_subprocess_env

    here = Path(__file__).resolve().parent
    env = stripped_cpu_subprocess_env()
    env["PYTHONPATH"] = env["PYTHONPATH"] + os.pathsep + str(here)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    env["OMP_NUM_THREADS"] = "1"  # n ranks share the host's cores
    out = Path(tmp_path) / f"world_{case}_{len(list(Path(tmp_path).glob('world_*')))}"
    out.mkdir(parents=True)
    store = out / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_port_world.py"), case, str(r),
         str(n_procs), str(store), str(out), *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n_procs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{log}"
    return [torch.load(out / f"{case}_{r}.pt", weights_only=False)
            for r in range(n_procs)]
