"""Large single-SAE trainer with dead-feature resurrection (the JAX
package's ``train/big_sae.py``).

One SAE (d=1024, 16,384 features, batch 65,536 by default —
``config.BigSAEArgs``) trains on a chunk store with exact optax Adam
(``ensemble.adam_update``). On the card the step runs the two big-SAE
kernels (``ops/fused_big_sae.py``) when they take the shape and the codes
would be at least ``FUSED_AUTO_CODES_BYTES``; otherwise autograd of
:func:`_sae_loss`. Per-feature activation mass and the worst-reconstructed
examples are tracked every step; :func:`resurrect_dead_features`
reinitializes never-fired encoder columns to those examples (scaled by
0.2 / mean encoder column norm) and zeroes their Adam moments.

"Tied" here is not the ensemble's weight tying: ``encoder`` and ``dict``
are separate leaves; ``tied`` only sets ``encoder := dictᵀ`` at init and
adds ``centering`` back to x̂ (the untied objective does not uncenter).

On a mesh (:mod:`parallel.mesh`) the features split over "model" (dict
rows, encoder columns, thresholds, activation totals and their Adam
moments; ``partition.BIG_SAE_STATE_RULES``) and the rows over "data":
K8 forms each rank's partial x̂ over its features, an all-reduce over
"model" completes it, K9 runs on the rank's rows with the global batch as
its normalizer, and the grads sum over "data" (the centering's and the
l1/l0 sums over both axes). The mesh step always runs the kernels: the
JAX step's GSPMD autodiff on a mesh is not ported, so a shape the kernels
refuse raises there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.ensemble import (
    adam_update,
    bias_corrections,
    safe_increment,
)
from sparse_coding_tpu_torch.models.learned_dict import (
    LearnedDict,
    normalize_rows,
)
from sparse_coding_tpu_torch.ops._build import BIG_MAX_D
from sparse_coding_tpu_torch.parallel import partition
from sparse_coding_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

Tensor = torch.Tensor

ENCODER_NORM_RATIO = 0.2  # reference: huge_batch_size.py:231
PARAM_NAMES = ("dict", "encoder", "threshold", "centering")


@dataclasses.dataclass(frozen=True)
class BigSAEAdam:
    """optax.adam(lr, eps_root=0.0): the hyperparameters of the step."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass
class BigSAEState:
    """Params, Adam state (optax's ``ScaleByAdamState``: a scalar int32
    ``count`` and ``mu``/``nu`` keyed like ``params``) and dead-feature
    tracking, all on one device."""

    params: dict[str, Tensor]  # dict [n, d], encoder [d, n], threshold [n], centering [d]
    count: Tensor
    mu: dict[str, Tensor]
    nu: dict[str, Tensor]
    c_totals: Tensor  # [n] activation mass per feature since last resurrection
    worst_losses: Tensor  # [K] highest per-example MSEs seen
    worst_vectors: Tensor  # [K, d] the examples themselves (raw batch rows)
    step: Tensor
    tied: bool = False

    def replace(self, **kwargs) -> "BigSAEState":
        return dataclasses.replace(self, **kwargs)


def init_big_sae(generator: torch.Generator, activation_size: int,
                 n_feats: int, l1_alpha: float, lr: float = 1e-3,
                 tied: bool = False, n_worst: int = 1024,
                 dtype=torch.float32, device=None
                 ) -> tuple[BigSAEState, BigSAEAdam, Tensor]:
    """(state, optimizer, l1_alpha tensor). The weights are drawn on the CPU
    from ``generator`` (the dictionary, then the untied encoder), so every
    device starts from the same numbers; ``device=None`` means cuda."""
    dev = resolve_device(device)
    dictionary = torch.randn((n_feats, activation_size), generator=generator,
                             dtype=dtype)
    dictionary = dictionary / torch.linalg.vector_norm(dictionary, dim=-1,
                                                       keepdim=True)
    encoder = (dictionary.T.contiguous() if tied
               else torch.randn((activation_size, n_feats),
                                generator=generator, dtype=dtype))
    params = {"dict": dictionary, "encoder": encoder,
              "threshold": torch.zeros((n_feats,), dtype=dtype),
              "centering": torch.zeros((activation_size,), dtype=dtype)}
    params = {k: v.to(dev) for k, v in params.items()}
    state = BigSAEState(
        params=params, count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        c_totals=torch.zeros((n_feats,), dtype=dtype, device=dev),
        worst_losses=torch.full((n_worst,), -torch.inf, dtype=dtype,
                                device=dev),
        worst_vectors=torch.zeros((n_worst, activation_size), dtype=dtype,
                                  device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev), tied=tied)
    return (state, BigSAEAdam(lr=lr),
            torch.tensor(l1_alpha, dtype=dtype, device=dev))


def _sae_loss(params: dict, batch: Tensor, l1_alpha, tied: bool):
    """The autodiff reference objective (reference: SAE.forward /
    UntiedSAE.forward, huge_batch_size.py:50-59, 88-98; the untied variant
    does not add centering back). Returns (loss, (mse, sparsity, c,
    mse_losses))."""
    normed_dict = params["dict"] / torch.linalg.vector_norm(
        params["dict"], dim=-1, keepdim=True)
    x_centered = batch - params["centering"]
    c = torch.relu(x_centered @ params["encoder"] + params["threshold"])
    x_hat = c @ normed_dict
    if tied:
        x_hat = x_hat + params["centering"]
    mse_losses = torch.mean(torch.square(batch - x_hat), dim=-1)
    mse = torch.mean(mse_losses)
    sparsity = l1_alpha * torch.mean(torch.sum(torch.abs(c), dim=-1))
    return mse + sparsity, (mse, sparsity, c, mse_losses)


def _autodiff_loss_and_grads(params: dict, batch: Tensor, l1_alpha,
                             tied: bool):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, (mse, sparsity, c, mse_losses) = _sae_loss(leaves, batch,
                                                         l1_alpha, tied)
        grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES])
    c = c.detach()
    aux = {"mse": mse.detach(), "sparsity": sparsity.detach(),
           "c_totals_delta": torch.sum(c, dim=0),
           "mse_losses": mse_losses.detach(),
           "l0_mean": torch.mean(torch.sum(c > 0, dim=-1).to(torch.float32))}
    return loss.detach(), aux, dict(zip(PARAM_NAMES, grads))


# auto-mode threshold for the kernels: the [B, n] codes bytes autodiff
# would materialize before auto switches to the never-materialize kernels.
# The JAX package tuned it on a TPU v5e with 16 GiB of HBM; re-tuning it
# for an 80 GB card is open work (ROADMAP).
FUSED_AUTO_CODES_BYTES = 2 * 2**30


def fused_auto_choice(use_fused, fused_possible: bool,
                      local_b: int, local_n: int,
                      codes_itemsize: int = 4) -> bool:
    """The kernels-vs-autodiff decision given admissibility: explicit True
    always takes the kernels, explicit False never does; auto takes them
    only when the codes block autodiff would materialize (local_b ×
    local_n × codes_itemsize) reaches FUSED_AUTO_CODES_BYTES."""
    if use_fused is False or not fused_possible:
        return False
    return (use_fused is True
            or local_b * local_n * codes_itemsize >= FUSED_AUTO_CODES_BYTES)


def _sharded_fused_loss_and_grads(params: dict, batch: Tensor, l1_alpha,
                                  tied: bool, mesh: Mesh, total_b: int,
                                  compute_dtype: str = "float32"):
    """The mesh's loss and grads from this rank's feature shard of the
    params and its rows of the batch (the JAX function of this name, one
    rank's part): K8's partial x̂ over the local features, summed over
    "model"; K9 with the global batch as normalizer; de, dwn, dt and the
    activation totals summed over "data", the l1/l0 sums and the centering
    grad over both axes. The per-row losses come back for every row of
    the global batch (an all-gather over "data"), as the worst-example
    tracker needs them."""
    from sparse_coding_tpu_torch.ops.fused_big_sae import (
        big_sae_backward,
        big_sae_forward,
        pick_big_sae_tiles,
    )
    from sparse_coding_tpu_torch.ops.fused_sae import normalize_with_vjp

    n, d = params["dict"].shape
    b = batch.shape[0]
    tiles = pick_big_sae_tiles(
        b, n, d, compute_itemsize=2 if compute_dtype == "bfloat16" else 4)
    if tiles is None:
        raise ValueError(
            f"the big-SAE kernels do not take the per-rank batch={b}, "
            f"n_feats={n}, d={d} of a {mesh.shape[MODEL_AXIS]}x"
            f"{mesh.shape[DATA_AXIS]} mesh (batch and n_feats multiples "
            f"of 32, 1 <= d <= {BIG_MAX_D}, d % 8 == 0 under bf16 "
            "compute); the "
            "JAX step's GSPMD autodiff on a mesh is not ported")
    bt, ft = tiles
    x = batch.to(torch.float32).contiguous()
    alpha = torch.as_tensor(l1_alpha, dtype=torch.float32, device=x.device)
    xc = (x - params["centering"]).contiguous()
    x_hat = mesh.psum(big_sae_forward(params, xc, bt, ft,
                                      compute_dtype=compute_dtype),
                      MODEL_AXIS)
    if tied:
        x_hat = x_hat + params["centering"]
    r = (x_hat - x).contiguous()  # the same on every model shard
    mse_losses = mesh.all_gather(torch.mean(torch.square(r), dim=-1),
                                 DATA_AXIS)
    de, dwn, dt, dctr_enc, c_totals, scal = big_sae_backward(
        params, alpha, xc, r, bt, ft, total_batch=total_b,
        compute_dtype=compute_dtype)
    coef = 2.0 / (total_b * d)
    data_sums = [torch.sum(torch.square(r)).reshape(1), de, dwn, dt,
                 c_totals] + ([coef * r.sum(dim=0)] if tied else [])
    sr, de, dwn, dt, c_totals, *rsum = mesh.psum(data_sums, DATA_AXIS)
    scal, dctr = mesh.psum([scal, dctr_enc], (MODEL_AXIS, DATA_AXIS))
    if tied:
        dctr = dctr + rsum[0]
    mse = sr[0] / (total_b * d)
    sparsity = alpha * scal[0] / total_b
    grads = {"dict": normalize_with_vjp(params["dict"], dwn),
             "encoder": de, "threshold": dt, "centering": dctr}
    aux = {"mse": mse, "sparsity": sparsity, "c_totals_delta": c_totals,
           "mse_losses": mse_losses, "l0_mean": scal[1] / total_b}
    return mse + sparsity, aux, grads


def make_big_sae_step(optimizer: BigSAEAdam, l1_alpha, mesh=None,
                      use_fused: str | bool = "auto",
                      fused_compute_dtype: str = "float32"):
    """(state, batch) -> (state, metrics) on the state's device.

    use_fused: "auto" takes the kernels on the card when they take the
    shape (``pick_big_sae_tiles``) and the codes would be at least
    ``FUSED_AUTO_CODES_BYTES``, else autodiff — chosen by shape, never as
    a fallback on failure; on the CPU "auto" is autodiff. True takes the
    kernels (their plain versions on the CPU) and raises ValueError for a
    shape they do not take; False is always autodiff.

    fused_compute_dtype: "float32", or "bfloat16" for the kernels' bf16
    forms (bf16 dot operands, fp32 accumulation; they also need d % 8 ==
    0), as the JAX step's option; autodiff stays fp32.

    mesh: the state is this rank's shard (:func:`shard_big_sae`) and every
    rank passes the same global batch; the step runs the kernels on the
    rank's features and rows ("auto" or True; False raises) and returns
    the same metrics on every rank."""
    from sparse_coding_tpu_torch.ops.fused_big_sae import (
        fused_big_sae_loss_and_grads,
        pick_big_sae_tiles,
    )

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh is not None and use_fused is False:
        raise ValueError(
            "use_fused=False on a mesh: the JAX step's GSPMD autodiff on a "
            "mesh is not ported; the mesh step runs the kernels")
    if use_fused not in (True, False, "auto"):
        raise ValueError(f"use_fused must be True, False or 'auto', got "
                         f"{use_fused!r}")
    if fused_compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"fused_compute_dtype={fused_compute_dtype!r}: the big-SAE "
            "kernels take float32 or bfloat16")
    # the same derivation the kernels' own tile pick uses, so the gate and
    # the inner admission never disagree (as the JAX step)
    compute_itemsize = 2 if fused_compute_dtype == "bfloat16" else 4
    lr = float(optimizer.lr)

    def mesh_loss_and_grads(state: BigSAEState, batch: Tensor):
        local = partition.place_batch(batch, mesh)
        return _sharded_fused_loss_and_grads(
            state.params, local, l1_alpha, state.tied, mesh,
            int(batch.shape[0]), compute_dtype=fused_compute_dtype)

    def loss_and_grads(state: BigSAEState, batch: Tensor):
        n, d = state.params["dict"].shape
        b = batch.shape[0]
        on_card = batch.device.type == "cuda"
        fused_possible = (use_fused is not False
                          and (on_card or use_fused is True)
                          and pick_big_sae_tiles(
                              b, n, d, compute_itemsize) is not None)
        if use_fused is True and not fused_possible:
            raise ValueError(
                f"use_fused=True but the big-SAE kernels do not take batch="
                f"{b}, n={n}, d={d} (batch and n must be multiples of 32, "
                f"1 <= d <= {BIG_MAX_D}, and d % 8 == 0 under bf16 "
                "compute)")
        codes_itemsize = torch.promote_types(
            batch.dtype, state.params["dict"].dtype).itemsize
        if fused_auto_choice(use_fused, fused_possible, b, n,
                             codes_itemsize):
            return fused_big_sae_loss_and_grads(
                state.params, batch, l1_alpha, state.tied,
                compute_dtype=fused_compute_dtype)
        return _autodiff_loss_and_grads(state.params, batch, l1_alpha,
                                        state.tied)

    def step(state: BigSAEState, batch: Tensor):
        loss, aux, grads = (loss_and_grads if mesh is None
                            else mesh_loss_and_grads)(state, batch)
        count = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count, optimizer.b1, optimizer.b2)
        # filled on the device: no blocking host→device copy in the step
        lrs = torch.full((), lr, dtype=torch.float32, device=batch.device)
        params, mu, nu, _ = adam_update(grads, state.mu, state.nu,
                                        state.params, lrs, bc1, bc2,
                                        optimizer.b1, optimizer.b2,
                                        optimizer.eps)

        # dead-feature tracking (reference: c_totals += c.sum(0), :206;
        # WorstIndices.update, :120-146 — here one top-K over the merged
        # buffer; a stable descending sort breaks ties by the lower index,
        # as jax.lax.top_k does)
        c_totals = state.c_totals + aux["c_totals_delta"]
        k = state.worst_losses.shape[0]
        all_losses = torch.cat([state.worst_losses, aux["mse_losses"]])
        top_idx = torch.sort(all_losses, descending=True,
                             stable=True).indices[:k]
        all_vectors = torch.cat([state.worst_vectors,
                                 batch.to(state.worst_vectors.dtype)])
        new_state = state.replace(
            params=params, count=count, mu=mu, nu=nu, c_totals=c_totals,
            worst_losses=all_losses[top_idx],
            worst_vectors=all_vectors[top_idx], step=state.step + 1)
        metrics = {"loss": loss, "mse": aux["mse"],
                   "sparsity": aux["sparsity"], "l0": aux["l0_mean"],
                   "center_norm": torch.linalg.vector_norm(
                       params["centering"])}
        return new_state, metrics

    return step


def resurrect_dead_features(state: BigSAEState, mesh=None
                            ) -> tuple[BigSAEState, Tensor]:
    """Reinit never-fired features to the worst-reconstructed examples and
    zero their Adam moments (reference: huge_batch_size.py:224-250). The
    i-th dead feature (in feature order) takes the i-th worst example;
    Adam's count is not reset. Returns (state, n_dead) — n_dead stays on
    the device. On a ``mesh`` (a collective) each model shard counts the
    dead features of the shards before it, so the i-th dead feature of
    the whole dictionary still takes the i-th worst example, and the mean
    encoder column norm is over every feature."""
    params = state.params
    dead = state.c_totals == 0.0  # [n] (this shard's on a mesh)
    n_dead = torch.sum(dead)
    before = 0
    col_norms = torch.linalg.vector_norm(params["encoder"], dim=0)
    if mesh is None:
        av_enc_norm = torch.mean(col_norms)
    else:
        counts = mesh.all_gather(n_dead.reshape(1), MODEL_AXIS)
        before = torch.sum(counts[:mesh.coords[MODEL_AXIS]])
        n_dead = torch.sum(counts)
        av_enc_norm = (mesh.psum(torch.sum(col_norms), MODEL_AXIS)
                       / (col_norms.shape[0] * mesh.shape[MODEL_AXIS]))

    order = torch.argsort(-state.worst_losses, stable=True)
    worst_sorted = state.worst_vectors[order]  # [K, d] worst first
    rank = torch.clamp(torch.cumsum(dead, dim=0) - 1 + before, 0,
                       worst_sorted.shape[0] - 1)
    candidate = worst_sorted[rank]  # [n, d]
    new_cols = (candidate * ENCODER_NORM_RATIO / av_enc_norm).T  # [d, n]
    encoder = torch.where(dead[None, :], new_cols, params["encoder"])
    zero = torch.zeros((), dtype=params["encoder"].dtype,
                       device=params["encoder"].device)
    masks = {"encoder": dead[None, :], "dict": dead[:, None],
             "threshold": dead}

    def reset(moments: dict) -> dict:
        return {k: torch.where(masks[k], zero, m) if k in masks else m
                for k, m in moments.items()}

    new_state = state.replace(
        params=dict(params, encoder=encoder.contiguous()),
        mu=reset(state.mu), nu=reset(state.nu),
        c_totals=torch.zeros_like(state.c_totals),
        worst_losses=torch.full_like(state.worst_losses, -torch.inf),
        worst_vectors=torch.zeros_like(state.worst_vectors))
    return new_state, n_dead


@dataclasses.dataclass
class BigSAEDict(LearnedDict):
    """Inference export matching the training objective: encode on the
    centered input; only the tied objective adds the centre back."""

    dictionary: Tensor  # [n, d]
    encoder: Tensor  # [d, n]
    threshold: Tensor  # [n]
    centering: Tensor  # [d]
    add_center_back: bool = False

    def get_learned_dict(self) -> Tensor:
        return normalize_rows(self.dictionary)

    def center(self, x: Tensor) -> Tensor:
        return x - self.centering

    def uncenter(self, x: Tensor) -> Tensor:
        return x + self.centering if self.add_center_back else x

    def encode(self, x: Tensor) -> Tensor:
        return torch.relu(x @ self.encoder + self.threshold)


def shard_big_sae(state: BigSAEState, mesh: Mesh) -> BigSAEState:
    """This rank's shard of a full state (``BIG_SAE_STATE_RULES``: dict
    rows, encoder columns, thresholds, activation totals and their Adam
    moments over "model"; the rest replicated), through the
    ``partition.place`` seam."""
    return partition.place_tree(state, mesh, partition.BIG_SAE_STATE_RULES)


def gather_big_sae(state: BigSAEState, mesh: Mesh) -> BigSAEState:
    """The whole state from every rank's shard (a collective)."""
    return partition.gather_tree(state, mesh, partition.BIG_SAE_STATE_RULES)


def to_learned_dict(state: BigSAEState) -> BigSAEDict:
    return BigSAEDict(dictionary=state.params["dict"],
                      encoder=state.params["encoder"],
                      threshold=state.params["threshold"],
                      centering=state.params["centering"],
                      add_center_back=state.tied)


def train_big_sae(cfg, store=None, mesh=None, logger=None,
                  device=None) -> BigSAEState:
    """Chunk-driven training loop (reference: huge_batch_size.py:150-335)
    with periodic resurrection. Same batch order as the JAX trainer
    (``np.random.default_rng(cfg.seed)``); the init comes from a
    ``torch.Generator`` seeded with ``cfg.seed``. ``scan_steps`` windows
    are a Python loop; logging (every 100 steps) and resurrection happen at
    window boundaries, as in the JAX trainer. With a ``mesh`` every rank
    reads the same batches and trains its shard; the returned state is the
    rank's shard (:func:`gather_big_sae` makes it whole)."""
    from sparse_coding_tpu_torch.data.chunk_store import (
        device_prefetch,
        window_stacks,
    )
    from sparse_coding_tpu_torch.data.shard_store import open_store

    dev = mesh.device if mesh is not None else resolve_device(device)
    store = store or open_store(cfg.dataset_folder, quarantine_corrupt=True)
    state, optimizer, l1 = init_big_sae(
        torch.Generator().manual_seed(cfg.seed), cfg.activation_dim,
        cfg.n_feats, cfg.l1_alpha, lr=cfg.lr,
        device=dev if mesh is None else "cpu")
    if mesh is not None:
        state, l1 = shard_big_sae(state, mesh), l1.to(dev)
    step_fn = make_big_sae_step(optimizer, l1, mesh)

    rng = np.random.default_rng(cfg.seed)
    scan_k = max(1, int(getattr(cfg, "scan_steps", 1)))
    steps = last_log = last_resurrect = 0
    for _ in range(cfg.n_epochs):
        batches = store.epoch(cfg.batch_size, rng)
        if scan_k > 1:
            batches = window_stacks(batches, scan_k)
        for batch in device_prefetch(batches, dev):
            window = batch if scan_k > 1 else batch[None]
            for one in window:
                state, metrics = step_fn(state, one)
            steps += window.shape[0]
            if logger is not None and steps - last_log >= 100:
                last_log = steps
                # one host sync for the whole metrics dict per log window
                host = torch.stack(list(metrics.values())).cpu().tolist()
                logger.log(dict(zip(metrics, host)), step=steps)
            if (cfg.resurrect_every
                    and steps - last_resurrect >= cfg.resurrect_every):
                last_resurrect = steps
                state, n_dead = resurrect_dead_features(state, mesh)
                if logger is not None:
                    logger.log({"n_dead_feats": int(n_dead)}, step=steps)
    return state
