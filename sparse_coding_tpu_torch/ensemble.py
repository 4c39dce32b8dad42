"""The ensemble training engine (the JAX package's ``ensemble.py``):
``Ensemble`` for one bucket, ``EnsembleGroup`` for members split into
buckets by their static buffers.

One bucket of N same-shape members is stacked along a leading member axis.
A step takes one [B, d] batch shared by every member and runs either

- the autodiff reference path (``make_train_step``: ``torch.func.vmap`` of
  ``grad`` over the members, then Adam), or
- one of the kernel paths, whose labels are the JAX package's
  ``KERNEL_PATHS``. Tied: ``two_stage`` (K1 grads, Adam in torch),
  ``train_step`` (K2 whole step), ``two_stage_tiled`` (K3 grads, Adam in
  torch) and ``train_step_tiled`` (K3 grads + K4 Adam/VJP epilogue, the
  default on the card). Untied: ``two_stage`` (K5), ``train_step`` (K5 +
  K6), ``two_stage_tiled`` (K7) and ``train_step_tiled`` (K7 + K6, the
  default). Masked-tied: ``two_stage`` and ``two_stage_tiled`` (K1/K3 with
  the bucket's ``coef_mask``; the default is the tiled one).

Any other family (TopK, LISTA, RICA, the positive, semilinear, reverse,
thresholding and tied-centered SAEs, a tied SAE with a non-identity
centering) trains on the autodiff path. Params may nest one level of
dicts (LISTA's stacked ``encoder_layers``): the state holds them under
flat ``"outer/inner"`` keys, and the signature sees the nesting.

Adam is optax's ``scale_by_adam`` with eps_root=0, exactly: per-member
count [N] int32 with a saturating increment, bias corrections
1 − β^count, and the engine's ``−lr·update``. The in-graph anomaly sentinel
rides every path: a member whose loss, grad norm or update norm went
non-finite — or whose ``live`` bit is cleared — keeps its params and
optimizer state unchanged, bit for bit.

On a mesh (``Ensemble(..., mesh=...)``, :mod:`parallel.mesh`) each rank
holds N/mesh_model members and trains them on its B/mesh_data rows of the
global batch that every rank passes in. The kernels normalize by the
global batch (``total_batch``), one all-reduce over "data" makes the
partial losses and grads whole, and the optimizer runs on the member
shard: the two-stage paths put the all-reduce inside the producer (before
the normalization VJP, and before the untied bias decay, which counts once
a member), the whole-step paths between the grads kernels (K1/K3, K5/K7)
and the Adam epilogues (K4, K6) — K2's single-kernel step cannot split
there, so a mesh ``train_step`` on a tied bucket is K1 + K4, as in the
JAX package. The autodiff path weights each rank's row-mean grads and
losses by its share of the rows before the same all-reduce; every
signature of the zoo is a row mean plus batch-independent terms, which
that split keeps exact. A step's aux is gathered over "model", so every
rank sees every member's values, as a single-device run does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import obs, resolve_device
from sparse_coding_tpu_torch.models.signatures import AuxData
from sparse_coding_tpu_torch.ops import _build, roofline
from sparse_coding_tpu_torch.ops.roofline import KERNEL_PATHS
from sparse_coding_tpu_torch.parallel import partition
from sparse_coding_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from sparse_coding_tpu_torch.utils.tree import flatten_tree, unflatten_tree

Tensor = torch.Tensor
_STATIC_TYPES = (int, float, bool, str, type(None))
_INT32_MAX = 2**31 - 1

StaticBuffers = tuple[tuple[str, Any], ...]


def split_buffers(buffers: dict) -> tuple[dict, StaticBuffers]:
    """Partition a member's buffers into (tensor leaves, static leaves):
    plain Python scalars are shared by every member of a bucket."""
    arrays, statics = {}, {}
    for name, leaf in buffers.items():
        (statics if isinstance(leaf, _STATIC_TYPES) else arrays)[name] = leaf
    return arrays, tuple(sorted(statics.items()))


def merge_buffers(arrays: dict, statics: StaticBuffers) -> dict:
    merged = dict(arrays)
    merged.update(dict(statics))
    return merged


@dataclasses.dataclass
class EnsembleState:
    """Device state for one bucket, everything stacked on axis 0. The Adam
    moments are plain tensors keyed like ``params``; ``count`` is optax's
    per-member step count ([N] int32 under the vmapped init)."""

    params: dict[str, Tensor]
    buffers: dict[str, Tensor]
    mu: dict[str, Tensor]
    nu: dict[str, Tensor]
    count: Tensor  # [N] int32
    lrs: Tensor  # [N] per-member learning rate
    step: Tensor  # scalar int32
    live: Optional[Tensor] = None  # [N] bool; False freezes a member
    static_buffers: StaticBuffers = ()
    sig_name: str = ""

    @property
    def n_members(self) -> int:
        return int(self.lrs.shape[0])

    def replace(self, **kwargs) -> "EnsembleState":
        return dataclasses.replace(self, **kwargs)


# --- optimizer ----------------------------------------------------------------

def safe_increment(count: Tensor) -> Tensor:
    """optax.safe_increment: +1, saturating at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def bias_corrections(count_inc: Tensor, b1: float, b2: float):
    """[N] (1 − b1^count, 1 − b2^count) in float32, as the JAX engine
    precomputes them for the kernels. The bases are filled on the device:
    a ``torch.tensor`` from a Python float would be a blocking host→device
    copy, which synchronizes the host with the card every step."""
    c = count_inc.to(torch.float32)
    one = lambda b: torch.full((), b, dtype=torch.float32, device=c.device)
    return 1.0 - torch.pow(one(b1), c), 1.0 - torch.pow(one(b2), c)


def _per_member(v: Tensor, like: Tensor) -> Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def adam_update(grads: dict, mu: dict, nu: dict, params: dict, lrs: Tensor,
                bc1: Tensor, bc2: Tensor, b1: float, b2: float, eps: float):
    """Vmapped optax scale_by_adam (eps_root=0) + the engine's −lr scaling
    + apply_updates, on stacked trees. Returns (params', mu', nu',
    updates)."""
    new_p, new_mu, new_nu, upd = {}, {}, {}, {}
    for k, g in grads.items():
        m1 = (1.0 - b1) * g + b1 * mu[k]
        v1 = (1.0 - b2) * (g * g) + b2 * nu[k]
        u = (m1 / _per_member(bc1, g)) / (
            torch.sqrt(v1 / _per_member(bc2, g) + 0.0) + eps)
        u = -_per_member(lrs, g) * u
        new_p[k], new_mu[k], new_nu[k], upd[k] = params[k] + u, m1, v1, u
    return new_p, new_mu, new_nu, upd


def _bias_adam_update(bias, db, mu_b, nu_b, lrs, bc1, bc2, b1, b2, eps):
    """Exact optax Adam on the [N, n] bias, in the kernels' form — the one
    home of this formula for the whole-step tiled path."""
    mu2 = b1 * mu_b + (1.0 - b1) * db
    nu2 = b2 * nu_b + (1.0 - b2) * db * db
    bias2 = bias - lrs[:, None] * (mu2 / bc1[:, None]) / (
        torch.sqrt(nu2 / bc2[:, None]) + eps)
    return bias2, mu2, nu2


# --- sentinel -----------------------------------------------------------------

def _member_sq_norm(tree: dict) -> Tensor:
    return sum(torch.sum(torch.square(v), dim=tuple(range(1, v.dim())))
               for v in tree.values())


def _select_members(ok: Tensor, new: dict, old: dict) -> dict:
    """Per-member select over stacked trees: where ``ok[i]`` the new slice,
    else the old one (an exact element copy either way)."""
    return {k: torch.where(_per_member(ok, v), v, old[k])
            for k, v in new.items()}


def _sentinel_finite(loss: Tensor, *norms: Tensor) -> Tensor:
    finite = torch.isfinite(loss)
    for n in norms:
        finite = finite & torch.isfinite(n)
    return finite


def _stamp_inputs_finite(aux: AuxData, batch: Tensor) -> AuxData:
    return aux.replace(inputs_finite=torch.isfinite(batch).all())


def _fused_aux(losses: dict, activity: Tensor) -> AuxData:
    """AuxData of the fused paths, with the autodiff path's loss keys. An
    untied bucket's "bias_decay" entry is folded into the total and
    reported as "l_bias_decay"."""
    total = losses["mse"] + losses["l1"]
    fields = {"l_reconstruction": losses["mse"], "l_l1": losses["l1"]}
    if "bias_decay" in losses:
        total = total + losses["bias_decay"]
        fields["l_bias_decay"] = losses["bias_decay"]
    return AuxData(losses={"loss": total, **fields}, l0=losses["l0"],
                   feat_activity=activity.to(torch.int32))


def _finish(state: EnsembleState, params, mu, nu, count, aux: AuxData,
            batch: Tensor, sentinel: bool, norms: tuple,
            grad_norm: Optional[Tensor]) -> tuple[EnsembleState, AuxData]:
    """Sentinel tail shared by every path: freeze non-finite or non-live
    members and stamp the aux, then advance the step."""
    if sentinel and state.live is not None:
        finite = _sentinel_finite(aux.losses["loss"], *norms)
        ok = state.live & finite
        params = _select_members(ok, params, state.params)
        mu = _select_members(ok, mu, state.mu)
        nu = _select_members(ok, nu, state.nu)
        count = torch.where(ok, count, state.count)
        aux = _stamp_inputs_finite(
            aux.replace(finite=finite, grad_norm=grad_norm), batch)
    return state.replace(params=params, mu=mu, nu=nu, count=count,
                         step=state.step + 1), aux


Step = Callable[[EnsembleState, Tensor], tuple[EnsembleState, AuxData]]


def _data_psum(mesh):
    """The all-reduce over "data" of a sequence of tensors (None: no
    mesh, the identity)."""
    if mesh is None:
        return None
    return lambda tensors: mesh.psum(tensors, DATA_AXIS)


def make_train_step(sig: Any, adam_hypers: tuple[float, float, float],
                    statics: StaticBuffers = (),
                    sentinel: bool = True, mesh=None) -> Step:
    """The autodiff reference step: vmapped grad of ``sig.loss`` over the
    member axis, then Adam. With ``sentinel`` the grad and update norms
    and the finite flags ride the aux. On a ``mesh`` each rank's grads,
    losses and l0 (row means over its rows) are weighted by its share of
    the global batch and summed over "data", the activity counts summed,
    before Adam."""
    b1, b2, eps = adam_hypers

    def member_loss(p, b, x):
        loss, aux = sig.loss(unflatten_tree(p), merge_buffers(b, statics), x)
        return loss, (aux.losses, aux.l0, aux.feat_activity)

    grad_fn = torch.func.vmap(
        torch.func.grad_and_value(member_loss, has_aux=True),
        in_dims=(0, 0, None))

    def step(state: EnsembleState, batch: Tensor):
        grads, (_, (losses, l0, act)) = grad_fn(state.params, state.buffers,
                                                batch)
        if mesh is not None:
            share = 1.0 / mesh.shape[DATA_AXIS]
            gk, lk = list(grads), list(losses)
            out = mesh.psum([grads[k] * share for k in gk]
                            + [losses[k] * share for k in lk]
                            + [l0 * share, act], DATA_AXIS)
            grads = dict(zip(gk, out[:len(gk)]))
            losses = dict(zip(lk, out[len(gk):len(gk) + len(lk)]))
            l0, act = out[-2], out[-1]
        count_inc = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count_inc, b1, b2)
        params, mu, nu, upd = adam_update(grads, state.mu, state.nu,
                                          state.params, state.lrs, bc1, bc2,
                                          b1, b2, eps)
        aux = AuxData(losses=losses, l0=l0, feat_activity=act)
        gn = torch.sqrt(_member_sq_norm(grads))
        un = torch.sqrt(_member_sq_norm(upd))
        return _finish(state, params, mu, nu, count_inc, aux, batch,
                       sentinel, (gn, un), gn)

    return step


def make_fused_step(producer: Callable, adam_hypers, sentinel: bool = True,
                    mesh=None) -> Step:
    """Two-stage fused step: losses + exact grads from the kernels (via
    ``producer``), the optimizer update in plain torch. A producer that
    returns a kernel grad norm (the tiled one) spares the grad-norm pass.
    On a ``mesh`` the producer normalizes by the global batch and sums its
    partial losses and grads over "data" itself; its kernel grad norm, a
    per-shard partial, is dropped for the norm of the summed grads, as in
    the JAX package."""
    b1, b2, eps = adam_hypers
    psum = _data_psum(mesh)

    def step(state: EnsembleState, batch: Tensor):
        if mesh is None:
            losses, grads, activity, gnorm = producer(
                state.params, state.buffers, batch)
        else:
            losses, grads, activity, _ = producer(
                state.params, state.buffers, batch,
                total_batch=batch.shape[0] * mesh.shape[DATA_AXIS],
                psum=psum)
            gnorm = None
        count_inc = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count_inc, b1, b2)
        params, mu, nu, upd = adam_update(grads, state.mu, state.nu,
                                          state.params, state.lrs, bc1, bc2,
                                          b1, b2, eps)
        gn = gnorm if gnorm is not None else torch.sqrt(
            _member_sq_norm(grads))
        un = torch.sqrt(_member_sq_norm(upd))
        return _finish(state, params, mu, nu, count_inc,
                       _fused_aux(losses, activity), batch, sentinel,
                       (gn, un), gn)

    return step


def _tied_producer(compute_dtype):
    """K1 for tied and masked-tied buckets (a masked bucket's coef_mask
    rides into the kernels); the untiled grads leave the grad norm to the
    step."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_tied_sae_loss_and_grads)

    def producer(params, buffers, batch, total_batch=None, psum=None):
        return (*fused_tied_sae_loss_and_grads(
            params, buffers["l1_alpha"], batch, total_batch=total_batch,
            compute_dtype=compute_dtype, coef_mask=buffers.get("coef_mask"),
            psum=psum), None)

    return producer


def _tied_tiled_producer(compute_dtype):
    """K3 for tied and masked-tied buckets, with the kernel grad norm."""
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        fused_tied_sae_tiled_loss_and_grads)

    def producer(params, buffers, batch, total_batch=None, psum=None):
        return fused_tied_sae_tiled_loss_and_grads(
            params, buffers["l1_alpha"], batch, total_batch=total_batch,
            compute_dtype=compute_dtype, coef_mask=buffers.get("coef_mask"),
            psum=psum)

    return producer


def _untied_producer(compute_dtype):
    """K5 for untied buckets; the bias-decay terms are added after the
    kernels, once per member, and the grad norm is left to the step."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_untied_sae_loss_and_grads)

    def producer(params, buffers, batch, total_batch=None, psum=None):
        return (*fused_untied_sae_loss_and_grads(
            params, buffers["l1_alpha"], buffers["bias_decay"], batch,
            total_batch=total_batch, compute_dtype=compute_dtype,
            psum=psum), None)

    return producer


def _untied_tiled_producer(compute_dtype):
    """K7 for untied buckets, with the kernel grad norm (before the bias
    decay and the decoder's normalization VJP)."""
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        fused_untied_sae_tiled_loss_and_grads)

    def producer(params, buffers, batch, total_batch=None, psum=None):
        return fused_untied_sae_tiled_loss_and_grads(
            params, buffers["l1_alpha"], buffers["bias_decay"], batch,
            total_batch=total_batch, compute_dtype=compute_dtype,
            psum=psum)

    return producer


def make_fullfused_tied_step(adam_hypers, compute_dtype="float32",
                             sentinel: bool = True) -> Step:
    """Whole-step path (K2, ``fused_tied_sae_train_step``): grads, the
    normalization VJP and Adam on E and b from the kernels. The update
    delta norm stands in for the grad norm, as in the JAX package."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_tied_sae_train_step)
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        prepare_tiled_batch)

    b1, b2, eps = adam_hypers

    def step(state: EnsembleState, batch: Tensor):
        p, mu, nu = state.params, state.mu, state.nu
        kbatch, bt, _ = prepare_tiled_batch(batch, p["encoder"].shape[1],
                                            None, None, compute_dtype)
        count_inc = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count_inc, b1, b2)
        losses, e2, bias2, mu_e, nu_e, mu_b, nu_b, act = (
            fused_tied_sae_train_step(
                p["encoder"], p["encoder_bias"], mu["encoder"],
                nu["encoder"], mu["encoder_bias"], nu["encoder_bias"],
                state.buffers["l1_alpha"], state.lrs, bc1, bc2, kbatch,
                batch_tile=bt, compute_dtype=compute_dtype,
                b1=b1, b2=b2, eps=eps))
        params = {"encoder": e2, "encoder_bias": bias2}
        un = torch.sqrt(_member_sq_norm(
            {k: params[k] - p[k] for k in params}))
        return _finish(state, params,
                       {"encoder": mu_e, "encoder_bias": mu_b},
                       {"encoder": nu_e, "encoder_bias": nu_b}, count_inc,
                       _fused_aux(losses, act), batch, sentinel, (un,), un)

    return step


def make_fullfused_untied_step(adam_hypers, compute_dtype="float32",
                               sentinel: bool = True,
                               tiled: bool = False) -> Step:
    """Untied whole-step paths: the grads kernels — K5
    (``fused_untied_sae_grads``, path ``train_step``) or, ``tiled``, K7
    (``tiled_untied_sae_grads``, path ``train_step_tiled``) — then K6, the
    Adam/normalization-VJP epilogue on E and D; the bias decay (added
    after the kernels, once per member) and the bias Adam step in torch.
    The update norm √(un_sq + Σ(Δbias)²) comes out of K6's epilogue; it
    stands in for the grad norm on ``train_step``, while
    ``train_step_tiled`` reports the kernel grad norm, as in the JAX
    package."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_adam_vjp_update,
        fused_untied_sae_grads,
        untied_bias_decay_terms,
    )
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        prepare_tiled_batch, tiled_untied_sae_grads)

    b1, b2, eps = adam_hypers

    def step(state: EnsembleState, batch: Tensor):
        p, mu, nu = state.params, state.mu, state.nu
        e, dec, bias = p["encoder"], p["decoder"], p["encoder_bias"]
        alphas = state.buffers["l1_alpha"]
        kbatch, bt, ft = prepare_tiled_batch(batch, e.shape[1], None, None,
                                             compute_dtype)
        count_inc = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count_inc, b1, b2)
        if tiled:
            losses, de, dwn, db, act, grad_sq = tiled_untied_sae_grads(
                e, dec, bias, alphas, kbatch, batch_tile=bt, feat_tile=ft,
                compute_dtype=compute_dtype)
        else:
            losses, de, dwn, db, act = fused_untied_sae_grads(
                e, dec, bias, alphas, kbatch, batch_tile=bt,
                compute_dtype=compute_dtype)
        losses["bias_decay"], db = untied_bias_decay_terms(
            bias, state.buffers["bias_decay"], db)
        e2, mu_e, nu_e, d2, mu_d, nu_d, un_sq = fused_adam_vjp_update(
            e, de, mu["encoder"], nu["encoder"], dec, dwn, mu["decoder"],
            nu["decoder"], state.lrs, bc1, bc2, ftile=_build.FEAT_TILE,
            b1=b1, b2=b2, eps=eps)
        bias2, mu_b, nu_b = _bias_adam_update(
            bias, db, mu["encoder_bias"], nu["encoder_bias"], state.lrs,
            bc1, bc2, b1, b2, eps)
        un = torch.sqrt(un_sq + torch.sum(torch.square(bias2 - bias), dim=-1))
        gn = torch.sqrt(grad_sq) if tiled else un
        return _finish(
            state, {"encoder": e2, "encoder_bias": bias2, "decoder": d2},
            {"encoder": mu_e, "encoder_bias": mu_b, "decoder": mu_d},
            {"encoder": nu_e, "encoder_bias": nu_b, "decoder": nu_d},
            count_inc, _fused_aux(losses, act), batch, sentinel, (gn, un),
            gn)

    return step


def make_fullfused_tiled_step(adam_hypers, compute_dtype="float32",
                              sentinel: bool = True) -> Step:
    """Whole-step tiled path (K3 + K4): the tiled grads kernels, then the
    Adam/normalization-VJP epilogue kernel; the bias steps in torch. Both
    sentinel norms come out of kernel epilogues (+ the [N, n] bias
    delta)."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_tied_adam_vjp_update)
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        prepare_tiled_batch, tiled_tied_sae_grads)

    b1, b2, eps = adam_hypers

    def step(state: EnsembleState, batch: Tensor):
        p, mu, nu = state.params, state.mu, state.nu
        e, bias = p["encoder"], p["encoder_bias"]
        kbatch, bt, ft = prepare_tiled_batch(batch, e.shape[1], None, None,
                                             compute_dtype)
        count_inc = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count_inc, b1, b2)
        losses, dw, db, act, grad_sq = tiled_tied_sae_grads(
            e, bias, state.buffers["l1_alpha"], kbatch, batch_tile=bt,
            feat_tile=ft, compute_dtype=compute_dtype)
        e2, mu_e, nu_e, un_sq = fused_tied_adam_vjp_update(
            e, dw, mu["encoder"], nu["encoder"], state.lrs, bc1, bc2,
            ftile=_build.FEAT_TILE, b1=b1, b2=b2, eps=eps)
        bias2, mu_b, nu_b = _bias_adam_update(
            bias, db, mu["encoder_bias"], nu["encoder_bias"], state.lrs,
            bc1, bc2, b1, b2, eps)
        gn = torch.sqrt(grad_sq)
        un = torch.sqrt(un_sq + torch.sum(torch.square(bias2 - bias), dim=-1))
        return _finish(state, {"encoder": e2, "encoder_bias": bias2},
                       {"encoder": mu_e, "encoder_bias": mu_b},
                       {"encoder": nu_e, "encoder_bias": nu_b}, count_inc,
                       _fused_aux(losses, act), batch, sentinel, (gn, un),
                       gn)

    return step


def make_fullfused_step_sharded(family: str, adam_hypers, mesh,
                                tiled: bool = False,
                                compute_dtype: str = "float32",
                                sentinel: bool = True) -> Step:
    """The mesh whole-step paths: the grads kernels on this rank's rows
    with the global batch as their normalizer — K1 or K3 (``tiled``) for
    a tied bucket, K5 or K7 for an untied one —, ONE all-reduce over
    "data" of the partial losses and grads, the untied bias decay once a
    member after it, then the Adam/normalization-VJP epilogue (K4, K6) on
    the member shard and the bias step in torch. The update norm from the
    epilogue (+ the [N, n] bias delta) stands in for the grad norm: the
    kernel grad norm is a per-shard partial. The summed grads are the same
    on every data shard, so the sentinel's verdict is too."""
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_adam_vjp_update,
        fused_tied_adam_vjp_update,
        fused_tied_sae_grads,
        fused_untied_sae_grads,
        untied_bias_decay_terms,
    )
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        prepare_tiled_batch,
        sum_partials,
        tiled_tied_sae_grads,
        tiled_untied_sae_grads,
    )

    if family not in ("tied", "untied"):
        raise ValueError(
            f"no sharded whole-step path for family {family!r} (the masked "
            "family's coef_mask rides the two-stage kernels only)")
    b1, b2, eps = adam_hypers
    tied = family == "tied"
    psum = _data_psum(mesh)

    def step(state: EnsembleState, batch: Tensor):
        p, mu, nu = state.params, state.mu, state.nu
        e, bias = p["encoder"], p["encoder_bias"]
        alphas = state.buffers["l1_alpha"]
        total = batch.shape[0] * mesh.shape[DATA_AXIS]
        kbatch, bt, ft = prepare_tiled_batch(batch, e.shape[1], None, None,
                                             compute_dtype)
        kw = {"batch_tile": bt, "total_batch": total,
              "compute_dtype": compute_dtype}
        if tiled:
            kw["feat_tile"] = ft
        if tied:
            grads_fn = tiled_tied_sae_grads if tiled else fused_tied_sae_grads
            losses, dw, db, act = grads_fn(e, bias, alphas, kbatch, **kw)[:4]
            losses, dw, db, act = sum_partials(psum, losses, dw, db, act)
        else:
            dec = p["decoder"]
            grads_fn = (tiled_untied_sae_grads if tiled
                        else fused_untied_sae_grads)
            losses, de, dwn, db, act = grads_fn(e, dec, bias, alphas, kbatch,
                                                **kw)[:5]
            losses, de, dwn, db, act = sum_partials(psum, losses, de, dwn,
                                                    db, act)
            losses["bias_decay"], db = untied_bias_decay_terms(
                bias, state.buffers["bias_decay"], db)
        count_inc = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count_inc, b1, b2)
        if tied:
            e2, mu_e, nu_e, un_sq = fused_tied_adam_vjp_update(
                e, dw, mu["encoder"], nu["encoder"], state.lrs, bc1, bc2,
                ftile=_build.FEAT_TILE, b1=b1, b2=b2, eps=eps)
            params, new_mu, new_nu = ({"encoder": e2}, {"encoder": mu_e},
                                      {"encoder": nu_e})
        else:
            e2, mu_e, nu_e, d2, mu_d, nu_d, un_sq = fused_adam_vjp_update(
                e, de, mu["encoder"], nu["encoder"], dec, dwn, mu["decoder"],
                nu["decoder"], state.lrs, bc1, bc2, ftile=_build.FEAT_TILE,
                b1=b1, b2=b2, eps=eps)
            params = {"encoder": e2, "decoder": d2}
            new_mu = {"encoder": mu_e, "decoder": mu_d}
            new_nu = {"encoder": nu_e, "decoder": nu_d}
        bias2, mu_b, nu_b = _bias_adam_update(
            bias, db, mu["encoder_bias"], nu["encoder_bias"], state.lrs,
            bc1, bc2, b1, b2, eps)
        params["encoder_bias"] = bias2
        new_mu["encoder_bias"], new_nu["encoder_bias"] = mu_b, nu_b
        un = torch.sqrt(un_sq + torch.sum(torch.square(bias2 - bias), dim=-1))
        order = list(p)  # the state's key order
        return _finish(state, {k: params[k] for k in order},
                       {k: new_mu[k] for k in order},
                       {k: new_nu[k] for k in order}, count_inc,
                       _fused_aux(losses, act), batch, sentinel, (un,), un)

    return step


# Signatures whose loss is a mean over the batch rows plus terms that do
# not depend on the batch, so a data-sharded autodiff step may weight each
# rank's loss by its share of the rows and sum: every signature of the zoo.
ROW_SEPARABLE_SIGNATURES = frozenset({
    "sae", "tied_sae", "masked_tied_sae", "tied_centered_sae",
    "thresholding_sae", "masked_sae", "reverse_sae", "positive_tied_sae",
    "semilinear_sae", "topk", "lista_denoising_sae",
    "residual_denoising_sae", "rica",
})


def shard_ensemble_state(state: EnsembleState, mesh) -> EnsembleState:
    """This rank's member shard of a full stacked state
    (``partition.ENSEMBLE_STATE_RULES``: the member axis over "model",
    scalars replicated), through the ``partition.place`` seam."""
    n_model = mesh.shape[MODEL_AXIS]
    if state.n_members % n_model != 0:
        raise ValueError(
            f"ensemble size {state.n_members} not divisible by mesh model "
            f"axis {n_model}; pad the sweep grid or choose a dividing "
            "mesh_model")
    return partition.place_tree(state, mesh, partition.ENSEMBLE_STATE_RULES)


def _gather_members(mesh, tensors: list) -> list:
    """Each [N_local, ...] tensor gathered over "model" to [N, ...], the
    tensors of one dtype in one all-gather (bools travel as int32)."""
    out: list = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for dtype, idx in groups.items():
        wire = torch.int32 if dtype == torch.bool else dtype
        flat = [tensors[i].reshape(tensors[i].shape[0], -1).to(wire)
                for i in idx]
        full = mesh.all_gather(torch.cat(flat, dim=1), MODEL_AXIS, dim=0)
        col = 0
        for i, f in zip(idx, flat):
            part = full[:, col:col + f.shape[1]]
            out[i] = part.reshape((full.shape[0],)
                                  + tuple(tensors[i].shape[1:])).to(dtype)
            col += f.shape[1]
    return out


def gather_aux(aux: AuxData, mesh) -> AuxData:
    """A step's per-member aux from every model shard (and the
    inputs-finite flag AND-ed over "data"): what a single-device step
    returns."""
    names = [f.name for f in dataclasses.fields(AuxData)
             if f.name not in ("losses", "inputs_finite")
             and getattr(aux, f.name) is not None]
    keys = list(aux.losses)
    full = _gather_members(mesh, [aux.losses[k] for k in keys]
                           + [getattr(aux, n) for n in names])
    fields = dict(zip(names, full[len(keys):]))
    if aux.inputs_finite is not None:
        fields["inputs_finite"] = mesh.all_true(aux.inputs_finite, DATA_AXIS)
    return aux.replace(losses=dict(zip(keys, full[:len(keys)])), **fields)


def can_use_fused_tied_step(sig: Any, members) -> bool:
    """Kernel-path preconditions of the tied kernels: a plain tied SAE
    with exactly the {encoder, encoder_bias} params, identity centering
    and zero bias decay on every member; or a masked-tied SAE with its
    coef_mask (its loss has no centering or bias-decay term to gate on)."""
    name = getattr(sig, "signature_name", None)
    if name not in ("tied_sae", "masked_tied_sae"):
        return False
    params0, buffers0 = members[0]
    if set(params0) != {"encoder", "encoder_bias"}:
        return False
    if name == "masked_tied_sae":
        return "coef_mask" in buffers0
    d = _host(params0["encoder"]).shape[1]
    for _, b in members:
        if float(np.max(np.abs(_host(b.get("bias_decay", 0.0))))) != 0.0:
            return False
        if not (np.allclose(_host(b["center_rot"]), np.eye(d))
                and np.allclose(_host(b["center_trans"]), 0.0)
                and np.allclose(_host(b["center_scale"]), 1.0)):
            return False
    return True


def can_use_fused_untied_step(sig: Any, members) -> bool:
    """Kernel-path preconditions of the untied kernels: the plain "sae"
    signature with exactly the params the kernels compute grads for and
    the l1_alpha and bias_decay buffers. bias_decay needs no value gate:
    its term lives outside the kernels."""
    if getattr(sig, "signature_name", None) != "sae":
        return False
    params0, buffers0 = members[0]
    return (set(params0) == {"encoder", "encoder_bias", "decoder"}
            and {"l1_alpha", "bias_decay"} <= set(buffers0))


def _host(v) -> np.ndarray:
    """A member leaf as a host numpy array, wherever it lives."""
    if isinstance(v, Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _as_tensor(v, device) -> Tensor:
    if isinstance(v, Tensor):
        return v.detach().to(device)
    return torch.as_tensor(np.asarray(v), device=device)


class Ensemble:
    """One bucket of N same-shape members trained on a shared batch.

    ``members`` are ``(params, buffers)`` pairs from ``sig.init`` (tensors
    or numpy arrays). ``device=None`` means ``cuda`` and raises without a
    card; tests pass ``device="cpu"``, where every kernel wrapper runs its
    plain version. A bucket is eligible for the kernels as one of three
    families — tied, untied or masked-tied — and otherwise trains on
    autodiff. ``fused_path`` pins one of the family's ``KERNEL_PATHS``;
    left None, a tied or untied bucket runs ``train_step_tiled`` and a
    masked one ``two_stage_tiled``. On the card an eligible bucket whose
    shape the kernels do not take raises; it trains on autodiff only with
    ``use_fused=False``. ``fused_compute_dtype="bfloat16"`` runs the
    kernels' bf16 forms (bf16 dot operands, fp32 accumulation; the
    autodiff path stays fp32); ``fused_moments_dtype="bfloat16"`` (with a
    whole-step ``fused_path``) stores the encoder and decoder Adam moments
    in bf16, as the JAX engine does."""

    def __init__(
        self,
        members: Sequence[tuple[dict, dict]],
        sig: Any,
        lr: float | Sequence[float] = 1e-3,
        adam_b1: float = 0.9,
        adam_b2: float = 0.999,
        adam_eps: float = 1e-8,
        use_fused: str | bool = "auto",
        fused_compute_dtype: str = "float32",
        fused_path: Optional[str] = None,
        fused_moments_dtype: str = "float32",
        sentinel: bool = True,
        device=None,
        mesh=None,
    ):
        if fused_path not in (None, *KERNEL_PATHS):
            raise ValueError(f"fused_path must be None or one of "
                             f"{KERNEL_PATHS}, got {fused_path!r}")
        if fused_moments_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"fused_moments_dtype must be 'float32' or 'bfloat16', got "
                f"{fused_moments_dtype!r}")
        if (fused_moments_dtype != "float32"
                and fused_path not in ("train_step", "train_step_tiled")):
            raise ValueError(
                "fused_moments_dtype='bfloat16' requires "
                "fused_path='train_step' or 'train_step_tiled': only the "
                "whole-step kernels carry "
                "moments through VMEM (the win is their halved HBM traffic),"
                " and an auto-mode path flip would silently change the "
                "optimizer-state dtype mid-run. It is an opt-in DEVIATION "
                "from exact optax/torchopt parity (~8-bit moment mantissas; "
                "update math stays f32).")
        if fused_compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"fused_compute_dtype={fused_compute_dtype!r}: the kernels "
                "take 'float32' or 'bfloat16'")
        if fused_path is not None and use_fused is False:
            raise ValueError("fused_path requires use_fused=True or 'auto'")
        if not members:
            raise ValueError("ensemble needs at least one member")
        if mesh is not None and device is not None and (
                torch.device(device) != mesh.device):
            raise ValueError(f"device={device!r} differs from the mesh's "
                             f"device {mesh.device}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.sig = sig
        self.sig_name = getattr(sig, "signature_name", sig.__name__)
        self._adam_hypers = (adam_b1, adam_b2, adam_eps)
        self.sentinel = bool(sentinel)

        split = [split_buffers(b) for _, b in members]
        statics0 = split[0][1]
        if any(statics != statics0 for _, statics in split[1:]):
            raise ValueError("members with differing static buffers cannot "
                             "share a bucket")
        # on a mesh the full state is stacked on the host and each rank
        # keeps its member shard (shard_ensemble_state)
        dev = self.device if mesh is None else torch.device("cpu")
        flat = [flatten_tree(p) for p, _ in members]
        params = {k: torch.stack([_as_tensor(p[k], dev) for p in flat])
                  for k in flat[0]}
        buffers = {k: torch.stack([_as_tensor(a[k], dev) for a, _ in split])
                   for k in split[0][0]}
        n = len(members)
        lrs = (torch.full((n,), float(lr), dtype=torch.float32, device=dev)
               if isinstance(lr, (int, float))
               else torch.as_tensor(np.asarray(lr, np.float32), device=dev))
        if tuple(lrs.shape) != (n,):
            raise ValueError(f"lr must be scalar or length-{n}, got shape "
                             f"{tuple(lrs.shape)}")
        # fused_moments_dtype="bfloat16": half-width storage for the
        # dictionary-weight moment leaves only, selected BY NAME (encoder
        # and decoder, as the JAX engine selects them); bias moments stay
        # fp32. The whole-step kernels read them widened and store them
        # rounded (ops/fused_sae.py).
        moment = lambda k, v: torch.zeros_like(
            v, dtype=torch.bfloat16 if fused_moments_dtype == "bfloat16"
            and k in ("encoder", "decoder") else v.dtype)
        self.state = EnsembleState(
            params=params, buffers=buffers,
            mu={k: moment(k, v) for k, v in params.items()},
            nu={k: moment(k, v) for k, v in params.items()},
            count=torch.zeros((n,), dtype=torch.int32, device=dev),
            lrs=lrs, step=torch.zeros((), dtype=torch.int32, device=dev),
            live=torch.ones((n,), dtype=torch.bool, device=dev),
            static_buffers=statics0, sig_name=self.sig_name)
        self._n_members = n
        if mesh is not None:
            self.state = shard_ensemble_state(self.state, mesh)

        self._standard_step = make_train_step(sig, self._adam_hypers,
                                              statics0, self.sentinel,
                                              mesh=mesh)
        family = None
        if use_fused is not False:
            if can_use_fused_tied_step(sig, members):
                family = ("masked_tied" if self.sig_name == "masked_tied_sae"
                          else "tied")
            elif can_use_fused_untied_step(sig, members):
                family = "untied"
        if use_fused is True and family is None:
            raise ValueError("use_fused=True requires an identity-centered "
                             "tied_sae bucket with zero bias_decay, a "
                             "masked_tied_sae bucket or a plain sae bucket")
        if fused_path is not None:
            if family is None:
                raise ValueError(f"fused_path={fused_path!r} but no kernel "
                                 "path is eligible for this bucket")
            roofline.check_path(family, fused_path)
        self._fused_family = family
        self._fused_disabled = use_fused is False
        self._fused_explicit = use_fused is True
        self._forced_fused_path = fused_path
        self._compute_dtype = fused_compute_dtype
        self.fused_path: Optional[str] = None
        # {(path label, reason): count} — every resolution is a counted
        # event, so a run that quietly fell back to autodiff shows it
        self.path_resolved: dict[tuple[str, str], int] = {}
        self._steps: dict = {}
        self._step_fn: Step = self._standard_step
        self._resolved_batch: Optional[int] = None

    @property
    def n_members(self) -> int:
        """The bucket's member count (every shard's, on a mesh)."""
        return self._n_members

    def local_index(self, index: int) -> Optional[int]:
        """Member ``index``'s position in this rank's state, or None when
        another model shard holds it (every member is local off a
        mesh)."""
        if self.mesh is None:
            return int(index)
        n_local = self.state.n_members
        lo = self.mesh.coords[MODEL_AXIS] * n_local
        return int(index) - lo if lo <= int(index) < lo + n_local else None

    def freeze_members(self, indices: Sequence[int]) -> None:
        """Clear live-mask bits (global member indices): a frozen member's
        params and optimizer state pass through every later step
        unchanged. On a mesh each rank clears the bits of the members it
        holds."""
        idx = [j for j in (self.local_index(i) for i in indices)
               if j is not None]
        if idx:
            live = self.state.live.clone()
            live[idx] = False
            self.state = self.state.replace(live=live)

    def live_mask(self) -> np.ndarray:
        """The [N] live mask (gathered over "model" on a mesh: every rank
        calls it)."""
        live = self.state.live
        if self.mesh is not None:
            live = _gather_members(self.mesh, [live])[0]
        return live.cpu().numpy()

    def full_state(self) -> EnsembleState:
        """The whole bucket's state: this rank's own off a mesh, the
        member shards gathered over "model" on one (a collective)."""
        if self.mesh is None:
            return self.state
        return partition.gather_tree(self.state, self.mesh,
                                     partition.ENSEMBLE_STATE_RULES)

    def _step_for_path(self, path: str) -> Step:
        fn = self._steps.get(path)
        if fn is None:
            h, cd, s = self._adam_hypers, self._compute_dtype, self.sentinel
            untied = self._fused_family == "untied"
            mesh = self.mesh
            if path == "two_stage":
                fn = make_fused_step((_untied_producer if untied
                                      else _tied_producer)(cd), h, s, mesh)
            elif path == "two_stage_tiled":
                fn = make_fused_step((_untied_tiled_producer if untied
                                      else _tied_tiled_producer)(cd), h, s,
                                     mesh)
            elif mesh is not None:
                fn = make_fullfused_step_sharded(
                    self._fused_family, h, mesh,
                    tiled=path == "train_step_tiled", compute_dtype=cd,
                    sentinel=s)
            elif untied:
                fn = make_fullfused_untied_step(
                    h, cd, s, tiled=path == "train_step_tiled")
            elif path == "train_step":
                fn = make_fullfused_tied_step(h, cd, s)
            else:
                fn = make_fullfused_tiled_step(h, cd, s)
            self._steps[path] = fn
        return fn

    def _resolve_step(self, batch_size: int) -> None:
        """Pick the program for this batch size (re-resolved only when the
        size changes) and count the resolution. An eligible bucket whose
        shape the kernels do not take trains on autodiff only on the CPU;
        on the card, or with a forced path, it raises."""
        if batch_size == self._resolved_batch:
            return
        if self._fused_family is None:
            n_feats = d = 0  # no kernel shape, maybe no encoder
        else:
            _, n_feats, d = (int(n) for n in
                             self.state.params["encoder"].shape)
        plan = roofline.choose_plan(
            batch=batch_size, n_feats=n_feats, d=d,
            family=self._fused_family, forced_path=self._forced_fused_path)
        if plan.path is None and self._fused_family is not None and (
                self._forced_fused_path or self._fused_explicit
                or self.device.type == "cuda"):
            raise ValueError(
                f"the kernels do not take batch={batch_size}, "
                f"n_feats={n_feats}, d={d} ({plan.reason}): they take "
                f"{_build.kernel_shapes(self._compute_dtype)}; "
                "pass use_fused=False to train this bucket on autodiff")
        if (plan.path is None and self.mesh is not None
                and self.mesh.shape[DATA_AXIS] > 1
                and self.sig_name not in ROW_SEPARABLE_SIGNATURES):
            raise ValueError(
                f"signature {self.sig_name!r} is not known to be a mean over "
                "the batch rows, so its autodiff step cannot split the batch "
                "over a data axis of "
                f"{self.mesh.shape[DATA_AXIS]}; use mesh_data=1")
        self._step_fn = (self._standard_step if plan.path is None
                         else self._step_for_path(plan.path))
        self.fused_path = plan.path
        reason = ("fused_disabled" if self._fused_disabled
                  else plan.reason)
        key = (plan.path or "autodiff", reason)
        self.path_resolved[key] = self.path_resolved.get(key, 0) + 1
        # the same count in the obs registry, as the JAX package keeps it:
        # a run report (obs/report.py's kernel paths) shows which path a
        # step child's ensembles ran
        obs.counter("ensemble.path_resolved", path=key[0],
                    reason=reason).inc()
        self._resolved_batch = batch_size

    def step_batch(self, batch) -> AuxData:
        """One training step on a [batch, d] slab shared by every member.
        Returns stacked per-member aux. A half-width batch (bfloat16 from
        the store) is promoted to float32 on the device, as the JAX step
        promotes against its f32 params: only the input's precision
        drops, never the accumulation's. Under bf16 compute on a kernel
        path a bfloat16 batch stays bfloat16: the bf16 kernels take it as
        their dot operand, with no fp32 copy on the card, and its fp32
        value (exact) in the residual. On a mesh every rank passes the
        same global batch (its rows must divide over "data"); the rank
        keeps its rows, the kernel path is resolved for them, and the aux
        comes back whole (every member, every rank)."""
        if self.mesh is not None:
            batch = partition.place_batch(batch, self.mesh)
        batch = _as_tensor(batch, self.device)
        self._resolve_step(int(batch.shape[0]))
        if batch.dtype != torch.float32 and not (
                batch.dtype == torch.bfloat16 and self.fused_path is not None
                and self._compute_dtype == "bfloat16"):
            batch = batch.to(torch.float32)
        self.state, aux = self._step_fn(self.state, batch)
        if self.mesh is not None:
            aux = gather_aux(aux, self.mesh)
        return aux

    def run_steps(self, batches) -> AuxData:
        """K steps over a [K, B, d] stack (a Python loop; CUDA graphs are
        later work). Returns aux stacked on a leading K axis."""
        auxes = [self.step_batch(b) for b in batches]
        stack = lambda vs: None if vs[0] is None else torch.stack(vs)
        return AuxData(
            losses={k: torch.stack([a.losses[k] for a in auxes])
                    for k in auxes[0].losses},
            **{f.name: stack([getattr(a, f.name) for a in auxes])
               for f in dataclasses.fields(AuxData) if f.name != "losses"})

    def step_cost(self, batch_rows: int):
        """The :class:`~sparse_coding_tpu_torch.obs.perf.StepCost` of one
        step at ``batch_rows`` on the resolved path: the model flops of
        the shared FLOP model (``roofline.model_flops_per_activation``,
        required flops, whichever path ran them). The port has no Hopper
        roofline model yet, so no prediction rides along."""
        from sparse_coding_tpu_torch.obs.perf import StepCost

        enc = self.state.params.get("encoder")
        path = self.fused_path or "autodiff"
        if enc is None or enc.dim() != 3:
            return StepCost(path=path, activations=int(batch_rows))
        flops = roofline.model_flops_per_activation(
            self.n_members, int(enc.shape[1]), int(enc.shape[2])) * batch_rows
        return StepCost(flops=flops, path=path, activations=int(batch_rows))

    def unstack(self) -> list[tuple[dict, dict]]:
        """Per-member (params, buffers incl. statics) as CPU tensors, the
        params in the signature's nesting (every member; a collective on a
        mesh)."""
        state = self.full_state()
        params = {k: v.cpu() for k, v in state.params.items()}
        buffers = {k: v.cpu() for k, v in state.buffers.items()}
        return [(unflatten_tree({k: v[i] for k, v in params.items()}),
                 merge_buffers({k: v[i] for k, v in buffers.items()},
                               self.state.static_buffers))
                for i in range(self.n_members)]

    def to_learned_dicts(self) -> list:
        return [self.sig.to_learned_dict(p, b) for p, b in self.unstack()]

    def buckets(self) -> list[tuple[str, "Ensemble"]]:
        """``[(bucket name, Ensemble)]``, as :meth:`EnsembleGroup.buckets`:
        one unnamed bucket, itself (the sweep names it after its
        entry)."""
        return [("", self)]


def bucket_name(sig: Any, statics: StaticBuffers) -> str:
    """The JAX package's bucket name: the signature's name, then each
    static buffer as ``{key}{value}`` (``topk_k4``)."""
    name = getattr(sig, "signature_name", sig.__name__)
    return name + ("_" + "_".join(f"{k}{v}" for k, v in statics)
                   if statics else "")


class EnsembleGroup:
    """Buckets trained together on one data stream. Members are bucketed
    by their static buffers, in order of first appearance; each bucket is
    its own :class:`Ensemble` (TopK members with k = 4, 8, 16 form three),
    and the card queues every bucket's step without waiting."""

    def __init__(self, ensembles: dict[str, Ensemble]):
        self.ensembles = dict(ensembles)

    @classmethod
    def build(cls, sig: Any, member_inits: Sequence[tuple[dict, dict]],
              lr: float = 1e-3, **ensemble_kwargs) -> "EnsembleGroup":
        """Bucket ``member_inits`` by static buffers and build one
        Ensemble per bucket (``ensemble_kwargs`` go to each)."""
        buckets: dict[StaticBuffers, list] = {}
        for member in member_inits:
            buckets.setdefault(split_buffers(member[1])[1], []).append(member)
        return cls({bucket_name(sig, statics): Ensemble(members, sig, lr=lr,
                                                        **ensemble_kwargs)
                    for statics, members in buckets.items()})

    def step_batch(self, batch) -> dict[str, AuxData]:
        return {name: ens.step_batch(batch)
                for name, ens in self.ensembles.items()}

    def run_steps(self, batches) -> dict[str, AuxData]:
        """K steps per bucket over one [K, B, d] stack."""
        return {name: ens.run_steps(batches)
                for name, ens in self.ensembles.items()}

    def step_cost(self, batch_rows: int):
        """The buckets' step costs combined (``obs.combine_costs``)."""
        from sparse_coding_tpu_torch.obs.perf import combine_costs

        return combine_costs([ens.step_cost(batch_rows)
                              for ens in self.ensembles.values()])

    def to_learned_dicts(self) -> dict[str, list]:
        return {name: ens.to_learned_dicts()
                for name, ens in self.ensembles.items()}

    def buckets(self) -> list[tuple[str, Ensemble]]:
        """``[(bucket name, Ensemble)]`` in insertion order."""
        return list(self.ensembles.items())


# what a sweep entry trains: ``buckets()`` walks either kind
EnsembleLike = Ensemble | EnsembleGroup


# --- dead-feature resurrection ------------------------------------------------

# Which top-level params are dictionary rows (refreshed with new
# directions) and which are per-feature scalars (reset), by name, as the
# JAX engine keeps them: a shape rule would mistake a learnable [N, d]
# center for a row parameter at ratio 1.
_RESURRECT_ROW_PARAMS = ("encoder", "decoder", "weights", "enc1_w")
_RESURRECT_SCALAR_DEFAULTS = {
    "encoder_bias": 0.0,
    "enc1_b": 0.0,
    "activation_scale": 1.0,  # the thresholding gate's init
    "activation_gain": 0.0,
}
# signatures whose per-feature scalar init is a nonzero constant
_SIG_SCALAR_OVERRIDES = {
    "positive_tied_sae": {"encoder_bias": -1.0},
}


def resurrect_ensemble_features(
        state: EnsembleState, dead_mask: Tensor,
        generator: torch.Generator, row_params=None,
        scalar_defaults=None) -> EnsembleState:
    """Reinitialize dead features of every member at once: each dead
    dictionary row becomes a fresh random unit direction scaled to its
    member's mean norm over live rows, each per-feature scalar its
    signature's init constant (0 where none is known), and their Adam
    moments zero. Live rows, nested params (LISTA's layers, under
    ``outer/inner`` keys) and params of no per-feature kind stay bitwise
    as they were. ``dead_mask`` is [N, n_feats] bool; ``row_params`` and
    ``scalar_defaults`` extend the built-in contract.

    The fresh directions come from ``generator`` (drawn on its device, one
    draw a row parameter in ``row_params`` order): other numbers than the
    JAX engine's ``jax.random`` key gives, from the same distribution."""
    rows = (tuple(row_params) if row_params is not None
            else _RESURRECT_ROW_PARAMS)
    defaults = dict(_RESURRECT_SCALAR_DEFAULTS)
    defaults.update(_SIG_SCALAR_OVERRIDES.get(state.sig_name, {}))
    if scalar_defaults is not None:
        defaults.update(dict(scalar_defaults))
    params = dict(state.params)
    dead = torch.as_tensor(dead_mask, dtype=torch.bool,
                           device=state.lrs.device)
    live = ~dead
    for name in rows:
        if name not in params:
            continue
        w = params[name]  # [N, n, d]
        fresh = torch.randn(w.shape, generator=generator, dtype=w.dtype,
                            device=generator.device).to(w.device)
        fresh = fresh / torch.linalg.vector_norm(fresh, dim=-1, keepdim=True)
        norms = torch.linalg.vector_norm(w, dim=-1)  # [N, n]
        live_count = torch.clamp(live.sum(dim=-1), min=1)
        scale = (norms * live).sum(dim=-1) / live_count  # [N]
        params[name] = torch.where(dead[..., None],
                                   fresh * scale[:, None, None], w)
    for name, default in defaults.items():
        if name in params:
            params[name] = torch.where(dead, default, params[name])

    def reset(tree: dict) -> dict:
        out = dict(tree)
        for name in rows:
            if name in out:
                out[name] = torch.where(dead[..., None], 0.0, out[name])
        for name in defaults:
            if name in out and name not in rows:
                out[name] = torch.where(dead, 0.0, out[name])
        return out

    return state.replace(params=params, mu=reset(state.mu),
                         nu=reset(state.nu))
