"""The ensemble training engine (the JAX package's ``ensemble.py`` for the
tied family, single device).

One bucket of N same-shape members is stacked along a leading member axis.
A step takes one [B, d] batch shared by every member and runs either

- the autodiff reference path (``make_train_step``: ``torch.func.vmap`` of
  ``grad`` over the members, then Adam), or
- one of the four tied kernel paths, whose labels are the JAX package's
  ``KERNEL_PATHS``: ``two_stage`` (K1 grads, Adam in torch),
  ``train_step`` (K2 whole step), ``two_stage_tiled`` (K3 grads, Adam in
  torch) and ``train_step_tiled`` (K3 grads + K4 Adam/VJP epilogue, the
  default on the card).

Adam is optax's ``scale_by_adam`` with eps_root=0, exactly: per-member
count [N] int32 with a saturating increment, bias corrections
1 − β^count, and the engine's ``−lr·update``. The in-graph anomaly sentinel
rides every path: a member whose loss, grad norm or update norm went
non-finite — or whose ``live`` bit is cleared — keeps its params and
optimizer state unchanged, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.models.signatures import AuxData
from sparse_coding_tpu_torch.ops import roofline
from sparse_coding_tpu_torch.ops.roofline import KERNEL_PATHS

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
    precomputes them for the kernels."""
    c = count_inc.to(torch.float32)
    one = lambda b: torch.tensor(b, dtype=torch.float32, device=c.device)
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
    """AuxData of the fused paths, with the autodiff path's loss keys."""
    return AuxData(
        losses={"loss": losses["mse"] + losses["l1"],
                "l_reconstruction": losses["mse"], "l_l1": losses["l1"]},
        l0=losses["l0"], feat_activity=activity.to(torch.int32))


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


def make_train_step(sig: Any, adam_hypers: tuple[float, float, float],
                    statics: StaticBuffers = (),
                    sentinel: bool = True) -> Step:
    """The autodiff reference step: vmapped grad of ``sig.loss`` over the
    member axis, then Adam. With ``sentinel`` the grad and update norms
    and the finite flags ride the aux."""
    b1, b2, eps = adam_hypers

    def member_loss(p, b, x):
        loss, aux = sig.loss(p, merge_buffers(b, statics), x)
        return loss, (aux.losses, aux.l0, aux.feat_activity)

    grad_fn = torch.func.vmap(
        torch.func.grad_and_value(member_loss, has_aux=True),
        in_dims=(0, 0, None))

    def step(state: EnsembleState, batch: Tensor):
        grads, (_, (losses, l0, act)) = grad_fn(state.params, state.buffers,
                                                batch)
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


def make_fused_step(producer: Callable, adam_hypers, sentinel: bool = True
                    ) -> Step:
    """Two-stage fused step: losses + exact grads from the kernels (via
    ``producer``), the optimizer update in plain torch. A producer that
    returns a kernel grad norm (the tiled one) spares the grad-norm pass."""
    b1, b2, eps = adam_hypers

    def step(state: EnsembleState, batch: Tensor):
        losses, grads, activity, gnorm = producer(state.params,
                                                  state.buffers, batch)
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
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_tied_sae_loss_and_grads)

    def producer(params, buffers, batch):
        return (*fused_tied_sae_loss_and_grads(
            params, buffers["l1_alpha"], batch,
            compute_dtype=compute_dtype), None)

    return producer


def _tied_tiled_producer(compute_dtype):
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        fused_tied_sae_tiled_loss_and_grads)

    def producer(params, buffers, batch):
        return fused_tied_sae_tiled_loss_and_grads(
            params, buffers["l1_alpha"], batch, compute_dtype=compute_dtype)

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
                                            None, None)
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


def make_fullfused_tiled_step(adam_hypers, compute_dtype="float32",
                              sentinel: bool = True) -> Step:
    """Whole-step tiled path (K3 + K4): the tiled grads kernels, then the
    Adam/normalization-VJP epilogue kernel; the bias steps in torch. Both
    sentinel norms come out of kernel epilogues (+ the [N, n] bias
    delta)."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops.fused_sae import (
        fused_tied_adam_vjp_update)
    from sparse_coding_tpu_torch.ops.fused_sae_tiled import (
        prepare_tiled_batch, tiled_tied_sae_grads)

    b1, b2, eps = adam_hypers

    def step(state: EnsembleState, batch: Tensor):
        p, mu, nu = state.params, state.mu, state.nu
        e, bias = p["encoder"], p["encoder_bias"]
        kbatch, bt, ft = prepare_tiled_batch(batch, e.shape[1], None, None)
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


def can_use_fused_tied_step(sig: Any, members) -> bool:
    """Kernel-path preconditions: a plain tied SAE with exactly the
    {encoder, encoder_bias} params, identity centering and zero bias
    decay on every member."""
    if getattr(sig, "signature_name", None) != "tied_sae":
        return False
    params0, _ = members[0]
    if set(params0) != {"encoder", "encoder_bias"}:
        return False
    d = _host(params0["encoder"]).shape[1]
    for _, b in members:
        if float(np.max(np.abs(_host(b.get("bias_decay", 0.0))))) != 0.0:
            return False
        if not (np.allclose(_host(b["center_rot"]), np.eye(d))
                and np.allclose(_host(b["center_trans"]), 0.0)
                and np.allclose(_host(b["center_scale"]), 1.0)):
            return False
    return True


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
    plain version. ``fused_path`` pins one of ``KERNEL_PATHS``; left None,
    an eligible tied bucket runs ``train_step_tiled``. On the card an
    eligible bucket whose shape the kernels do not take raises; it trains
    on autodiff only with ``use_fused=False``."""

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
    ):
        if fused_path not in (None, *KERNEL_PATHS):
            raise ValueError(f"fused_path must be None or one of "
                             f"{KERNEL_PATHS}, got {fused_path!r}")
        if fused_compute_dtype != "float32":
            raise NotImplementedError(
                f"fused_compute_dtype={fused_compute_dtype!r}: only float32 "
                "is ported")
        if fused_moments_dtype != "float32":
            raise NotImplementedError(
                f"fused_moments_dtype={fused_moments_dtype!r}: only float32 "
                "is ported")
        if fused_path is not None and use_fused is False:
            raise ValueError("fused_path requires use_fused=True or 'auto'")
        if not members:
            raise ValueError("ensemble needs at least one member")
        self.device = resolve_device(device)
        self.sig = sig
        self.sig_name = getattr(sig, "signature_name", sig.__name__)
        self._adam_hypers = (adam_b1, adam_b2, adam_eps)
        self.sentinel = bool(sentinel)

        split = [split_buffers(b) for _, b in members]
        statics0 = split[0][1]
        if any(statics != statics0 for _, statics in split[1:]):
            raise ValueError("members with differing static buffers cannot "
                             "share a bucket")
        dev = self.device
        params = {k: torch.stack([_as_tensor(p[k], dev) for p, _ in members])
                  for k in members[0][0]}
        buffers = {k: torch.stack([_as_tensor(a[k], dev) for a, _ in split])
                   for k in split[0][0]}
        n = len(members)
        lrs = (torch.full((n,), float(lr), dtype=torch.float32, device=dev)
               if isinstance(lr, (int, float))
               else torch.as_tensor(np.asarray(lr, np.float32), device=dev))
        if tuple(lrs.shape) != (n,):
            raise ValueError(f"lr must be scalar or length-{n}, got shape "
                             f"{tuple(lrs.shape)}")
        self.state = EnsembleState(
            params=params, buffers=buffers,
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            count=torch.zeros((n,), dtype=torch.int32, device=dev),
            lrs=lrs, step=torch.zeros((), dtype=torch.int32, device=dev),
            live=torch.ones((n,), dtype=torch.bool, device=dev),
            static_buffers=statics0, sig_name=self.sig_name)

        self._standard_step = make_train_step(sig, self._adam_hypers,
                                              statics0, self.sentinel)
        eligible = (use_fused is not False
                    and can_use_fused_tied_step(sig, members))
        if use_fused is True and not eligible:
            raise ValueError("use_fused=True requires an identity-centered "
                             "tied_sae bucket with zero bias_decay")
        if fused_path is not None and not eligible:
            raise ValueError(f"fused_path={fused_path!r} but no kernel path "
                             "is eligible for this bucket")
        self._fused_family = "tied" if eligible else None
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
        return self.state.n_members

    def freeze_members(self, indices: Sequence[int]) -> None:
        """Clear live-mask bits: a frozen member's params and optimizer
        state pass through every later step unchanged."""
        idx = [int(i) for i in indices]
        if idx:
            live = self.state.live.clone()
            live[idx] = False
            self.state = self.state.replace(live=live)

    def live_mask(self) -> np.ndarray:
        return self.state.live.cpu().numpy()

    def _step_for_path(self, path: str) -> Step:
        fn = self._steps.get(path)
        if fn is None:
            h, cd, s = self._adam_hypers, self._compute_dtype, self.sentinel
            if path == "two_stage":
                fn = make_fused_step(_tied_producer(cd), h, s)
            elif path == "two_stage_tiled":
                fn = make_fused_step(_tied_tiled_producer(cd), h, s)
            elif path == "train_step":
                fn = make_fullfused_tied_step(h, cd, s)
            else:
                fn = make_fullfused_tiled_step(h, cd, s)
            self._steps[path] = fn
        return fn

    def _resolve_step(self, batch_size: int) -> None:
        """Pick the program for this batch size (re-resolved only when the
        size changes) and count the resolution. An eligible tied bucket
        whose shape the kernels do not take trains on autodiff only on
        the CPU; on the card, or with a forced path, it raises."""
        if batch_size == self._resolved_batch:
            return
        enc = self.state.params.get("encoder")
        plan = roofline.choose_plan(
            batch=batch_size, n_feats=int(enc.shape[1]),
            d=int(enc.shape[2]), family=self._fused_family,
            forced_path=self._forced_fused_path)
        if plan.path is None and self._fused_family == "tied" and (
                self._forced_fused_path or self._fused_explicit
                or self.device.type == "cuda"):
            raise ValueError(
                f"the kernels do not take batch={batch_size}, "
                f"n_feats={enc.shape[1]}, d={enc.shape[2]} ({plan.reason}); "
                "pass use_fused=False to train this bucket on autodiff")
        self._step_fn = (self._standard_step if plan.path is None
                         else self._step_for_path(plan.path))
        self.fused_path = plan.path
        reason = ("fused_disabled" if self._fused_disabled
                  else plan.reason)
        key = (plan.path or "autodiff", reason)
        self.path_resolved[key] = self.path_resolved.get(key, 0) + 1
        self._resolved_batch = batch_size

    def step_batch(self, batch) -> AuxData:
        """One training step on a [batch, d] slab shared by every member.
        Returns stacked per-member aux."""
        batch = _as_tensor(batch, self.device)
        self._resolve_step(int(batch.shape[0]))
        self.state, aux = self._step_fn(self.state, batch)
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

    def unstack(self) -> list[tuple[dict, dict]]:
        """Per-member (params, buffers incl. statics) as CPU tensors."""
        params = {k: v.cpu() for k, v in self.state.params.items()}
        buffers = {k: v.cpu() for k, v in self.state.buffers.items()}
        return [({k: v[i] for k, v in params.items()},
                 merge_buffers({k: v[i] for k, v in buffers.items()},
                               self.state.static_buffers))
                for i in range(self.n_members)]

    def to_learned_dicts(self) -> list:
        return [self.sig.to_learned_dict(p, b) for p, b in self.unstack()]
