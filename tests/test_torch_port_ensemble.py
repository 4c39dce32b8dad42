"""The port's ensemble engine (sparse_coding_tpu_torch/ensemble.py) against
the JAX package's Ensemble, step for step.

Both sides start from the same state — the JAX Ensemble's, carried across
with utils/carry.state_from_numpy after two warm-up steps, so the Adam
moments and counts are not zero — and get the same numpy batches. The JAX
side runs its Pallas kernels in interpret mode; the port runs on the CPU,
where every kernel wrapper takes its plain PyTorch version.

Tolerances: per-step losses rtol 1e-5 (the same f32 loss formulas summed
in another order); params, moments and grad norms after 20 steps rtol 2e-4
with atol 1e-6 (params) / 1e-9 (moments) — the JAX package's own
fused-vs-autodiff bound, which also absorbs the few ulps by which two
Adam trajectories drift apart over 20 steps; activity and l0 exact (no
pre-activation lies within rounding of 0 at these shapes); the sentinel's
freeze is bitwise on both sides.
"""

import jax
import numpy as np
import pytest
import torch

from sparse_coding_tpu.ensemble import Ensemble as JaxEnsemble
from sparse_coding_tpu.ensemble import can_use_fused_tied_step as jax_eligible
from sparse_coding_tpu.models.sae import FunctionalSAE as JaxSAE
from sparse_coding_tpu.models.sae import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding_tpu_torch.ensemble import (
    Ensemble,
    can_use_fused_tied_step,
    safe_increment,
)
from sparse_coding_tpu_torch.models.sae import FunctionalSAE, FunctionalTiedSAE
from sparse_coding_tpu_torch.utils.carry import (
    members_from_numpy,
    state_from_numpy,
)
from torch_port_helpers import (
    BATCH_TILE,
    D,
    FEAT_TILE,
    L1S,
    N_FEATS,
    N_MEMBERS,
    batches,
)

LRS = [1e-3, 2e-3, 3e-3]
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
MOMENT_TOL = dict(rtol=2e-4, atol=1e-9)
N_STEPS = 20

PATHS = [None, "two_stage", "train_step", "two_stage_tiled",
         "train_step_tiled"]


def _jax_members(sig=JaxTiedSAE, seed=0, **kw):
    keys = jax.random.split(jax.random.PRNGKey(seed), N_MEMBERS)
    return [sig.init(k, D, N_FEATS, l1_alpha=l1, **kw)
            for k, l1 in zip(keys, L1S)]


def _pair(path, sig=JaxTiedSAE, port_sig=FunctionalTiedSAE, **init_kw):
    """A JAX Ensemble on ``path`` (None = autodiff) and the port's twin,
    built from the same members. Only the JAX side takes tiles: the
    port's kernels block at their own fixed tiles."""
    jmembers = _jax_members(sig, **init_kw)
    fused = {} if path is None else dict(fused_path=path)
    tiles = {} if path is None else dict(fused_batch_tile=BATCH_TILE)
    if path in ("two_stage_tiled", "train_step_tiled"):
        tiles["fused_feat_tile"] = FEAT_TILE
    jens = JaxEnsemble(jmembers, sig, lr=LRS, donate=False,
                       use_fused=path is not None, fused_interpret=True,
                       **fused, **tiles)
    tens = Ensemble(members_from_numpy(jax.device_get(jmembers)), port_sig,
                    lr=LRS, device="cpu", use_fused=path is not None,
                    **fused)
    return jens, tens


def _carry(jens, tens):
    """The JAX Ensemble's whole state → the port's."""
    s = jax.device_get(jens.state)
    tens.state = state_from_numpy(
        params=s.params, buffers=s.buffers, mu=s.opt_state.mu,
        nu=s.opt_state.nu, count=s.opt_state.count, lrs=s.lrs, live=s.live,
        step=s.step, static_buffers=s.static_buffers, sig_name=s.sig_name)


def _assert_states_close(jens, tens, what):
    s = jax.device_get(jens.state)
    t = tens.state
    for k in s.params:
        np.testing.assert_allclose(t.params[k].numpy(), s.params[k],
                                   **PARAM_TOL, err_msg=f"{what}: {k}")
        np.testing.assert_allclose(t.mu[k].numpy(), s.opt_state.mu[k],
                                   **MOMENT_TOL, err_msg=f"{what}: mu {k}")
        np.testing.assert_allclose(t.nu[k].numpy(), s.opt_state.nu[k],
                                   **MOMENT_TOL, err_msg=f"{what}: nu {k}")
    np.testing.assert_array_equal(t.count.numpy(), s.opt_state.count)
    np.testing.assert_array_equal(t.live.numpy(), s.live)
    assert int(t.step) == int(s.step)


def _assert_aux_close(ja, ta, what):
    for k in ja.losses:
        np.testing.assert_allclose(ta.losses[k].numpy(), ja.losses[k],
                                   **LOSS_TOL, err_msg=f"{what}: {k}")
    np.testing.assert_allclose(ta.l0.numpy(), ja.l0, **LOSS_TOL,
                               err_msg=f"{what}: l0")
    np.testing.assert_array_equal(ta.feat_activity.numpy(),
                                  np.asarray(ja.feat_activity))
    assert ta.feat_activity.dtype == torch.int32
    np.testing.assert_array_equal(ta.finite.numpy(), np.asarray(ja.finite))
    assert bool(ta.inputs_finite) == bool(ja.inputs_finite)
    np.testing.assert_allclose(ta.grad_norm.numpy(), ja.grad_norm,
                               **PARAM_TOL, err_msg=f"{what}: grad_norm")


@pytest.mark.parametrize("path", PATHS, ids=lambda p: p or "autodiff")
def test_trajectory_and_sentinel_match_jax(path):
    """20 steps on each of the four kernel paths and on autodiff track the
    JAX Ensemble; then a NaN l1 coefficient makes member 1's step
    non-finite and the quarantine bit freezes member 2 — both sides freeze
    exactly those members, bit for bit, and keep training the rest."""
    jens, tens = _pair(path)
    data = batches(seed=1, n=N_STEPS + 6)
    for b in data[:2]:
        jens.step_batch(jax.numpy.asarray(b))
    _carry(jens, tens)
    for i, b in enumerate(data[2:2 + N_STEPS]):
        ja = jens.step_batch(jax.numpy.asarray(b))
        ta = tens.step_batch(torch.from_numpy(b))
        _assert_aux_close(ja, ta, f"step {i}")
    assert tens.fused_path == jens.fused_path == path
    _assert_states_close(jens, tens, f"after {N_STEPS} steps")

    # sentinel: member 1's loss goes NaN; the guardian freezes member 2
    alphas = np.array(jax.device_get(jens.state.buffers["l1_alpha"]))
    alphas[1] = np.nan
    jens.state = jens.state.replace(
        buffers={**jens.state.buffers, "l1_alpha": jax.numpy.asarray(alphas)})
    tens.state = tens.state.replace(
        buffers={**tens.state.buffers, "l1_alpha": torch.from_numpy(alphas)})
    jens.freeze_members([2])
    tens.freeze_members([2])
    before = {k: v.clone() for k, v in tens.state.params.items()}
    mu_before = {k: v.clone() for k, v in tens.state.mu.items()}
    count_before = tens.state.count.clone()
    for b in data[2 + N_STEPS:]:
        ja = jens.step_batch(jax.numpy.asarray(b))
        ta = tens.step_batch(torch.from_numpy(b))
    np.testing.assert_array_equal(ta.finite.numpy(), [True, False, True])
    np.testing.assert_array_equal(np.asarray(ja.finite), [True, False, True])
    np.testing.assert_array_equal(tens.live_mask(), jens.live_mask())
    for k, v in tens.state.params.items():
        for m in (1, 2):  # frozen: params and moments untouched, bitwise
            assert torch.equal(v[m], before[k][m]), (k, m)
            assert torch.equal(tens.state.mu[k][m], mu_before[k][m])
        assert not torch.equal(v[0], before[k][0])
    np.testing.assert_array_equal(tens.state.count.numpy()[1:],
                                  count_before.numpy()[1:])
    _assert_states_close(jens, tens, "after the sentinel steps")


def test_untied_autodiff_trajectory_matches_jax():
    """The autodiff reference path is signature-generic: the untied SAE
    (with a bias decay) tracks the JAX autodiff path too."""
    jens, tens = _pair(None, sig=JaxSAE, port_sig=FunctionalSAE,
                       bias_decay=0.01)
    for b in batches(seed=2, n=5):
        ja = jens.step_batch(jax.numpy.asarray(b))
        ta = tens.step_batch(torch.from_numpy(b))
        _assert_aux_close(ja, ta, "untied")
    _assert_states_close(jens, tens, "untied")


def test_no_card_means_the_entry_point_raises():
    """device=None means cuda: without a card the constructor raises and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    members = members_from_numpy(jax.device_get(_jax_members()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ensemble(members, FunctionalTiedSAE)


def test_unported_options_raise():
    members = members_from_numpy(jax.device_get(_jax_members()))
    for kw in (dict(fused_compute_dtype="bfloat16"),
               dict(fused_moments_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            Ensemble(members, FunctionalTiedSAE, device="cpu", **kw)
    with pytest.raises(ValueError, match="fused_path must be"):
        Ensemble(members, FunctionalTiedSAE, device="cpu", fused_path="fast")


@pytest.mark.parametrize("case", ["identity", "bias_decay", "centered"])
def test_kernel_path_eligibility_matches_jax(case):
    """can_use_fused_tied_step: identity centering and zero bias_decay, as
    in the JAX package; an ineligible bucket trains on autodiff (a
    counted resolution) and refuses a forced kernel path."""
    kw = {}
    if case == "bias_decay":
        kw["bias_decay"] = 0.01
    elif case == "centered":
        kw["translation"] = jax.numpy.full((D,), 0.5)
    jmembers = _jax_members(**kw)
    members = members_from_numpy(jax.device_get(jmembers))
    want = jax_eligible(JaxTiedSAE, jmembers, interpret=True)
    assert can_use_fused_tied_step(FunctionalTiedSAE, members) == want
    assert want == (case == "identity")
    ens = Ensemble(members, FunctionalTiedSAE, device="cpu")
    ens.step_batch(torch.from_numpy(batches(seed=3, n=1)[0]))
    assert ens.fused_path == ("train_step_tiled" if want else None)
    if not want:
        assert ens.path_resolved == {("autodiff", "family_ineligible"): 1}
        with pytest.raises(ValueError, match="no kernel path"):
            Ensemble(members, FunctionalTiedSAE, device="cpu",
                     fused_path="two_stage")


def test_path_resolution_is_counted_per_batch_size():
    members = members_from_numpy(jax.device_get(_jax_members()))
    ens = Ensemble(members, FunctionalTiedSAE, device="cpu")
    data = batches(seed=4, n=3)
    ens.step_batch(torch.from_numpy(data[0]))
    ens.step_batch(torch.from_numpy(data[1]))
    ens.step_batch(torch.from_numpy(data[2][:100]))  # no tile divides 100
    assert ens.path_resolved == {("train_step_tiled", "default"): 1,
                                 ("autodiff", "no_admissible_tile"): 1}
    assert ens.fused_path is None
    off = Ensemble(members, FunctionalTiedSAE, device="cpu", use_fused=False)
    off.step_batch(torch.from_numpy(data[0]))
    assert off.path_resolved == {("autodiff", "fused_disabled"): 1}


@pytest.mark.parametrize("d,batch", [(1024, 64), (D, 100)],
                         ids=["d1024", "batch100"])
def test_unfit_shape_raises_on_the_card(d, batch):
    """On the card, an eligible tied bucket whose shape the kernels do not
    take (d above their limit, a batch the 32-row tile does not divide)
    raises instead of training on autodiff; use_fused=False is the way to
    autodiff there. A forced path raises on the CPU too. The card's
    resolution is checked here on a CPU-built bucket whose device is set
    to cuda: resolving a step reads shapes only."""
    g = torch.Generator().manual_seed(0)
    members = [FunctionalTiedSAE.init(g, d, N_FEATS, l1_alpha=l1)
               for l1 in L1S]
    ens = Ensemble(members, FunctionalTiedSAE, device="cpu")
    ens._resolve_step(batch)  # the CPU trains it on autodiff
    assert ens.path_resolved == {("autodiff", "no_admissible_tile"): 1}
    card = Ensemble(members, FunctionalTiedSAE, device="cpu")
    card.device = torch.device("cuda")
    with pytest.raises(ValueError, match="do not take"):
        card._resolve_step(batch)
    forced = Ensemble(members, FunctionalTiedSAE, device="cpu",
                      fused_path="two_stage")
    with pytest.raises(ValueError, match="do not take"):
        forced._resolve_step(batch)
    off = Ensemble(members, FunctionalTiedSAE, device="cpu", use_fused=False)
    off.device = torch.device("cuda")
    off._resolve_step(batch)
    assert off.path_resolved == {("autodiff", "fused_disabled"): 1}


def test_run_steps_equals_a_step_batch_loop():
    members = members_from_numpy(jax.device_get(_jax_members()))
    data = batches(seed=5, n=3)
    a = Ensemble(members, FunctionalTiedSAE, device="cpu")
    b = Ensemble(members, FunctionalTiedSAE, device="cpu")
    aux = a.run_steps(torch.from_numpy(data))
    for x in data:
        last = b.step_batch(torch.from_numpy(x))
    assert aux.losses["loss"].shape == (3, N_MEMBERS)
    assert torch.equal(aux.losses["loss"][-1], last.losses["loss"])
    for k in a.state.params:
        assert torch.equal(a.state.params[k], b.state.params[k])


def test_learned_dicts_match_jax_export():
    jens, tens = _pair("train_step_tiled")
    _carry(jens, tens)
    for (jd, td) in zip(jens.to_learned_dicts(), tens.to_learned_dicts()):
        assert type(jd).__name__ == type(td).__name__ == "TiedSAE"
        for f in ("dictionary", "encoder_bias", "centering_rot",
                  "centering_trans", "centering_scale"):
            np.testing.assert_array_equal(getattr(td, f).numpy(),
                                          np.asarray(getattr(jd, f)))
        x = batches(seed=6, n=1)[0]
        np.testing.assert_allclose(td.predict(torch.from_numpy(x)).numpy(),
                                   np.asarray(jd.predict(x)), rtol=1e-5,
                                   atol=1e-6)


def test_safe_increment_saturates_like_optax():
    from sparse_coding_tpu.ensemble import _safe_increment

    c = np.array([0, 5, 2**31 - 2, 2**31 - 1], np.int32)
    np.testing.assert_array_equal(
        safe_increment(torch.from_numpy(c)).numpy(),
        np.asarray(_safe_increment(jax.numpy.asarray(c))))
