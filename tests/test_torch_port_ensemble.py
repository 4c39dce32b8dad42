"""The port's ensemble engine (sparse_coding_tpu_torch/ensemble.py) against
the JAX package's Ensemble, step for step, for the tied, untied and
masked-tied families.

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

from sparse_coding_tpu import ensemble as jensemble
from sparse_coding_tpu.ensemble import Ensemble as JaxEnsemble
from sparse_coding_tpu.models.sae import FunctionalMaskedTiedSAE as JaxMasked
from sparse_coding_tpu.models.sae import FunctionalSAE as JaxSAE
from sparse_coding_tpu.models.sae import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding_tpu_torch.ensemble import (
    Ensemble,
    can_use_fused_tied_step,
    can_use_fused_untied_step,
    safe_increment,
)
from sparse_coding_tpu_torch.models.sae import (
    FunctionalMaskedTiedSAE,
    FunctionalSAE,
    FunctionalTiedSAE,
)
from sparse_coding_tpu_torch.ops import _build
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
    dict_sizes,
)

LRS = [1e-3, 2e-3, 3e-3]
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
MOMENT_TOL = dict(rtol=2e-4, atol=1e-9)
N_STEPS = 20

PATHS = [None, "two_stage", "train_step", "two_stage_tiled",
         "train_step_tiled"]
MASKED_PATHS = [None, "two_stage", "two_stage_tiled"]
# (JAX signature, port signature) of each family; the untied members carry
# a bias decay (the term its kernel paths add outside the kernels), the
# masked ones mixed dictionary sizes padded to N_FEATS
SIGS = {"tied": (JaxTiedSAE, FunctionalTiedSAE),
        "untied": (JaxSAE, FunctionalSAE),
        "masked_tied": (JaxMasked, FunctionalMaskedTiedSAE)}
INIT_KW = {"tied": {}, "untied": {"bias_decay": 0.01}, "masked_tied": {}}
# every kernel path of each family, and autodiff; the tied cases keep
# their bare path ids
TRAJECTORIES = ([("tied", p) for p in PATHS]
                + [("untied", p) for p in PATHS]
                + [("masked_tied", p) for p in MASKED_PATHS])


def _traj_id(case):
    family, path = case
    label = path or "autodiff"
    return label if family == "tied" else f"{family}-{label}"


def _jax_members(family="tied", seed=0, **kw):
    sig = SIGS[family][0]
    keys = jax.random.split(jax.random.PRNGKey(seed), N_MEMBERS)
    if family == "masked_tied":
        return [sig.init(k, D, n, N_FEATS, l1_alpha=l1, **kw)
                for k, n, l1 in zip(keys, dict_sizes(), L1S)]
    return [sig.init(k, D, N_FEATS, l1_alpha=l1, **kw)
            for k, l1 in zip(keys, L1S)]


def _pair(path, family="tied", **init_kw):
    """A JAX Ensemble on ``path`` (None = autodiff) and the port's twin,
    built from the same members. Only the JAX side takes tiles: the
    port's kernels block at their own fixed tiles."""
    sig, port_sig = SIGS[family]
    jmembers = _jax_members(family, **init_kw)
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


@pytest.mark.parametrize("case", TRAJECTORIES, ids=_traj_id)
def test_trajectory_and_sentinel_match_jax(case):
    """20 steps on each kernel path of each family, and on autodiff, track
    the JAX Ensemble — losses, activity, the sentinel's grad norm (each
    path's own: the kernel grad norm on the tiled paths, the update norm
    on the whole-step ones), params and moments; then a NaN l1
    coefficient makes member 1's step non-finite and the quarantine bit
    freezes member 2 — both sides freeze exactly those members, bit for
    bit, and keep training the rest."""
    family, path = case
    jens, tens = _pair(path, family, **INIT_KW[family])
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


def test_no_card_means_the_entry_point_raises():
    """device=None means cuda: without a card the constructor raises and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    members = members_from_numpy(jax.device_get(_jax_members()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ensemble(members, FunctionalTiedSAE)


def test_unported_options_raise():
    """An option value the port has no kernels for raises: a compute dtype
    other than float32 or bfloat16 (bfloat16 is ported:
    test_bf16_trajectory_and_sentinel_match_jax and
    tests/test_torch_port_bf16.py), a moments dtype other than those two
    (the JAX package's ValueError), an unknown path."""
    members = members_from_numpy(jax.device_get(_jax_members()))
    with pytest.raises(NotImplementedError, match="float16"):
        Ensemble(members, FunctionalTiedSAE, device="cpu",
                 fused_compute_dtype="float16")
    with pytest.raises(ValueError, match="must be 'float32' or 'bfloat16'"):
        Ensemble(members, FunctionalTiedSAE, device="cpu",
                 fused_moments_dtype="float16", fused_path="train_step")
    with pytest.raises(ValueError, match="fused_path must be"):
        Ensemble(members, FunctionalTiedSAE, device="cpu", fused_path="fast")


BF16_OPTS = dict(fused_compute_dtype="bfloat16",
                 fused_moments_dtype="bfloat16")


@pytest.mark.parametrize("family", ["tied", "untied"])
def test_bf16_trajectory_and_sentinel_match_jax(family):
    """The bf16 options, which raised before they were ported, on the
    default path (train_step_tiled) with bf16 batches: 6 steps track the
    JAX Ensemble (losses rtol 1e-4, params within 1e-3 of max|ref| —
    tests/test_torch_port_bf16.py states these bounds), the encoder and
    decoder moments stay bf16; then the sentinel freezes a NaN member and
    a quarantined one bit for bit, bf16 moments included."""
    jm = _jax_members(family, **INIT_KW[family])
    jens = JaxEnsemble(jm, SIGS[family][0], lr=LRS, donate=False,
                       use_fused=True, fused_interpret=True,
                       fused_path="train_step_tiled",
                       fused_batch_tile=BATCH_TILE,
                       fused_feat_tile=FEAT_TILE, **BF16_OPTS)
    tens = Ensemble(members_from_numpy(jax.device_get(jm)), SIGS[family][1],
                    lr=LRS, device="cpu", use_fused=True,
                    fused_path="train_step_tiled", **BF16_OPTS)
    data = batches(seed=1, n=8)
    half = lambda b: jax.numpy.asarray(b).astype(jax.numpy.bfloat16)
    for i, b in enumerate(data[:6]):
        ja = jens.step_batch(half(b))
        ta = tens.step_batch(torch.from_numpy(
            np.array(half(b).astype(np.float32))).to(torch.bfloat16))
        np.testing.assert_allclose(ta.losses["loss"].numpy(),
                                   np.asarray(ja.losses["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    s = jax.device_get(jens.state)
    for k, v in tens.state.params.items():
        err = np.abs(v.numpy() - s.params[k]).max()
        assert err <= 1e-3 * np.abs(s.params[k]).max(), k
        want = torch.bfloat16 if k in ("encoder", "decoder") else torch.float32
        assert tens.state.mu[k].dtype == tens.state.nu[k].dtype == want, k

    alphas = tens.state.buffers["l1_alpha"].clone()
    alphas[1] = float("nan")
    tens.state = tens.state.replace(
        buffers={**tens.state.buffers, "l1_alpha": alphas})
    tens.freeze_members([2])
    before = {t: {k: v.clone() for k, v in getattr(tens.state, t).items()}
              for t in ("params", "mu", "nu")}
    for b in data[6:]:
        ta = tens.step_batch(torch.from_numpy(b).to(torch.bfloat16))
    np.testing.assert_array_equal(ta.finite.numpy(), [True, False, True])
    for t, tree in before.items():
        for k, v in getattr(tens.state, t).items():
            for m in (1, 2):
                assert torch.equal(v[m], tree[k][m]), (t, k, m)
            assert not torch.equal(v[0], tree[k][0]), (t, k)


@pytest.mark.parametrize("path", ["train_step", "train_step_tiled"])
def test_forced_whole_step_on_a_masked_bucket_raises(path):
    """The masked family's coef_mask rides the two-stage kernels only: a
    forced whole-step path raises on both sides."""
    jmembers = _jax_members("masked_tied")
    with pytest.raises(ValueError, match=f"fused_path='{path}'"):
        JaxEnsemble(jmembers, JaxMasked, fused_interpret=True,
                    fused_path=path)
    with pytest.raises(ValueError, match="two-stage kernels only"):
        Ensemble(members_from_numpy(jax.device_get(jmembers)),
                 FunctionalMaskedTiedSAE, device="cpu", fused_path=path)


ELIGIBILITY = {
    "identity": ("tied", {}),
    "bias_decay": ("tied", {"bias_decay": 0.01}),
    "centered": ("tied", {"translation": jax.numpy.full((D,), 0.5)}),
    "untied": ("untied", {}),
    "untied_bias_decay": ("untied", {"bias_decay": 0.01}),
    "masked_tied": ("masked_tied", {}),
}


@pytest.mark.parametrize("case", list(ELIGIBILITY))
def test_kernel_path_eligibility_matches_jax(case):
    """The kernel-path gates agree with the JAX package's: a tied bucket
    needs identity centering and zero bias_decay; an untied bucket takes
    any bias_decay; a masked bucket needs its coef_mask. Both sides pick
    the same family. An ineligible bucket trains on autodiff (a counted
    resolution) and refuses a forced kernel path; an eligible one runs its
    family's default path."""
    family, kw = ELIGIBILITY[case]
    sig, port_sig = SIGS[family]
    jmembers = _jax_members(family, **kw)
    members = members_from_numpy(jax.device_get(jmembers))
    for jgate, gate in ((jensemble.can_use_fused_tied_step,
                         can_use_fused_tied_step),
                        (jensemble.can_use_fused_untied_step,
                         can_use_fused_untied_step)):
        assert gate(port_sig, members) == jgate(sig, jmembers,
                                                interpret=True)
    jens = JaxEnsemble(jmembers, sig, fused_interpret=True, donate=False)
    ens = Ensemble(members, port_sig, device="cpu")
    assert ens._fused_family == jens._fused_family
    eligible = case not in ("bias_decay", "centered")
    assert (ens._fused_family is not None) == eligible
    ens.step_batch(torch.from_numpy(batches(seed=3, n=1)[0]))
    default = "two_stage_tiled" if family == "masked_tied" \
        else "train_step_tiled"
    assert ens.fused_path == (default if eligible else None)
    if not eligible:
        assert ens.path_resolved == {("autodiff", "family_ineligible"): 1}
        with pytest.raises(ValueError, match="no kernel path"):
            Ensemble(members, port_sig, device="cpu",
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


# a width just above the kernels' limit (4096), and a batch the 32-row
# tile does not divide
WIDE = _build.MAX_D + 1
UNFIT = [("tied", WIDE, 64), ("tied", D, 100), ("untied", WIDE, 64),
         ("untied", D, 100), ("masked_tied", WIDE, 64)]


def _unfit_id(case):
    family, d, batch = case
    label = f"d{d}" if d == WIDE else f"batch{batch}"
    return label if family == "tied" else f"{family}-{label}"


def _port_members(family, d):
    g = torch.Generator().manual_seed(0)
    sig = SIGS[family][1]
    if family == "masked_tied":
        return [sig.init(g, d, n, N_FEATS, l1_alpha=l1)
                for n, l1 in zip(dict_sizes(), L1S)]
    return [sig.init(g, d, N_FEATS, l1_alpha=l1) for l1 in L1S]


@pytest.mark.parametrize("case", UNFIT, ids=_unfit_id)
def test_unfit_shape_raises_on_the_card(case):
    """On the card, an eligible bucket of any family whose shape the
    kernels do not take (d above their limit, a batch the 32-row tile does
    not divide) raises instead of training on autodiff; use_fused=False is
    the way to autodiff there. A forced path raises on the CPU too. The
    card's resolution is checked here on a CPU-built bucket whose device
    is set to cuda: resolving a step reads shapes only."""
    family, d, batch = case
    sig = SIGS[family][1]
    members = _port_members(family, d)
    ens = Ensemble(members, sig, device="cpu")
    ens._resolve_step(batch)  # the CPU trains it on autodiff
    assert ens.path_resolved == {("autodiff", "no_admissible_tile"): 1}
    card = Ensemble(members, sig, device="cpu")
    card.device = torch.device("cuda")
    with pytest.raises(ValueError, match="they take batch % 32 == 0, "
                       "n_feats % 32 == 0 and 1 <= d <= 4096"):
        card._resolve_step(batch)
    forced = Ensemble(members, sig, device="cpu", fused_path="two_stage")
    with pytest.raises(ValueError, match="do not take"):
        forced._resolve_step(batch)
    off = Ensemble(members, sig, device="cpu", use_fused=False)
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


EXPORT_FIELDS = {
    "tied": ("TiedSAE", ("dictionary", "encoder_bias", "centering_rot",
                         "centering_trans", "centering_scale")),
    "untied": ("UntiedSAE", ("encoder", "encoder_bias", "dictionary")),
    "masked_tied": ("TiedSAE", ("dictionary", "encoder_bias")),
}


@pytest.mark.parametrize("family", list(EXPORT_FIELDS))
def test_learned_dicts_match_jax_export(family):
    """to_learned_dicts gives the JAX package's classes and fields, bit
    for bit; a masked member's dictionary is sliced to its dict_size."""
    path = "two_stage_tiled" if family == "masked_tied" \
        else "train_step_tiled"
    jens, tens = _pair(path, family)
    _carry(jens, tens)
    cls, fields = EXPORT_FIELDS[family]
    x = batches(seed=6, n=1)[0]
    for i, (jd, td) in enumerate(zip(jens.to_learned_dicts(),
                                     tens.to_learned_dicts())):
        assert type(jd).__name__ == type(td).__name__ == cls
        for f in fields:
            np.testing.assert_array_equal(getattr(td, f).numpy(),
                                          np.asarray(getattr(jd, f)))
        if family == "masked_tied":
            assert tuple(td.dictionary.shape) == (dict_sizes()[i], D)
        np.testing.assert_allclose(td.predict(torch.from_numpy(x)).numpy(),
                                   np.asarray(jd.predict(x)), rtol=1e-5,
                                   atol=1e-6)


def test_carry_keeps_buffer_dtypes():
    """A masked-tied JAX state carried across keeps its buffers' kinds:
    coef_mask stays bool and dict_size int32 (floats become float32), in
    the stacked state and in the members; the carried bucket then steps
    like the JAX one."""
    jens, tens = _pair("two_stage_tiled", "masked_tied")
    _carry(jens, tens)
    buf = tens.state.buffers
    assert buf["coef_mask"].dtype == torch.bool
    assert buf["dict_size"].dtype == torch.int32
    assert buf["l1_alpha"].dtype == torch.float32
    np.testing.assert_array_equal(buf["coef_mask"].numpy(),
                                  jax.device_get(jens.state.buffers)
                                  ["coef_mask"])
    members = members_from_numpy(jax.device_get(_jax_members("masked_tied")))
    assert members[0][1]["coef_mask"].dtype == torch.bool
    assert members[0][1]["dict_size"].dtype == torch.int32
    b = batches(seed=7, n=1)[0]
    _assert_aux_close(jens.step_batch(jax.numpy.asarray(b)),
                      tens.step_batch(torch.from_numpy(b)), "carried")


def test_safe_increment_saturates_like_optax():
    from sparse_coding_tpu.ensemble import _safe_increment

    c = np.array([0, 5, 2**31 - 2, 2**31 - 1], np.int32)
    np.testing.assert_array_equal(
        safe_increment(torch.from_numpy(c)).numpy(),
        np.asarray(_safe_increment(jax.numpy.asarray(c))))
