"""The port's LM forwards (sparse_coding_tpu_torch/lm/) against the JAX
package's, on the same tiny random weights (the JAX ``init_params``,
carried across by ``lm.convert.params_from_numpy``) and the same numpy
tokens: logits, every tap location, ``stop_at_layer`` and in-flight edits
within rtol 1e-5 of max|ref| (both fp32; the sums run in other orders).
Then the port against ``transformers``' torch models built offline from a
config, through ``convert_*_state_dict``, at test_lm_parity.py's bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.lm import gpt2 as jgpt2
from sparse_coding_tpu.lm import gptneox as jneox
from sparse_coding_tpu.lm import hooks as jhooks
from sparse_coding_tpu.lm import model_config as jconfig
from sparse_coding_tpu_torch.lm import convert, gpt2, gptneox, hooks
from sparse_coding_tpu_torch.lm import model_config as config

ARCHS = {"gptneox": (jneox, gptneox), "gpt2": (jgpt2, gpt2)}
RTOL = 1e-5  # of max|ref|
HF_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_lm_parity.py's


def _close(got: torch.Tensor, ref, what: str, rtol: float = RTOL) -> None:
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (what, err)


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """(arch, JAX module, port module, cfg, JAX params, port params)."""
    arch = request.param
    jmod, tmod = ARCHS[arch]
    cfg = jconfig.tiny_test_config(arch)
    jparams = jmod.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_numpy(jax.device_get(jparams),
                                        device="cpu")
    return arch, jmod, tmod, config.tiny_test_config(arch), jparams, tparams


def _tokens(cfg, batch=2, seq=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(batch, seq))


ALL_TAPS = [f"{loc}.{layer}" for loc in hooks.LAYER_LOCS
            for layer in range(3)]


def test_logits_and_every_tap_match_jax(pair):
    _, jmod, tmod, cfg, jp, tp = pair
    toks = _tokens(cfg)
    jl, jt = jmod.forward(jp, jnp.asarray(toks), cfg, taps=ALL_TAPS)
    tl, tt = tmod.forward(tp, torch.as_tensor(toks), cfg, taps=ALL_TAPS)
    _close(tl, jl, "logits")
    assert set(tt) == set(jt) == set(ALL_TAPS)
    for name in ALL_TAPS:
        _close(tt[name], jt[name], name)
        loc, _ = hooks.parse_tap_name(name)
        assert tt[name].shape[-1] == hooks.get_activation_size(loc, cfg)


def test_stop_at_layer_matches_jax(pair):
    _, jmod, tmod, cfg, jp, tp = pair
    toks = _tokens(cfg, seed=1)
    taps = ("residual.1", "mlp.1")
    jl, jt = jmod.forward(jp, jnp.asarray(toks), cfg, taps=taps,
                          stop_at_layer=2)
    tl, tt = tmod.forward(tp, torch.as_tensor(toks), cfg, taps=taps,
                          stop_at_layer=2)
    assert tl is None and jl is None
    _, full = tmod.forward(tp, torch.as_tensor(toks), cfg, taps=taps)
    for name in taps:
        _close(tt[name], jt[name], name)
        assert torch.equal(tt[name], full[name]), name


@pytest.mark.parametrize("loc", ["attn_concat", "mlp", "mlpout", "residual"])
def test_edits_propagate_as_in_jax(pair, loc):
    """An edit at each hook of layer 1 reaches the logits, as the JAX
    forward's does: the edited logits agree, and differ from the
    unedited ones."""
    _, jmod, tmod, cfg, jp, tp = pair
    toks = _tokens(cfg, seed=2)
    tap = f"{loc}.1"
    jl, jt = jmod.forward(jp, jnp.asarray(toks), cfg, taps=(tap,),
                          edit=(tap, lambda x: 0.5 * x + 0.1))
    tl, tt = tmod.forward(tp, torch.as_tensor(toks), cfg, taps=(tap,),
                          edit=(tap, lambda x: 0.5 * x + 0.1))
    _close(tl, jl, f"edited logits at {tap}")
    _close(tt[tap], jt[tap], f"edited tap {tap}")
    base, _ = tmod.forward(tp, torch.as_tensor(toks), cfg)
    assert not torch.allclose(base, tl), tap


def test_init_params_layout_and_generator(pair):
    """init_params draws the JAX layout (every leaf's shape) from the
    generator: one seed gives the same weights twice, another seed
    others."""
    _, jmod, tmod, cfg, jp, _ = pair

    def draw(seed):
        return tmod.init_params(torch.Generator().manual_seed(seed), cfg,
                                device="cpu")

    a, b, c = draw(0), draw(0), draw(1)
    ja = jax.device_get(jp)
    assert set(a) == set(ja)
    for k, v in a.items():
        if k == "layers":
            for la, lb, jl in zip(v, b[k], ja[k]):
                for n in jl:
                    assert tuple(la[n].shape) == jl[n].shape, n
                    assert torch.equal(la[n], lb[n]), n
        else:
            assert tuple(v.shape) == ja[k].shape, k
            assert torch.equal(v, b[k]), k
    first = "embed_in" if "embed_in" in a else "wte"
    assert not torch.equal(a[first], c[first])
    assert abs(float(a[first].std()) - 0.02) < 2e-3


def test_config_and_hooks_are_the_jax_copies():
    assert set(config.PRESETS) == set(jconfig.PRESETS)
    for name, cfg in config.PRESETS.items():
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jconfig.PRESETS[name])), name
        assert config.get_config(name).d_head == jconfig.get_config(
            name).d_head
    for arch in ARCHS:
        assert (dataclasses.asdict(config.tiny_test_config(arch))
                == dataclasses.asdict(jconfig.tiny_test_config(arch)))
    with pytest.raises(KeyError, match="no preset"):
        config.get_config("pythia-7b")
    assert hooks.LAYER_LOCS == jhooks.LAYER_LOCS
    cfg = config.get_config("EleutherAI/pythia-70m-deduped")
    for loc in hooks.LAYER_LOCS:
        assert (hooks.get_activation_size(loc, cfg)
                == jhooks.get_activation_size(loc, cfg))
    assert hooks.get_activation_size("mlp", cfg) == 2048
    assert hooks.taps_for([1, 2], "mlp") == jhooks.taps_for([1, 2], "mlp")
    assert hooks.max_tap_layer(("mlp.1", "residual.4")) == 4
    with pytest.raises(ValueError):
        hooks.tap_name(0, "logits")


def test_forward_fn_dispatch():
    assert convert.forward_fn(config.tiny_test_config("gptneox")) \
        is gptneox.forward
    assert convert.forward_fn(config.tiny_test_config("gpt2")) is gpt2.forward
    with pytest.raises(ValueError, match="unknown arch"):
        convert.forward_fn(dataclasses.replace(
            config.tiny_test_config(), arch="llama"))


def test_load_model_without_a_cache_raises_clearly(tmp_path, monkeypatch):
    """No local Hugging Face cache: a clear error, nothing downloaded
    (the lookup is local_files_only)."""
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="no local Hugging Face cache"):
        convert.load_model("EleutherAI/pythia-70m-deduped", device="cpu")


# --- the port against transformers' torch models ------------------------------

def _hf_neox(cfg):
    from transformers import GPTNeoXConfig, GPTNeoXForCausalLM

    hf_cfg = GPTNeoXConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        intermediate_size=cfg.d_mlp, max_position_embeddings=cfg.max_seq_len,
        rotary_pct=cfg.rotary_pct, use_parallel_residual=True,
        hidden_act="gelu", layer_norm_eps=cfg.layernorm_eps,
        attention_dropout=0.0, hidden_dropout=0.0)
    torch.manual_seed(0)
    model = GPTNeoXForCausalLM(hf_cfg).eval()
    return model, convert.convert_gptneox_state_dict(model.state_dict(), cfg,
                                                     device="cpu")


def _hf_gpt2(cfg):
    from transformers import GPT2Config, GPT2LMHeadModel

    hf_cfg = GPT2Config(
        vocab_size=cfg.vocab_size, n_embd=cfg.d_model, n_layer=cfg.n_layers,
        n_head=cfg.n_heads, n_inner=cfg.d_mlp, n_positions=cfg.max_seq_len,
        layer_norm_epsilon=cfg.layernorm_eps,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    model = GPT2LMHeadModel(hf_cfg).eval()
    return model, convert.convert_gpt2_state_dict(model.state_dict(), cfg,
                                                  device="cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_matches_transformers(arch):
    """Logits and the post-block residuals (HF's hidden states, the last
    one excepted: HF returns it after the final norm) of transformers'
    model equal the port's on its converted state dict."""
    pytest.importorskip("transformers")
    cfg = config.tiny_test_config(arch)
    model, params = (_hf_neox if arch == "gptneox" else _hf_gpt2)(cfg)
    toks = torch.as_tensor(_tokens(cfg, seed=3))
    taps = tuple(f"residual.{i}" for i in range(cfg.n_layers))
    with torch.no_grad():
        out = model(toks, output_hidden_states=True)
    logits, tapped = ARCHS[arch][1].forward(params, toks, cfg, taps=taps)
    np.testing.assert_allclose(logits.numpy(), out.logits.numpy(), **HF_TOL)
    for i in range(cfg.n_layers - 1):
        np.testing.assert_allclose(tapped[f"residual.{i}"].numpy(),
                                   out.hidden_states[i + 1].numpy(),
                                   **HF_TOL, err_msg=f"layer {i}")


def test_state_dict_conversion_equals_jax():
    """convert_*_state_dict gives the JAX conversion's values, leaf for
    leaf, from one HF state dict."""
    pytest.importorskip("transformers")
    from sparse_coding_tpu.lm import convert as jconvert

    for arch, build, jconv in (
            ("gptneox", _hf_neox, jconvert.convert_gptneox_state_dict),
            ("gpt2", _hf_gpt2, jconvert.convert_gpt2_state_dict)):
        cfg = config.tiny_test_config(arch)
        model, params = build(cfg)
        ref = jax.device_get(jconv(model.state_dict(), cfg))
        assert set(params) == set(ref)
        for k, v in params.items():
            if k == "layers":
                for mine, theirs in zip(v, ref[k]):
                    for n in theirs:
                        np.testing.assert_array_equal(mine[n].numpy(),
                                                      theirs[n])
            else:
                np.testing.assert_array_equal(v.numpy(), ref[k])
