"""Hugging Face checkpoint → param dicts (the JAX package's
``lm/convert.py``), and the weight carry from the JAX package's params.

Torch state dicts (a local HF cache, or ``transformers`` models built
from a config in tests) map to the dicts lm/gptneox.py and lm/gpt2.py
take, in the JAX package's layout. ``load_model`` reads a pretrained
checkpoint from the local HF cache only: it never downloads, and raises
with what is missing when ``transformers`` or the cache is absent.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.lm.model_config import LMConfig, get_config


def _getter(sd: Mapping[str, Any], dtype, device):
    dev = resolve_device(device)

    def g(name: str) -> torch.Tensor:
        return torch.as_tensor(sd[name]).detach().to(dev, dtype).contiguous()

    return g


def convert_gptneox_state_dict(sd: Mapping[str, Any], cfg: LMConfig,
                               dtype=torch.float32, device=None) -> dict:
    """Map a HF GPTNeoXForCausalLM state dict to lm/gptneox.py's params
    on ``device`` (default: the card)."""
    g = _getter(sd, dtype, device)
    prefix = "gpt_neox." if any(k.startswith("gpt_neox.") for k in sd) else ""
    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}layers.{i}."
        layers.append({
            "ln1_w": g(p + "input_layernorm.weight"),
            "ln1_b": g(p + "input_layernorm.bias"),
            "ln2_w": g(p + "post_attention_layernorm.weight"),
            "ln2_b": g(p + "post_attention_layernorm.bias"),
            "qkv_w": g(p + "attention.query_key_value.weight"),
            "qkv_b": g(p + "attention.query_key_value.bias"),
            "dense_w": g(p + "attention.dense.weight"),
            "dense_b": g(p + "attention.dense.bias"),
            "h_to_4h_w": g(p + "mlp.dense_h_to_4h.weight"),
            "h_to_4h_b": g(p + "mlp.dense_h_to_4h.bias"),
            "fourh_to_h_w": g(p + "mlp.dense_4h_to_h.weight"),
            "fourh_to_h_b": g(p + "mlp.dense_4h_to_h.bias"),
        })
    return {"embed_in": g(prefix + "embed_in.weight"), "layers": layers,
            "final_ln_w": g(prefix + "final_layer_norm.weight"),
            "final_ln_b": g(prefix + "final_layer_norm.bias"),
            "embed_out": g("embed_out.weight")}


def convert_gpt2_state_dict(sd: Mapping[str, Any], cfg: LMConfig,
                            dtype=torch.float32, device=None) -> dict:
    """Map a HF GPT2LMHeadModel state dict to lm/gpt2.py's params (HF's
    Conv1D weights are already [in, out], as ``x @ W`` takes them)."""
    g = _getter(sd, dtype, device)
    prefix = ("transformer." if any(k.startswith("transformer.") for k in sd)
              else "")
    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}h.{i}."
        layers.append({
            "ln1_w": g(p + "ln_1.weight"), "ln1_b": g(p + "ln_1.bias"),
            "ln2_w": g(p + "ln_2.weight"), "ln2_b": g(p + "ln_2.bias"),
            "c_attn_w": g(p + "attn.c_attn.weight"),
            "c_attn_b": g(p + "attn.c_attn.bias"),
            "c_proj_w": g(p + "attn.c_proj.weight"),
            "c_proj_b": g(p + "attn.c_proj.bias"),
            "c_fc_w": g(p + "mlp.c_fc.weight"), "c_fc_b": g(p + "mlp.c_fc.bias"),
            "mlp_c_proj_w": g(p + "mlp.c_proj.weight"),
            "mlp_c_proj_b": g(p + "mlp.c_proj.bias"),
        })
    return {"wte": g(prefix + "wte.weight"), "wpe": g(prefix + "wpe.weight"),
            "layers": layers, "final_ln_w": g(prefix + "ln_f.weight"),
            "final_ln_b": g(prefix + "ln_f.bias")}


def params_from_numpy(tree: Mapping[str, Any], dtype=torch.float32,
                      device=None) -> dict:
    """The weight carry: the JAX package's LM params as numpy arrays
    (``jax.device_get`` of its ``init_params`` or ``load_model``) → this
    package's params, the same layout and values, on ``device``."""
    dev = resolve_device(device)

    def conv(v):
        return torch.from_numpy(np.array(v, np.float32)).to(dev, dtype)

    return {k: ([{n: conv(a) for n, a in layer.items()} for layer in v]
                if k == "layers" else conv(v))
            for k, v in tree.items()}


def load_model(model_name: str, dtype=torch.float32,
               device=None) -> tuple[dict, LMConfig]:
    """Load a pretrained checkpoint from the local Hugging Face cache
    (never the network) through ``transformers`` and convert it. Returns
    (params, cfg)."""
    cfg = get_config(model_name)
    try:
        from transformers import AutoModelForCausalLM
    except ImportError as e:
        raise RuntimeError(
            f"load_model({model_name!r}) needs the transformers package, "
            "which is not installed") from e
    try:
        model = AutoModelForCausalLM.from_pretrained(model_name,
                                                     local_files_only=True)
    except OSError as e:
        raise RuntimeError(
            f"load_model({model_name!r}): no local Hugging Face cache of "
            f"this checkpoint ({e}); populate HF_HOME with it first — "
            "nothing is downloaded") from e
    sd = model.state_dict()
    if cfg.arch == "gptneox":
        return convert_gptneox_state_dict(sd, cfg, dtype, device), cfg
    if cfg.arch == "gpt2":
        return convert_gpt2_state_dict(sd, cfg, dtype, device), cfg
    raise ValueError(f"unknown arch {cfg.arch}")


def forward_fn(cfg: LMConfig):
    """The architecture's ``forward``."""
    if cfg.arch == "gptneox":
        from sparse_coding_tpu_torch.lm import gptneox
        return gptneox.forward
    if cfg.arch == "gpt2":
        from sparse_coding_tpu_torch.lm import gpt2
        return gpt2.forward
    raise ValueError(f"unknown arch {cfg.arch}")
