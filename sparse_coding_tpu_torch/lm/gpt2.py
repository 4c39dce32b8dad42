"""GPT-2 forward pass with activation taps (the JAX package's
``lm/gpt2.py``): the tap and edit interface of lm/gptneox.py with a
serial residual, learned positional embeddings, tanh-approximate GELU and
a tied unembedding. Weights follow HF's Conv1D layout ([in, out]:
y = x @ W + b)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.lm.gptneox import EditFn, _attend, _layernorm
from sparse_coding_tpu_torch.lm.model_config import LMConfig


def _attention_z(x_ln, layer: dict, cfg: LMConfig):
    """Pre-c_proj z vectors [b, s, h*dh] (the attn_concat tap point)."""
    b, s, _ = x_ln.shape
    h, dh = cfg.n_heads, cfg.d_head
    qkv = x_ln @ layer["c_attn_w"] + layer["c_attn_b"]  # q | k | v
    q, k, v = (t.reshape(b, s, h, dh) for t in qkv.chunk(3, dim=-1))
    return _attend(q, k, v)


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            taps: Sequence[str] = (), stop_at_layer: Optional[int] = None,
            edit: Optional[EditFn] = None
            ) -> tuple[Optional[torch.Tensor], dict[str, torch.Tensor]]:
    """As lm/gptneox.py's ``forward``."""
    taps = tuple(taps)
    collected: dict[str, torch.Tensor] = {}
    edit_name = edit[0] if edit is not None else None

    def maybe_edit(name: str, value: torch.Tensor) -> torch.Tensor:
        if edit_name == name:
            value = edit[1](value)
        if name in taps:
            collected[name] = value
        return value

    s = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:s]
    n_layers = (cfg.n_layers if stop_at_layer is None
                else min(stop_at_layer, cfg.n_layers))
    for i in range(n_layers):
        layer = params["layers"][i]
        x_ln1 = _layernorm(x, layer["ln1_w"], layer["ln1_b"],
                           cfg.layernorm_eps)
        z_flat = maybe_edit(f"attn_concat.{i}",
                            _attention_z(x_ln1, layer, cfg))
        x = x + (z_flat @ layer["c_proj_w"] + layer["c_proj_b"])
        x_ln2 = _layernorm(x, layer["ln2_w"], layer["ln2_b"],
                           cfg.layernorm_eps)
        h = x_ln2 @ layer["c_fc_w"] + layer["c_fc_b"]
        post_act = maybe_edit(f"mlp.{i}", torch.nn.functional.gelu(
            h, approximate="tanh"))  # gelu_new
        mlp_out = maybe_edit(f"mlpout.{i}", post_act @ layer["mlp_c_proj_w"]
                             + layer["mlp_c_proj_b"])
        x = x + mlp_out
        x = maybe_edit(f"residual.{i}", x)
        x = maybe_edit(f"attn.{i}", x)

    if stop_at_layer is not None and stop_at_layer < cfg.n_layers:
        return None, collected
    x = _layernorm(x, params["final_ln_w"], params["final_ln_b"],
                   cfg.layernorm_eps)
    return x @ params["wte"].T, collected  # tied unembedding


def init_params(generator: torch.Generator, cfg: LMConfig,
                dtype=torch.float32, device=None) -> dict:
    """Random weights as lm/gptneox.py's ``init_params``."""
    dev = resolve_device(device)
    d, v, dm = cfg.d_model, cfg.vocab_size, cfg.d_mlp

    def norm(*shape):
        return (0.02 * torch.randn(shape, generator=generator, dtype=dtype,
                                   device=generator.device)).to(dev)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1_w": ones(d), "ln1_b": zeros(d),
            "ln2_w": ones(d), "ln2_b": zeros(d),
            "c_attn_w": norm(d, 3 * d), "c_attn_b": zeros(3 * d),
            "c_proj_w": norm(d, d), "c_proj_b": zeros(d),
            "c_fc_w": norm(d, dm), "c_fc_b": zeros(dm),
            "mlp_c_proj_w": norm(dm, d), "mlp_c_proj_b": zeros(d),
        })
    return {"wte": norm(v, d), "wpe": norm(cfg.max_seq_len, d),
            "layers": layers, "final_ln_w": ones(d), "final_ln_b": zeros(d)}
