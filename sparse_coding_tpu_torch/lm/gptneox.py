"""GPT-NeoX (Pythia) forward pass with activation taps (the JAX package's
``lm/gptneox.py``):

    logits, taps = forward(params, tokens, cfg, taps=("residual.2",),
                           stop_at_layer=3, edit=None)

- ``taps`` collects activations named by lm/hooks.py's vocabulary.
- ``stop_at_layer`` skips the later layers (and the logits).
- ``edit=(tap, fn)`` applies ``fn`` to the named activation in flight;
  ``attn_concat`` and ``mlp`` edits land before their output projections,
  so they reach the residual stream.

Numerics are the JAX package's: fp32 layer norm, exact GELU, NeoX's
rotate-half rotary on the leading ``rotary_pct`` of each head, causal
softmax in fp32 masked with ``finfo(float32).min``. Attention is written
out as there (no fused attention call), and the products are plain
``torch.matmul``/einsum in true fp32 (the package turns TF32 off). Params
are a dict of tensors in the JAX package's layout (HF's: weights
[out, in]); ``lm/convert.py`` fills it from a Hugging Face state dict or
from the JAX package's params.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from sparse_coding_tpu_torch import resolve_device
from sparse_coding_tpu_torch.lm.model_config import LMConfig

EditFn = tuple[str, Callable[[torch.Tensor], torch.Tensor]]


def _layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * w + b).to(x.dtype)


def _rotary_cos_sin(seq_len: int, rotary_ndims: int, dtype, device,
                    base: float = 10000.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    inv_freq = 1.0 / (base ** (torch.arange(0, rotary_ndims, 2,
                                            dtype=torch.float32,
                                            device=device) / rotary_ndims))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)  # [s, rd/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [s, rd]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rotary(q, k, cos, sin, rotary_ndims: int):
    # q, k: [b, s, h, dh]; cos/sin: [s, rd] — NeoX rotates the first rd dims
    q_rot, q_pass = q[..., :rotary_ndims], q[..., rotary_ndims:]
    k_rot, k_pass = k[..., :rotary_ndims], k[..., rotary_ndims:]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    q_rot = q_rot * cos + _rotate_half(q_rot) * sin
    k_rot = k_rot * cos + _rotate_half(k_rot) * sin
    return (torch.cat([q_rot, q_pass], dim=-1),
            torch.cat([k_rot, k_pass], dim=-1))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """Causal attention of [b, s, h, dh] heads, the scores in fp32; the z
    vectors with heads flattened [b, s, h*dh]."""
    b, s, h, dh = q.shape
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
              / dh ** 0.5)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=q.device))
    scores = torch.where(causal, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    z = torch.einsum("bhqk,bkhd->bqhd", probs, v)  # [b, s, h, dh]
    return z.reshape(b, s, h * dh)


def _attention_z(x_ln, layer: dict, cfg: LMConfig, cos, sin):
    """Pre-W_O z vectors, heads flattened [b, s, h*dh] (the attn_concat
    tap point)."""
    b, s, _ = x_ln.shape
    h, dh = cfg.n_heads, cfg.d_head
    # [b, s, 3d] in HF's head-blocked layout
    qkv = x_ln @ layer["qkv_w"].T + layer["qkv_b"]
    q, k, v = qkv.reshape(b, s, h, 3 * dh).split(dh, dim=-1)
    q, k = _apply_rotary(q, k, cos, sin, int(dh * cfg.rotary_pct))
    return _attend(q, k, v)


def _mlp_post_act(x_ln, layer: dict):
    """Post-activation hidden [b, s, d_mlp] (the mlp tap point)."""
    h = x_ln @ layer["h_to_4h_w"].T + layer["h_to_4h_b"]
    return torch.nn.functional.gelu(h)  # exact, as HF's Pythia


def _mlp_out(post_act, layer: dict):
    return post_act @ layer["fourh_to_h_w"].T + layer["fourh_to_h_b"]


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            taps: Sequence[str] = (), stop_at_layer: Optional[int] = None,
            edit: Optional[EditFn] = None
            ) -> tuple[Optional[torch.Tensor], dict[str, torch.Tensor]]:
    """Run GPT-NeoX on int tokens [b, s] (on the params' device); collect
    ``taps``; optionally apply an in-flight edit. Returns (logits, or None
    when stopped early, {tap: [b, s, width]})."""
    taps = tuple(taps)
    collected: dict[str, torch.Tensor] = {}
    edit_name = edit[0] if edit is not None else None

    def maybe_edit(name: str, value: torch.Tensor) -> torch.Tensor:
        if edit_name == name:
            value = edit[1](value)
        if name in taps:
            collected[name] = value
        return value

    x = params["embed_in"][tokens]
    rotary_ndims = int(cfg.d_head * cfg.rotary_pct)
    cos, sin = _rotary_cos_sin(tokens.shape[1], rotary_ndims, x.dtype,
                               x.device)
    n_layers = (cfg.n_layers if stop_at_layer is None
                else min(stop_at_layer, cfg.n_layers))
    for i in range(n_layers):
        layer = params["layers"][i]
        x_ln1 = _layernorm(x, layer["ln1_w"], layer["ln1_b"],
                           cfg.layernorm_eps)
        z_flat = maybe_edit(f"attn_concat.{i}",
                            _attention_z(x_ln1, layer, cfg, cos, sin))
        attn_out = z_flat @ layer["dense_w"].T + layer["dense_b"]
        if cfg.parallel_residual:
            x_ln2 = _layernorm(x, layer["ln2_w"], layer["ln2_b"],
                               cfg.layernorm_eps)
            post_act = maybe_edit(f"mlp.{i}", _mlp_post_act(x_ln2, layer))
            mlp_out = maybe_edit(f"mlpout.{i}", _mlp_out(post_act, layer))
            x = x + attn_out + mlp_out
        else:
            x = x + attn_out
            x_ln2 = _layernorm(x, layer["ln2_w"], layer["ln2_b"],
                               cfg.layernorm_eps)
            post_act = maybe_edit(f"mlp.{i}", _mlp_post_act(x_ln2, layer))
            mlp_out = maybe_edit(f"mlpout.{i}", _mlp_out(post_act, layer))
            x = x + mlp_out
        x = maybe_edit(f"residual.{i}", x)
        # "attn" aliases the post-block residual, as in the reference
        x = maybe_edit(f"attn.{i}", x)

    if stop_at_layer is not None and stop_at_layer < cfg.n_layers:
        return None, collected
    x = _layernorm(x, params["final_ln_w"], params["final_ln_b"],
                   cfg.layernorm_eps)
    return x @ params["embed_out"].T, collected


def init_params(generator: torch.Generator, cfg: LMConfig,
                dtype=torch.float32, device=None) -> dict:
    """Random weights, N(0, 0.02²) from ``generator`` (drawn on its
    device, in the JAX package's order), on ``device`` (default: the
    card); norms at 1 and biases at 0."""
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
            "qkv_w": norm(3 * d, d), "qkv_b": zeros(3 * d),
            "dense_w": norm(d, d), "dense_b": zeros(d),
            "h_to_4h_w": norm(dm, d), "h_to_4h_b": zeros(dm),
            "fourh_to_h_w": norm(d, dm), "fourh_to_h_b": zeros(d),
        })
    return {"embed_in": norm(v, d), "layers": layers,
            "final_ln_w": ones(d), "final_ln_b": zeros(d),
            "embed_out": norm(v, d)}
