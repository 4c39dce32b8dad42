"""Sequence-parallel GPT-NeoX forward for long-context harvesting (the JAX
package's ``lm/long_context.py``).

The sequence axis of a forward is split over a mesh axis: every rank holds
S/P tokens, attention is exact full-sequence causal attention through
:func:`lm.ring_attention.ring_attention` (key/value blocks rotate around
the ranks), and every other op (layer norms, MLP, embeddings) is
token-local. Harvesting contexts can so exceed what one card's forward
holds — a capability the reference lacks (its contexts cap at 256–2048).

Every rank passes the same global tokens [B, S] and computes its own
block; taps and logits come back sequence-sharded on each rank, and the
caller reassembles them (the harvest gathers each tap along the sequence,
``data/harvest.py``). The JAX package builds one jitted ``shard_map``
program per (config, mesh, taps) and caches it (``lru_cache``); the port
runs eagerly, one process a rank, so there is no program to cache.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sparse_coding_tpu_torch.lm.gptneox import (
    _apply_rotary,
    _layernorm,
    _mlp_out,
    _mlp_post_act,
    _rotary_cos_sin,
)
from sparse_coding_tpu_torch.lm.model_config import LMConfig
from sparse_coding_tpu_torch.lm.ring_attention import ring_attention
from sparse_coding_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

SEQ_AXIS = DATA_AXIS  # sequence parallelism rides the mesh's data axis


def _sp_attention(x_ln: torch.Tensor, layer: dict, cfg: LMConfig,
                  cos: torch.Tensor, sin: torch.Tensor, mesh: Mesh,
                  axis_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence-sharded attention: the local qkv projection and ring
    attention. Returns (the attention output [b, s_local, d], the z
    vectors with heads flattened [b, s_local, h*dh])."""
    b, s_local, _ = x_ln.shape
    h, dh = cfg.n_heads, cfg.d_head
    qkv = x_ln @ layer["qkv_w"].T + layer["qkv_b"]
    q, k, v = qkv.reshape(b, s_local, h, 3 * dh).split(dh, dim=-1)
    q, k = _apply_rotary(q, k, cos, sin, int(dh * cfg.rotary_pct))
    z = ring_attention(q, k, v, mesh, axis_name, scale=dh ** -0.5)
    z_flat = z.reshape(b, s_local, h * dh)
    return z_flat @ layer["dense_w"].T + layer["dense_b"], z_flat


def sequence_parallel_forward(params: dict, tokens: torch.Tensor,
                              cfg: LMConfig, mesh: Mesh,
                              taps: Sequence[str] = (),
                              stop_at_layer: Optional[int] = None,
                              axis_name: str = SEQ_AXIS):
    """Exact GPT-NeoX forward with the sequence of int tokens [B, S] split
    over ``mesh[axis_name]`` (S divisible by the axis size; every rank
    passes the same tokens and runs on the params' device). Returns this
    rank's (logits [B, S/P, vocab], or None when stopped early, {tap: [B,
    S/P, width]}) for positions [r·S/P, (r + 1)·S/P), r its index on the
    axis."""
    n_shards = mesh.shape[axis_name]
    total_s = tokens.shape[1]
    if total_s % n_shards != 0:
        raise ValueError(f"sequence length {total_s} not divisible by mesh "
                         f"axis {axis_name}={n_shards}")
    taps = tuple(taps)
    s_local = total_s // n_shards
    offset = mesh.coords[axis_name] * s_local
    device = params["embed_in"].device
    local = tokens[:, offset:offset + s_local].to(device)

    collected: dict[str, torch.Tensor] = {}
    x = params["embed_in"][local]
    rotary_ndims = int(cfg.d_head * cfg.rotary_pct)
    # the angles of the whole sequence, sliced at this rank's offset
    cos_full, sin_full = _rotary_cos_sin(total_s, rotary_ndims, x.dtype,
                                         device)
    cos = cos_full[offset:offset + s_local]
    sin = sin_full[offset:offset + s_local]

    n_layers = (cfg.n_layers if stop_at_layer is None
                else min(stop_at_layer, cfg.n_layers))
    for i in range(n_layers):
        layer = params["layers"][i]
        x_ln1 = _layernorm(x, layer["ln1_w"], layer["ln1_b"],
                           cfg.layernorm_eps)
        attn_out, z_flat = _sp_attention(x_ln1, layer, cfg, cos, sin, mesh,
                                         axis_name)
        if f"attn_concat.{i}" in taps:
            collected[f"attn_concat.{i}"] = z_flat
        if cfg.parallel_residual:
            x_ln2 = _layernorm(x, layer["ln2_w"], layer["ln2_b"],
                               cfg.layernorm_eps)
        else:
            x = x + attn_out
            x_ln2 = _layernorm(x, layer["ln2_w"], layer["ln2_b"],
                               cfg.layernorm_eps)
        post_act = _mlp_post_act(x_ln2, layer)
        mlp_out = _mlp_out(post_act, layer)
        if f"mlp.{i}" in taps:
            collected[f"mlp.{i}"] = post_act
        if f"mlpout.{i}" in taps:
            collected[f"mlpout.{i}"] = mlp_out
        x = x + attn_out + mlp_out if cfg.parallel_residual else x + mlp_out
        if f"residual.{i}" in taps:
            collected[f"residual.{i}"] = x
        if f"attn.{i}" in taps:
            collected[f"attn.{i}"] = x

    if stop_at_layer is not None and stop_at_layer < cfg.n_layers:
        return None, collected
    x = _layernorm(x, params["final_ln_w"], params["final_ln_b"],
                   cfg.layernorm_eps)
    return x @ params["embed_out"].T, collected
