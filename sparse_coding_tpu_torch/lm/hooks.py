"""Hook-point (tap) vocabulary.

Mirrors the reference's hook naming layer (reference:
activation_dataset.py:39-106): a tap is `(layer_loc, layer)` with
layer_loc ∈ {residual, mlp, attn, attn_concat, mlpout}. The reference maps
these to transformer_lens hook strings; here they map to tap keys collected
directly by the forward passes (lm/gptneox.py, lm/gpt2.py). The port's own
copy of the JAX package's ``lm/hooks.py``.

Semantics (validated against transformer_lens conventions):
- residual:    post-block residual stream            [d_model]
- mlp:         post-activation inside the MLP        [d_mlp]
- attn:        post-block residual stream (the reference aliases "attn" to
               hook_resid_post too, activation_dataset.py:96-100)  [d_model]
- attn_concat: pre-W_O per-head z vectors, heads flattened  [n_heads*d_head]
- mlpout:      MLP branch output before residual add  [d_model]
"""

from __future__ import annotations

from typing import Sequence

LAYER_LOCS = ("residual", "mlp", "attn", "attn_concat", "mlpout")


def check_layer_loc(layer_loc: str) -> None:
    if layer_loc not in LAYER_LOCS:
        raise ValueError(f"layer_loc {layer_loc!r} not in {LAYER_LOCS}")


def get_activation_size(layer_loc: str, cfg) -> int:
    """Width of a tapped activation (reference: activation_dataset.py:39-58)."""
    check_layer_loc(layer_loc)
    if layer_loc in ("residual", "mlpout"):
        return cfg.d_model
    if layer_loc == "mlp":
        return cfg.d_mlp
    return cfg.n_heads * cfg.d_head  # attn, attn_concat


def tap_name(layer: int, layer_loc: str) -> str:
    """Canonical tap key (replaces transformer_lens tensor names,
    reference: activation_dataset.py:69-106)."""
    check_layer_loc(layer_loc)
    return f"{layer_loc}.{layer}"


def parse_tap_name(name: str) -> tuple[str, int]:
    loc, layer = name.rsplit(".", 1)
    check_layer_loc(loc)
    return loc, int(layer)


def taps_for(layers: Sequence[int], layer_loc: str) -> tuple[str, ...]:
    return tuple(tap_name(l, layer_loc) for l in layers)


def max_tap_layer(taps: Sequence[str]) -> int:
    return max(parse_tap_name(t)[1] for t in taps)
