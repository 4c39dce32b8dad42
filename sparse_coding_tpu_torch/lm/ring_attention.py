"""Ring attention: causal attention over a sequence-sharded mesh axis (the
JAX package's ``lm/ring_attention.py``).

The sequence is split over the ranks of one mesh axis. Each rank keeps its
query block; the key/value blocks travel around the ring
(:meth:`parallel.mesh.Mesh.ppermute`, rank i sends to i + 1), and each
block is folded into flash-style online-softmax accumulators (m, l, o in
fp32). Memory per rank is O(S/P); the result is full-sequence causal
attention. The local block goes first, then exactly P − 1 rotations, in
the JAX function's order, so the two agree to rounding.

Plain torch products (``einsum``), as the JAX function is plain ``jnp``
with no Pallas kernel. A block wholly in a query block's future is still
computed: its scores are all masked, so it adds exactly zero, as in the
JAX loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_coding_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

# the mask value of the JAX ring (the single-device forward masks with
# finfo(float32).min; -1e30 keeps exp(scores - m) finite when a whole row
# of a block is masked)
_NEG_INF = -1e30


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int, kv_offset: int, scale: float,
                  m: torch.Tensor, l: torch.Tensor, o: torch.Tensor):
    """One (q-block × kv-block) flash-attention update.

    q: [B, Sq, H, Dh]; k, v: [B, Sk, H, Dh]; m, l: [B, H, Sq]; o like q
    (fp32). Global causal mask: the query at q_offset + i sees the key at
    kv_offset + j iff q_offset + i >= kv_offset + j."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    sq, sk = q.shape[1], k.shape[1]
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = kv_offset + torch.arange(sk, device=q.device)
    causal = q_pos[:, None] >= kv_pos[None, :]
    scores = torch.where(causal, scores, _NEG_INF)

    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    # a fully masked row: p = exp(-1e30 - m) = 0, harmless
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis_name: str = DATA_AXIS,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of this rank's sequence block over the whole
    sequence sharded on ``mesh[axis_name]`` (rank i of the axis holds
    positions [i·S_local, (i + 1)·S_local)). q, k, v: [B, S_local, H, Dh]
    on every rank; returns [B, S_local, H, Dh] in q's dtype. Every rank of
    the axis must call it (the rotations are collective)."""
    n_shards = mesh.shape[axis_name]
    my_idx = mesh.coords[axis_name]
    s_local = q.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q_offset = my_idx * s_local

    b, sq, h, dh = q.shape
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)

    # step 0: the local block (no rotation needed)
    m, l, o = _block_attend(q, k, v, q_offset, q_offset, scale, m, l, o)
    k_blk, v_blk = k, v
    for step in range(1, n_shards):
        # rotate kv to the next rank (i sends to i + 1), then attend;
        # rotating first means exactly n_shards - 1 transfers
        k_blk = mesh.ppermute(k_blk, axis_name)
        v_blk = mesh.ppermute(v_blk, axis_name)
        kv_offset = ((my_idx - step) % n_shards) * s_local
        m, l, o = _block_attend(q, k_blk, v_blk, q_offset, kv_offset, scale,
                                m, l, o)
    l = torch.clamp(l, min=1e-30)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)
