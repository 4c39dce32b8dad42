"""The port's parallel layer: the ("model", "data") mesh on
``torch.distributed`` (:mod:`parallel.mesh`), the partition rules
(:mod:`parallel.partition`) and cross-rank consensus.

``agree_any`` is the one home of the any-rank-flags-all-ranks-act rule
that control flow with collectives inside depends on: a branch holding a
collective (a checkpoint barrier, a rollback restore) must be taken by
EVERY rank together, or the ranks that skipped it deadlock the ones
inside it. ``train/sweep.py`` uses it for SIGTERM preemption and the
training guardian for its anomaly and rollback decisions.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def agree_any(flag: bool, tag: str = "") -> bool:
    """Cross-rank OR-consensus on a local boolean (the identity in a world
    of one or none): True everywhere iff ANY rank passed True — an
    all-reduce (MAX) over the world. ``tag`` names the call site; every
    agreement across ranks logs it (DEBUG, or WARNING when the decision
    fires) so an operator reading a hang or an unexpected preemption can
    tell which agreement was in flight."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    agreed = bool(t.item())
    logger.log(logging.WARNING if agreed else logging.DEBUG,
               "agree_any[%s]: local=%s -> global=%s (process %d/%d)",
               tag, bool(flag), agreed, dist.get_rank(),
               dist.get_world_size())
    return agreed


__all__ = ["agree_any"]
