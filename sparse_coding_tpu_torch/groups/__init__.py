"""Group-SAE subsystem (the port's counterpart of the JAX package's
``groups/``).

Adjacent layers' residual streams are similar enough to share one SAE
trained on their pooled activations (Group-SAE, arXiv 2410.21508 —
PAPERS.md), cutting sweep cost roughly by the group ratio G/L. The
subsystem is three small host-side pieces over the sharded
store layout the data plane already has (taps ARE shards):

- :mod:`groups.similarity` — streaming pairwise angular-similarity
  matrix between harvested layers, from digest-verified sampled chunks
  (fault site ``groups.similarity``);
- :mod:`groups.assign` — deterministic adjacent-layer greedy clustering
  to a target G, emitting per-group pooled-store manifests plus the
  sha256-digested ``groups.json`` completion marker (written LAST,
  behind crash barrier ``groups.finalize``);
- :mod:`groups.tenants` — one fleet tenant per group (sweep → eval →
  catalog over the group's pooled view, ``kind="group"``).
"""

from sparse_coding_tpu_torch.groups.assign import (
    GROUPS_NAME,
    GroupBuildError,
    build_groups,
    greedy_adjacent_groups,
    group_name,
    load_groups,
)
from sparse_coding_tpu_torch.groups.similarity import layer_similarity, layer_taps
from sparse_coding_tpu_torch.groups.tenants import (
    enqueue_group_tenants,
    group_tenant_config,
)

__all__ = [
    "GROUPS_NAME", "GroupBuildError", "build_groups",
    "greedy_adjacent_groups", "group_name", "load_groups",
    "layer_similarity", "layer_taps",
    "enqueue_group_tenants", "group_tenant_config",
]
