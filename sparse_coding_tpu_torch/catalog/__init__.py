"""Feature catalog (the JAX package's ``catalog/``): the build of a
byte-deterministic per-feature index over sweep artifacts and a chunk
store (:mod:`build`), and the query ops on decoder rows and dict stacks
(:mod:`query`). The serving half (``CatalogService`` and its request
classes) waits for the port's serving work, ROADMAP.md queue 1, item
13."""

from sparse_coding_tpu_torch.catalog.build import (
    CatalogIndex,
    build_catalog,
    load_catalog_records,
)
from sparse_coding_tpu_torch.catalog.query import (
    neighbor_topk,
    union_vote,
    unpack_neighbors,
)

__all__ = ["CatalogIndex", "build_catalog", "load_catalog_records",
           "neighbor_topk", "union_vote", "unpack_neighbors"]
