"""Feature catalog (the JAX package's ``catalog/``): the build of a
byte-deterministic per-feature index over sweep artifacts and a chunk
store (:mod:`build`), and the query ops on decoder rows and dict stacks
(:mod:`query`), and the serving half (:mod:`serve`: ``CatalogService``
and its request classes over the serving gateway)."""

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
from sparse_coding_tpu_torch.catalog.serve import (
    REQUEST_CLASSES,
    CatalogService,
    request_priority,
)

__all__ = ["REQUEST_CLASSES", "CatalogIndex", "CatalogService",
           "build_catalog", "load_catalog_records", "neighbor_topk",
           "request_priority", "union_vote", "unpack_neighbors"]
