"""Catalog serving: feature-intelligence request classes over the gateway
(the port's copy of the JAX package's ``catalog/serve.py``).

:class:`CatalogService` is the front door for the catalog's query
surface. It composes a built
:class:`~sparse_coding_tpu_torch.catalog.build.CatalogIndex` (the durable
stat arrays) with a
:class:`~sparse_coding_tpu_torch.serve.gateway.ServingGateway` whose
engines serve the catalog ops (``CATALOG_OPS`` — the ``neighbors`` top-k
similarity op and the 2505.16077 ``vote`` aggregation, serve/engine.py),
and maps each request class onto its SLO priority (serve/slo.py):

====================  ==========  =================================
request class         priority    backend op
====================  ==========  =================================
``feature.stats``     interactive (none — host index lookup)
``feature.neighbors`` interactive ``neighbors`` (seeded by feature)
``feature.search``    batch       ``neighbors`` (caller's vector)
``feature.union``     batch       ``vote`` (multi-dict stack)
====================  ==========  =================================

Dead features never appear in neighbor results: the engine's top-k runs
over the full feature axis (a static shape — captured once per bucket),
and the service filters hits through the index's dead mask (plus the
self-match) before returning. Diverged dicts never reach this layer at
all — the build drops them (``skip_diverged``), and serving stacks must
be loaded with the same filter.

Every query passes the ``catalog.query`` fault site before touching the
gateway, so the query path is drillable like any dispatch edge.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from sparse_coding_tpu_torch.catalog.build import CatalogIndex
from sparse_coding_tpu_torch.catalog.query import unpack_neighbors
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.serve.slo import BATCH, INTERACTIVE, PRIORITIES

register_fault_site("catalog.query",
                    "catalog query path — immediately before the index "
                    "lookup / gateway submit of one feature.* request "
                    "(catalog/serve.py)")

# request class -> (backend op or None for host-side, SLO priority)
REQUEST_CLASSES: dict[str, tuple[Optional[str], str]] = {
    "feature.stats": (None, INTERACTIVE),
    "feature.neighbors": ("neighbors", INTERACTIVE),
    "feature.search": ("neighbors", BATCH),
    "feature.union": ("vote", BATCH),
}


def request_priority(request_class: str) -> str:
    """SLO priority of one catalog request class (typed on unknowns so a
    misrouted class can never silently serve at the wrong priority)."""
    try:
        priority = REQUEST_CLASSES[request_class][1]
    except KeyError:
        raise ValueError(
            f"unknown catalog request class {request_class!r} "
            f"(supported: {sorted(REQUEST_CLASSES)})") from None
    assert priority in PRIORITIES
    return priority


class CatalogService:
    """Feature-intelligence queries over a built index + gateway pool.

    ``models[i]`` names the gateway registry entry serving catalog dict
    ``i`` — registered by the caller from the SAME artifact set the index
    was built from, with the SAME diverged filter (e.g.
    ``registry.load_native(pkl, select=lambda h: not h.get("diverged"))``),
    so index positions and serving entries line up. ``stack_model``
    optionally names a homogeneous stack entry for ``feature.union``.
    """

    def __init__(self, index: CatalogIndex, gateway,
                 models: Sequence[str], stack_model: Optional[str] = None,
                 deadline_s: Optional[float] = None):
        if len(models) != index.n_dicts:
            raise ValueError(
                f"{len(models)} serving models for {index.n_dicts} "
                "catalog dicts — the index and the registry must be "
                "loaded from the same artifact set with the same "
                "diverged filter")
        self.index = index
        self._gateway = gateway
        self._models = list(models)
        self._stack_model = stack_model
        self._deadline_s = deadline_s

    # -- host-side request class ---------------------------------------------

    def stats(self, dict_i: int, feature_id: int) -> dict:
        """``feature.stats``: one feature's durable stat row. Pure index
        lookup — no device work, interactive by construction."""
        fault_point("catalog.query")
        return self.index.feature_stats(dict_i, feature_id)

    # -- device-backed request classes ---------------------------------------

    def _submit_neighbors(self, dict_i: int, q: np.ndarray,
                          request_class: str):
        op, priority = REQUEST_CLASSES[request_class]
        fault_point("catalog.query")
        return self._gateway.query(
            self._models[dict_i], q, op=op, priority=priority,
            deadline_s=self._deadline_s)

    def _filter_hits(self, dict_i: int, vals: np.ndarray,
                     idx: np.ndarray, k: int,
                     exclude_feat: Optional[int]) -> list[dict]:
        dead = self.index.dead(dict_i)
        out = []
        for cos, f in zip(vals.tolist(), idx.tolist()):
            if f == exclude_feat or dead[f]:
                continue  # dead features are never neighbors
            out.append({"feature": int(f), "cos": float(cos)})
            if len(out) >= k:
                break
        return out

    def neighbors(self, dict_i: int, feature_id: int,
                  k: Optional[int] = None) -> list[dict]:
        """``feature.neighbors``: the nearest live decoder rows to one
        feature's own decoder row, served interactive. Returns up to
        ``k`` (default: the engine's compiled top-k minus the self-match)
        ``{"feature", "cos"}`` hits, dead features filtered out."""
        q = self.index.rows(dict_i)[int(feature_id)]
        packed = self._submit_neighbors(dict_i, q, "feature.neighbors")
        vals, idx = unpack_neighbors(packed)
        want = int(k) if k is not None else max(1, idx.shape[-1] - 1)
        return self._filter_hits(dict_i, vals, idx, want,
                                 exclude_feat=int(feature_id))

    def search(self, dict_i: int, x, k: Optional[int] = None) -> list[dict]:
        """``feature.search``: nearest live decoder rows to a CALLER
        activation/direction vector, served at batch priority (offline
        interp sweeps — latency-tolerant, throughput-bound)."""
        q = np.asarray(x, dtype=np.float32)
        packed = self._submit_neighbors(dict_i, q, "feature.search")
        vals, idx = unpack_neighbors(packed)
        want = int(k) if k is not None else idx.shape[-1]
        if q.ndim == 1:
            return self._filter_hits(dict_i, vals, idx, want,
                                     exclude_feat=None)
        return [self._filter_hits(dict_i, v, i, want, exclude_feat=None)
                for v, i in zip(vals, idx)]

    def union(self, x, quorum: int = 1) -> np.ndarray:
        """``feature.union``: the 2505.16077 union/vote aggregation — one
        batch encoded by every member of the serving stack, features kept
        when at least ``quorum`` members fire. Returns a bool mask
        [rows?, n_feats] (squeezed like the gateway contract)."""
        if self._stack_model is None:
            raise ValueError("no stack_model configured for feature.union")
        op, priority = REQUEST_CLASSES["feature.union"]
        fault_point("catalog.query")
        votes = self._gateway.query(
            self._stack_model, np.asarray(x, dtype=np.float32), op=op,
            priority=priority, deadline_s=self._deadline_s)
        return np.asarray(votes) >= quorum
