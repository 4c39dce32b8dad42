"""Feature-extraction serving (the port of the JAX package's ``serve/``):
a low-latency online service plus a high-throughput offline scorer over
trained LearnedDict artifacts, on the card.

- :mod:`registry`  — named model store; loads native ``learned_dicts.pkl``
  and reference ``learned_dicts.pt`` artifacts onto its device, audits
  signatures, stacks homogeneous dicts for the multi-dict path.
- :mod:`engine`    — padded shape-bucket programs, each (model, op,
  bucket) captured as a CUDA graph at warmup through
  ``xcache.cached_capture`` and recorded in the warmup manifest; steady
  state never captures.
- :mod:`batching`  — dynamic micro-batching queue: coalesce, deadline
  flush, backpressure.
- :mod:`metrics`   — per-bucket counters, fill ratios, latency quantiles,
  recompile counter (captures after warmup: must stay 0).
- :mod:`offline`   — batch scorer reusing the same captured buckets.

Dispatch is hardened: typed per-request errors, a per-stream retry budget
for transient failures, and a circuit breaker
(``resilience.CircuitBreaker``) that sheds load while the backend is
sick, all drillable through the ``serve.dispatch`` fault site.

Above the single engine sits the **self-healing gateway**:

- :mod:`gateway`   — replica pools with per-replica breakers, health-
  weighted routing + failover, p95-triggered request hedging, warm-spare
  activation at zero captures through the pool's shared program table.
- :mod:`health`    — EWMA replica health scores.
- :mod:`slo`       — priority classes, brownout admission ladder, and
  the closed-loop p99 controller.
- :mod:`ladder`    — traffic-derived bucket ladders.
"""

import importlib

# Attributes resolve LAZILY (PEP 562), as in the JAX package: importing
# `sparse_coding_tpu_torch.serve` (or slo/batching/metrics/ladder) loads
# no torch model code; the engine/gateway submodules load on first use.
_LAZY_ATTRS = {
    "CircuitBreaker": ("sparse_coding_tpu_torch.resilience.breaker",
                       "CircuitBreaker"),
    "CircuitOpenError": ("sparse_coding_tpu_torch.serve.batching",
                         "CircuitOpenError"),
    "DispatchError": ("sparse_coding_tpu_torch.serve.batching", "DispatchError"),
    "QueueFullError": ("sparse_coding_tpu_torch.serve.batching", "QueueFullError"),
    "RequestTooLargeError": ("sparse_coding_tpu_torch.serve.batching",
                             "RequestTooLargeError"),
    "ServeError": ("sparse_coding_tpu_torch.serve.batching", "ServeError"),
    "ServeFuture": ("sparse_coding_tpu_torch.serve.batching", "ServeFuture"),
    "ServingEngine": ("sparse_coding_tpu_torch.serve.engine", "ServingEngine"),
    "CATALOG_OPS": ("sparse_coding_tpu_torch.serve.engine", "CATALOG_OPS"),
    "DEFAULT_OPS": ("sparse_coding_tpu_torch.serve.engine", "DEFAULT_OPS"),
    "bucket_op_fn": ("sparse_coding_tpu_torch.serve.engine", "bucket_op_fn"),
    "build_bucket_program": ("sparse_coding_tpu_torch.serve.engine",
                             "build_bucket_program"),
    "op_rows_axis": ("sparse_coding_tpu_torch.serve.engine", "op_rows_axis"),
    "Replica": ("sparse_coding_tpu_torch.serve.gateway", "Replica"),
    "ServingGateway": ("sparse_coding_tpu_torch.serve.gateway", "ServingGateway"),
    "EwmaHealth": ("sparse_coding_tpu_torch.serve.health", "EwmaHealth"),
    # ladder derivation is host-only: importing these never pulls the
    # engine/gateway modules
    "STATIC_LADDER": ("sparse_coding_tpu_torch.serve.ladder", "STATIC_LADDER"),
    "LadderError": ("sparse_coding_tpu_torch.serve.ladder", "LadderError"),
    "derive_ladder": ("sparse_coding_tpu_torch.serve.ladder", "derive_ladder"),
    "ladder_pad_rows": ("sparse_coding_tpu_torch.serve.ladder",
                        "ladder_pad_rows"),
    "ladder_to_json": ("sparse_coding_tpu_torch.serve.ladder", "ladder_to_json"),
    "parse_snapshot": ("sparse_coding_tpu_torch.serve.ladder", "parse_snapshot"),
    "pinned_ladder": ("sparse_coding_tpu_torch.serve.ladder", "pinned_ladder"),
    "snapshot_bytes": ("sparse_coding_tpu_torch.serve.ladder", "snapshot_bytes"),
    "traffic_snapshot": ("sparse_coding_tpu_torch.serve.ladder",
                         "traffic_snapshot"),
    "ServingMetrics": ("sparse_coding_tpu_torch.serve.metrics", "ServingMetrics"),
    "score_offline": ("sparse_coding_tpu_torch.serve.offline", "score_offline"),
    "ModelRegistry": ("sparse_coding_tpu_torch.serve.registry", "ModelRegistry"),
    "RegistryEntry": ("sparse_coding_tpu_torch.serve.registry", "RegistryEntry"),
    "BATCH": ("sparse_coding_tpu_torch.serve.slo", "BATCH"),
    "INTERACTIVE": ("sparse_coding_tpu_torch.serve.slo", "INTERACTIVE"),
    "PRIORITIES": ("sparse_coding_tpu_torch.serve.slo", "PRIORITIES"),
    "SCAVENGER": ("sparse_coding_tpu_torch.serve.slo", "SCAVENGER"),
    "AdmissionController": ("sparse_coding_tpu_torch.serve.slo",
                            "AdmissionController"),
}


def __getattr__(name):
    if name in _LAZY_ATTRS:
        module, attr = _LAZY_ATTRS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'sparse_coding_tpu_torch.serve' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_ATTRS))

__all__ = [
    "AdmissionController",
    "BATCH",
    "CATALOG_OPS",
    "CircuitBreaker",
    "DEFAULT_OPS",
    "CircuitOpenError",
    "DispatchError",
    "EwmaHealth",
    "INTERACTIVE",
    "LadderError",
    "ModelRegistry",
    "PRIORITIES",
    "RegistryEntry",
    "Replica",
    "SCAVENGER",
    "STATIC_LADDER",
    "ServingEngine",
    "ServingGateway",
    "ServingMetrics",
    "ServeError",
    "ServeFuture",
    "QueueFullError",
    "RequestTooLargeError",
    "bucket_op_fn",
    "build_bucket_program",
    "derive_ladder",
    "ladder_pad_rows",
    "ladder_to_json",
    "op_rows_axis",
    "parse_snapshot",
    "pinned_ladder",
    "score_offline",
    "snapshot_bytes",
    "traffic_snapshot",
]
