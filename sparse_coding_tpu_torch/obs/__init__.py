"""Observability for the sweep (the port's subset of the JAX package's
``obs/``): typed instruments (:mod:`registry`), spans and correlated
events (:mod:`spans`), the crash-safe JSONL event sink (:mod:`sink`,
``SPARSE_CODING_OBS_DIR``) and the sampling device-time probe
(:mod:`perf`). Trace capture (``obs/trace.py``) and the run report are
not ported (ROADMAP queue 1, item 14)."""

from __future__ import annotations

from sparse_coding_tpu_torch.obs.perf import (
    DeviceStepProbe,
    StepCost,
    combine_costs,
)
from sparse_coding_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    set_registry,
)
from sparse_coding_tpu_torch.obs.sink import (
    ENV_OBS_DIR,
    EventSink,
    configure as configure_sink,
    read_events,
    scan_events,
)
from sparse_coding_tpu_torch.obs.spans import (
    emit_event,
    flush_metrics,
    mint_trace_id,
    monotime,
    record_span,
    span,
)


def counter(name: str, **labels) -> Counter:
    return get_registry().counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return get_registry().gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return get_registry().histogram(name, **labels)


__all__ = [
    "Counter", "DeviceStepProbe", "ENV_OBS_DIR", "EventSink", "Gauge",
    "Histogram", "Registry", "StepCost", "combine_costs", "configure_sink",
    "counter", "emit_event", "flush_metrics", "gauge", "get_registry",
    "histogram", "mint_trace_id", "monotime", "read_events", "record_span",
    "scan_events", "set_registry", "span",
]
