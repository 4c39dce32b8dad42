"""Observability (the port's counterpart of the JAX package's ``obs/``):
typed instruments (:mod:`registry`), spans and correlated events
(:mod:`spans`), the crash-safe JSONL event sink (:mod:`sink`,
``SPARSE_CODING_OBS_DIR``), the sampling device-time probe (:mod:`perf`),
the managed Kineto profiler capture (:mod:`trace`), the card's probes
(:mod:`cudaprobes`, in place of ``jaxprobes``), the run report
(:mod:`report`, ``python -m sparse_coding_tpu_torch.obs.report``) and
the durable perf ledger (:mod:`ledger`).

This package never initializes CUDA: the report CLI runs on a host whose
card is wedged, and the supervisor imports it."""

from __future__ import annotations

from typing import Optional

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
    active_sink,
    close as close_sink,
    configure as configure_sink,
    configure_from_env as configure_sink_from_env,
    read_events,
    scan_events,
)
from sparse_coding_tpu_torch.obs.spans import (
    ENV_RUN_ID,
    ENV_STEP,
    emit_event,
    flush_metrics,
    mint_trace_id,
    monotime,
    record_span,
    span,
)
from sparse_coding_tpu_torch.obs import ledger, trace
from sparse_coding_tpu_torch.obs.trace import TraceCapture


def counter(name: str, **labels) -> Counter:
    return get_registry().counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return get_registry().gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return get_registry().histogram(name, **labels)


def update_memory_gauges(registry: Optional[Registry] = None) -> int:
    """The nvcc and kernel-launch counts and the card's memory gauges,
    published now (:func:`cudaprobes.update_memory_gauges`)."""
    from sparse_coding_tpu_torch.obs import cudaprobes

    return cudaprobes.update_memory_gauges(registry)


__all__ = [
    "Counter", "DeviceStepProbe", "ENV_OBS_DIR", "ENV_RUN_ID", "ENV_STEP",
    "EventSink", "Gauge", "Histogram", "Registry", "StepCost",
    "TraceCapture", "active_sink", "close_sink", "combine_costs",
    "configure_sink", "configure_sink_from_env", "counter", "emit_event",
    "flush_metrics", "gauge", "get_registry", "histogram",
    "ledger", "mint_trace_id", "monotime",
    "read_events", "record_span", "scan_events", "set_registry", "span",
    "trace", "update_memory_gauges",
]
