"""Device-time performance evidence: sampled MFU (the port's copy of the
JAX package's ``obs/perf.py``).

:class:`DeviceStepProbe` samples every ``every``-th training window: the
host synchronizes the card, dispatches the window, synchronizes again and
records the wall (a sync, not CUDA events: the window's work spans many
launches and the host), so the windows between samples stay pipelined.
Each sample lands as

- ``<prefix>.device_step_s{path=...}`` histograms: device wall per step;
- ``<prefix>.mfu`` and ``<prefix>.mfu{backend=,path=}`` gauges:
  model-flops utilization, the shared FLOP model
  (``ops/roofline.py::model_flops_per_activation``) over the card's fp32
  peak outside the tensor cores (:data:`GPU_PEAK_FP32_FLOPS`, by
  ``torch.cuda.get_device_name()``; the kernels run true fp32).

Off the card the probe records host walls against the H100 SXM reference
peak under ``backend=cpu``: a reference number, not a utilization.

:class:`StepCost` says what one measured step was worth; hosts build it
(``Ensemble.step_cost``) so the probe stays shape-agnostic. The port has
no Hopper roofline model yet, so no predicted time rides along and no
roofline gap is recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from sparse_coding_tpu_torch.obs.registry import get_registry
from sparse_coding_tpu_torch.obs.spans import emit_event

# fp32 peak outside the tensor cores, FLOP/s, by device-name tag (NVIDIA
# H100 data sheet: SXM5 67 TFLOP/s, PCIe 51, NVL 60); the SXM figure is
# the reference off the card
GPU_PEAK_FP32_FLOPS = {
    "H100 80GB HBM3": 67e12, "H100 SXM": 67e12,
    "H100 PCIe": 51e12, "H100 NVL": 60e12,
}
REFERENCE_PEAK_FLOPS = 67e12

DEFAULT_PROBE_EVERY = 32


def device_peak_flops(device=None) -> Optional[float]:
    """fp32 peak of the card ``device`` names (None when its name matches
    no known card, or it is not a CUDA device)."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for tag, peak in sorted(GPU_PEAK_FP32_FLOPS.items(),
                            key=lambda kv: -len(kv[0])):
        if tag in name:
            return peak
    return None


@dataclasses.dataclass(frozen=True)
class StepCost:
    """What one measured step was worth: ``flops`` is the MFU numerator
    (model-required flops, never the executed count), ``path`` the
    resolved kernel path."""

    flops: float = 0.0
    path: str = "autodiff"
    activations: int = 0


def combine_costs(costs: Sequence[StepCost]) -> StepCost:
    """The costs of one window's ensembles together (flops add; buckets on
    different paths make the label ``mixed``)."""
    costs = [c for c in costs if c is not None]
    if not costs:
        return StepCost()
    paths = {c.path for c in costs}
    return StepCost(flops=sum(c.flops for c in costs),
                    path=paths.pop() if len(paths) == 1 else "mixed",
                    activations=sum(c.activations for c in costs))


def synchronize(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeviceStepProbe:
    """Sampling device-time probe for one stream of windows on ``device``.
    Call :meth:`should_sample` once per window; on the cadence the host
    synchronizes, runs the window, synchronizes again and calls
    :meth:`record`. ``every=0`` disables sampling."""

    # the first windows carry first-call costs (kernel loads, the caching
    # allocator's growth) and are never sampled
    WARMUP = 2

    def __init__(self, prefix: str, every: int = DEFAULT_PROBE_EVERY,
                 device="cuda"):
        import torch

        self.prefix = prefix
        self.every = max(0, int(every))
        self.backend = torch.device(device).type
        self.peak = device_peak_flops(device) or REFERENCE_PEAK_FLOPS
        self._count = 0

    def should_sample(self) -> bool:
        """True every ``every``-th call past the warmup, the first one at
        once."""
        if self.every == 0:
            return False
        self._count += 1
        if self._count <= self.WARMUP:
            return False
        return (self._count - self.WARMUP - 1) % self.every == 0

    def record(self, device_s: float, cost: Optional[StepCost] = None,
               steps: int = 1) -> None:
        """Fold one measured wall of ``steps`` steps into the per-path
        ``device_step_s`` histogram and the ``mfu`` gauges."""
        reg = get_registry()
        per_step_s = device_s / max(1, int(steps))
        path = (cost.path if cost is not None else "") or "autodiff"
        reg.histogram(f"{self.prefix}.device_step_s",
                      path=path).observe(per_step_s)
        reg.counter("perf.samples", stream=self.prefix).inc()
        mfu = None
        if cost is not None and cost.flops > 0 and device_s > 0:
            mfu = cost.flops / per_step_s / self.peak
            reg.gauge(f"{self.prefix}.mfu").set(mfu)
            reg.gauge(f"{self.prefix}.mfu", backend=self.backend,
                      path=path).set(mfu)
        emit_event("perf.sample", stream=self.prefix, path=path,
                   backend=self.backend, steps=int(steps),
                   device_s=round(device_s, 6),
                   **({"mfu": round(mfu, 4)} if mfu is not None else {}))
