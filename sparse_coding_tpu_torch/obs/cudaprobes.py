"""Device probes for the card (the port's counterpart of the JAX package's
``obs/jaxprobes.py``; named for what it probes).

The JAX package counts XLA's retraces and compiles through
``jax.monitoring`` hooks. The port runs no XLA: what it prepares instead
is counted where it happens, so there is no hook to install (the JAX
package's ``install_jax_probes``); :func:`update_memory_gauges` lands
those counts and the card's memory in the obs registry at step
boundaries:

- ``build.nvcc_runs``: the ``nvcc`` processes this process started to
  build the kernel libraries (``ops/_build.py::NVCC_RUNS``; 0 when the
  libraries were built already);
- ``kernel.launches{kernel=<name>}``: each kernel's launch count
  (``ops/_build.py::LAUNCHES``), so a run report shows which kernels a
  step child launched, and how often;
- ``xcache.captures``: CUDA-graph captures, counted by
  ``xcache.cached_capture`` itself;
- ``cuda.mem.<stat>{device=i}`` gauges: ``bytes_in_use``,
  ``peak_bytes_in_use`` (``torch.cuda.memory_stats``) and ``bytes_limit``
  / ``bytes_free`` (``torch.cuda.mem_get_info``) of every card this
  process allocated on — a process that never touched the card reports
  none, and asking initializes nothing: ``mem_get_info`` would create a
  context on a card the process has none on, so the cards are picked by
  the caching allocator's own counts first.
"""

from __future__ import annotations

from typing import Optional

from sparse_coding_tpu_torch.obs.registry import Registry, get_registry

_nvcc_published = 0
_launches_published: dict[str, int] = {}


def publish_build_counts(registry: Optional[Registry] = None) -> int:
    """Add the nvcc runs since the last call to ``build.nvcc_runs``;
    returns the process's total."""
    global _nvcc_published
    from sparse_coding_tpu_torch.ops import _build

    reg = registry if registry is not None else get_registry()
    total = int(_build.NVCC_RUNS)
    if total > _nvcc_published:
        reg.counter("build.nvcc_runs").inc(total - _nvcc_published)
        _nvcc_published = total
    return total


def publish_launches(registry: Optional[Registry] = None) -> dict:
    """Add each kernel's launches since the last call to
    ``kernel.launches{kernel=<name>}``; returns the process's totals."""
    from sparse_coding_tpu_torch.ops import _build

    reg = registry if registry is not None else get_registry()
    totals = {k: int(v) for k, v in _build.LAUNCHES.items() if v}
    for name, total in totals.items():
        done = _launches_published.get(name, 0)
        # a reset_launches() since the last call starts the count anew
        new = total - done if total >= done else total
        if new > 0:
            reg.counter("kernel.launches", kernel=name).inc(new)
            _launches_published[name] = total
    return totals


def update_memory_gauges(registry: Optional[Registry] = None) -> int:
    """Publish the build and launch counts, then sample the memory of
    every card this process allocated on into gauges; returns how many
    reported (0 on the CPU, and in a process that never touched the card:
    the sample never initializes CUDA, nor a context on another card)."""
    import torch

    reg = registry if registry is not None else get_registry()
    publish_build_counts(reg)
    publish_launches(reg)
    if not torch.cuda.is_initialized():
        return 0
    n = 0
    for i in range(torch.cuda.device_count()):
        # the allocator's counts need no context; a card it never
        # allocated on is one this process did not use
        stats = torch.cuda.memory_stats(i)
        if not stats.get("allocated_bytes.all.peak", 0):
            continue
        free, total = torch.cuda.mem_get_info(i)
        n += 1
        reg.gauge("cuda.mem.bytes_in_use", device=i).set(
            stats.get("allocated_bytes.all.current", 0))
        reg.gauge("cuda.mem.peak_bytes_in_use", device=i).set(
            stats.get("allocated_bytes.all.peak", 0))
        reg.gauge("cuda.mem.bytes_limit", device=i).set(total)
        reg.gauge("cuda.mem.bytes_free", device=i).set(free)
    return n
