"""Warm start for serving programs: the warmup manifest and the capture
front (the port's counterpart of the JAX package's ``xcache/``).

The JAX package caches compiled XLA executables on disk, so a restarted
process loads its program set instead of compiling it. A CUDA graph
cannot outlive its process — it holds raw device addresses — so a torch
serving program has no bytes to store, and ``xcache/store.py`` has no
port. A restart here is:

- the **warmup manifest** (xcache/manifest.py): the durable record of
  every program a process captured. A restarted serving engine captures
  exactly that set (``ServingEngine.warmup_from_manifest``) before it
  admits traffic; a capture takes milliseconds where an XLA compile took
  seconds;
- the **kernel libraries** loaded from ``ops/_build/<build key>/`` with no
  ``nvcc`` run (:func:`load_kernel_libraries`).

:func:`cached_capture` is the one place a program is prepared: it records
the descriptor in the manifest, captures ``fn(*args)`` as a CUDA graph
when ``args`` live on a card (on the CPU, where nothing can be captured,
the program runs eagerly), and counts ``xcache.captures`` with an
``xcache.capture_s`` histogram. :func:`program_key` names a program by its
descriptor and the environment it was captured in.

Should ``torch.compile`` ever enter a serving or sweep path, its compiled
artifacts are what this package would store, and the JAX sweep's warm
start (``train/sweep.py``) would return with it.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch

from sparse_coding_tpu_torch.obs import get_registry, monotime, span
from sparse_coding_tpu_torch.utils.trees import _leaves
from sparse_coding_tpu_torch.xcache.manifest import WarmupManifest

ENV_DIR = "SPARSE_CODING_XCACHE_DIR"

# captures go one at a time: the serving programs share one graph memory
# pool, and two captures into one pool must not interleave
_capture_lock = threading.Lock()


class XCache:
    """One enabled cache: a directory and its warmup manifest."""

    def __init__(self, cache_dir: str | Path):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.warmup = WarmupManifest(self.cache_dir / "warmup.json")


_active: Optional[XCache] = None
_lock = threading.Lock()


def default_cache_dir() -> Path:
    """``SPARSE_CODING_XCACHE_DIR``, else the user cache dir."""
    env = os.environ.get(ENV_DIR, "").strip()
    if env:
        return Path(env)
    base = os.environ.get("XDG_CACHE_HOME", "").strip() or str(
        Path.home() / ".cache")
    return Path(base) / "sparse_coding_tpu_torch" / "xcache"


def enable(cache_dir: str | Path | None = None) -> XCache:
    """Turn the cache on for this process (idempotent per dir): from now
    on every :func:`cached_capture` with a descriptor records it in
    ``<cache_dir>/warmup.json``."""
    global _active
    cache_dir = Path(cache_dir) if cache_dir is not None \
        else default_cache_dir()
    with _lock:
        if _active is None or _active.cache_dir != cache_dir:
            _active = XCache(cache_dir)
        return _active


def enable_from_env() -> Optional[XCache]:
    """Enable iff ``SPARSE_CODING_XCACHE_DIR`` is set; None otherwise."""
    env = os.environ.get(ENV_DIR, "").strip()
    if not env:
        return None
    return enable(env)


def disable() -> None:
    """Drop the active cache (tests; a serving process enables once)."""
    global _active
    with _lock:
        _active = None


def enabled() -> bool:
    return _active is not None


def active_cache() -> Optional[XCache]:
    return _active


@functools.lru_cache(maxsize=None)
def _env_fingerprint() -> str:
    """Everything outside the descriptor that changes what a program
    runs: torch and CUDA versions, the card's name and count, and the
    kernel sources' build key."""
    from sparse_coding_tpu_torch.ops import _build

    cuda = torch.cuda.is_available()
    names = sorted({torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())}) if cuda \
        else ["cpu"]
    return "|".join([torch.__version__, str(torch.version.cuda),
                     ",".join(names),
                     str(torch.cuda.device_count() if cuda else 0),
                     _build.build_key()])


def program_key(desc: dict, extra: Any = None) -> str:
    """sha256 over a program's descriptor (canonical JSON), the
    environment fingerprint and the caller's extra salt."""
    h = hashlib.sha256()
    h.update(json.dumps(desc, sort_keys=True, default=str).encode())
    h.update(_env_fingerprint().encode())
    if extra is not None:
        h.update(repr(extra).encode())
    return h.hexdigest()


class CapturedProgram:
    """``fn(*args)`` prepared for replay on the memory of ``args``:
    :meth:`replay` reruns it and returns ``outputs``. On a card it is a
    CUDA graph (the outputs are the graph's static tensors, rewritten by
    each replay); on the CPU it runs ``fn`` eagerly each time. ``key`` is
    its :func:`program_key`."""

    def __init__(self, fn: Callable, args: Sequence, key: str,
                 graph: Optional[torch.cuda.CUDAGraph], outputs: Any):
        self.fn = fn
        self.args = tuple(args)
        self.key = key
        self.graph = graph
        self.outputs = outputs

    def replay(self) -> Any:
        if self.graph is None:
            with torch.no_grad():
                self.outputs = self.fn(*self.args)
        else:
            self.graph.replay()
        return self.outputs


def _capture_cuda(fn: Callable, args: Sequence, pool, stream, device):
    """One eager run on the side stream (cuBLAS handles, workspaces and
    lazy init done outside the capture), then the capture on that
    stream. ``thread_local`` capture mode leaves other threads' unrelated
    work (another pool's replays) legal while this thread captures."""
    if stream is None:
        stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn(*args)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        outputs = fn(*args)
    stream.synchronize()
    return graph, outputs


def cached_capture(fn: Callable, args: Sequence, *, key: Any = None,
                   label: str = "", manifest_desc: Optional[dict] = None,
                   pool=None, stream=None) -> CapturedProgram:
    """Prepare ``fn(*args)`` for replay. ``args`` are the program's
    static inputs (their memory is what every replay reads); ``pool`` is
    the CUDA graph memory pool to capture into (shared by the programs of
    one serving table) and ``stream`` the side stream to capture on —
    replay on the same stream, whose cuBLAS workspace the captured
    products use (None: a new stream). On a card a failed capture raises — the program
    never quietly runs eagerly. ``manifest_desc`` (a JSON dict) records
    the program in the active cache's warmup manifest."""
    cache = _active
    if manifest_desc is not None and cache is not None:
        cache.warmup.record(manifest_desc)
    pkey = program_key(manifest_desc if manifest_desc is not None
                       else {"label": label}, extra=key)
    tensors = _leaves(list(args))
    device = tensors[0].device if tensors else torch.device("cpu")
    reg = get_registry()
    with _capture_lock, torch.no_grad(), span(
            "xcache.capture", label=label, key=pkey, device=device.type):
        t0 = monotime()
        if device.type == "cuda":
            graph, outputs = _capture_cuda(fn, args, pool, stream, device)
        else:
            graph, outputs = None, fn(*args)
        dt = monotime() - t0
    reg.counter("xcache.captures").inc()
    reg.histogram("xcache.capture_s").observe(dt)
    return CapturedProgram(fn, args, pkey, graph, outputs)


def load_kernel_libraries() -> int:
    """Load every kernel library of this checkout's build key (building
    only what is missing); returns the ``nvcc`` runs that took. A warm
    restart returns 0: the libraries load from ``ops/_build/``."""
    from sparse_coding_tpu_torch.ops import _build

    before = _build.NVCC_RUNS
    for name in _build.KERNELS:
        _build.library(name)
    return _build.NVCC_RUNS - before


__all__ = [
    "ENV_DIR",
    "CapturedProgram",
    "WarmupManifest",
    "XCache",
    "active_cache",
    "cached_capture",
    "default_cache_dir",
    "disable",
    "enable",
    "enable_from_env",
    "enabled",
    "load_kernel_libraries",
    "program_key",
]
