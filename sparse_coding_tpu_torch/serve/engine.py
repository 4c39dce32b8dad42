"""Shape-bucket serving engine on CUDA graphs (the port of the JAX
package's ``serve/engine.py``).

Online inference is request-driven: shapes arrive one ragged handful of
rows at a time, and launching each op's kernels per request would pay the
host's launch costs in the latency path. The engine removes that from
steady state:

- requests coalesce (serve/batching.py) into a small ladder of padded row
  buckets (default 8/64/512 — geometric, so padding waste is bounded at
  ~8x worst case on the smallest bucket and amortizes with load);
- each (model, op, bucket) program is captured as a CUDA graph at
  ``warmup()`` through ``xcache.cached_capture``: a static padded input
  [bucket, width], the graph's output tensors, and a pinned host staging
  buffer for each, every bucket's graph in ONE memory pool. A replay
  copies the request rows in, replays the graph and reads the rows back:
  one copy each way and one graph launch per coalesced batch. The
  capture runs on a side stream after one eager run of the op (cuBLAS
  handles, workspaces, lazy init), and captures go one at a time;
- the weights are the registry entry's tensors, read by the graph at
  their addresses, so one copy serves every bucket;
- a registry stack entry runs the op once per member over the member
  axis in one program (``vote`` takes the stack whole);
- every program prepared after warmup counts in the recompile counter
  (serve/metrics.py) — the invariant a healthy deployment asserts on:
  0 in steady state.

**Replay is serialized per program table.** A captured graph has static
buffers, and the programs of one :class:`ProgramCache` share one memory
pool (one graph's scratch may be another's output), so every replay —
copy-in through the host readback — holds the table's replay lock, and a
capture into the table holds it too. The gateway's replicas share one
table; without the lock two of them would corrupt each other's results.

On the CPU (``device="cpu"``) the same programs run the op eagerly on the
padded bucket. On a card a failed capture or replay raises; the engine
never quietly falls back to the eager op. JAX's buffer donation has no
torch meaning: ``donate`` is accepted and ignored. A mesh (``mesh=``)
raises: serving over a multi-process ``torch.distributed`` mesh needs a
rank-0 front door that broadcasts requests (ROADMAP.md queue 1, item 17).
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import obs, resolve_device, xcache
from sparse_coding_tpu_torch.obs import monotime
from sparse_coding_tpu_torch.resilience.breaker import CircuitBreaker
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.serve.batching import (
    CircuitOpenError,
    DispatchError,
    MicroBatcher,
    Request,
    RequestTooLargeError,
    ServeError,
    ServeFuture,
)
from sparse_coding_tpu_torch.serve.metrics import ServingMetrics
from sparse_coding_tpu_torch.serve.registry import ModelRegistry, RegistryEntry
from sparse_coding_tpu_torch.utils.trees import tree_index, tree_len

DEFAULT_BUCKETS = (8, 64, 512)
DEFAULT_OPS = ("encode", "decode", "topk")
# catalog query ops: captured, bucketed and warmed exactly like
# DEFAULT_OPS but opt-in per engine — the catalog serving surface builds
# its pool with ops=DEFAULT_OPS + CATALOG_OPS
CATALOG_OPS = ("neighbors", "vote")

register_fault_site("serve.dispatch",
                    "ServingEngine.run_padded — immediately before the "
                    "program's replay")

# transient dispatch failures (worth a retry / distinct from a poisoned
# request): the I/O family. Everything else fails the flush immediately.
TRANSIENT_DISPATCH_ERRORS = (OSError, TimeoutError, ConnectionError)


def bucket_op_fn(op: str, k: int | None = None) -> Callable:
    """The pure per-bucket program of one op, ``fn(ld, x)``. ``x`` is
    [bucket_rows, d] for encode/predict/topk/neighbors/vote and
    [bucket_rows, n_feats] for decode. ``topk`` returns (values, int32
    indices) in ``jax.lax.top_k``'s order (catalog/query.py ``top_k``)."""
    if op == "encode":
        return lambda ld, x: ld.encode(x)
    if op == "decode":
        return lambda ld, x: ld.decode(x)
    if op == "predict":
        return lambda ld, x: ld.predict(x)
    if op == "topk":
        if k is None or k < 1:
            raise ValueError("topk op needs k >= 1")
        from sparse_coding_tpu_torch.catalog.query import top_k

        def topk(ld, x):
            vals, idx = top_k(ld.encode(x), k)
            return vals, idx.to(torch.int32)

        return topk
    if op == "neighbors":
        if k is None or k < 1:
            raise ValueError("neighbors op needs k >= 1")
        from sparse_coding_tpu_torch.catalog.query import neighbor_topk

        return lambda ld, x: neighbor_topk(ld, x, k)
    if op == "vote":
        # the union/vote aggregation consumes the STACKED tree itself and
        # reduces the member axis (see build_bucket_program)
        from sparse_coding_tpu_torch.catalog.query import union_vote

        return union_vote
    raise ValueError(f"unknown serving op {op!r} (supported: encode, "
                     f"decode, predict, topk, neighbors, vote)")


def over_members(fn: Callable) -> Callable:
    """``fn`` over a stacked tree's member axis: each member's result,
    stacked on a new leading axis (tuples leaf by leaf) — the JAX
    package's ``vmap(fn, in_axes=(0, None))``."""

    def mapped(stack, x):
        outs = [fn(tree_index(stack, i), x) for i in range(tree_len(stack))]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(parts) for parts in zip(*outs))
        return torch.stack(outs)

    return mapped


def op_width(entry: RegistryEntry, op: str) -> int:
    """Input width of one op's program: the SINGLE home of the width rule,
    shared by submit-time validation and program capture."""
    return entry.n_feats if op == "decode" else entry.d_activation


def op_rows_axis(entry: RegistryEntry, op: str) -> int:
    """Rows axis of one op's host result tree: stack entries carry a
    leading member axis — EXCEPT the catalog ``vote`` op, which reduces
    it. Shared by the engine and gateway dispatch paths."""
    return 1 if (entry.is_stack and op != "vote") else 0


def _map_leaves(fn: Callable, tree):
    """``fn`` over a result tree: one array or tensor, or a tuple of
    them (topk's values and indices)."""
    if isinstance(tree, tuple):
        return tuple(fn(a) for a in tree)
    return fn(tree)


def _leaves(tree) -> tuple:
    return tree if isinstance(tree, tuple) else (tree,)


def prepare_request(entry: RegistryEntry, op: str, ops: Sequence[str],
                    buckets: Sequence[int], np_dtype,
                    x) -> tuple[np.ndarray, int, bool]:
    """Validate and canonicalize one request payload — the SINGLE home of
    the submit-time contract, shared by the engine and the gateway front
    door. Returns ``(arr, rows, squeeze)`` with ``arr`` always [rows,
    width]."""
    if op not in ops:
        raise ValueError(f"op {op!r} not served (engine ops: {tuple(ops)})")
    if op == "vote" and not entry.is_stack:
        raise ValueError(f"op 'vote' aggregates a multi-dict stack; "
                         f"{entry.name!r} is a single-dict entry")
    arr = np.asarray(x, dtype=np_dtype)
    squeeze = arr.ndim == 1
    if squeeze:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"request must be 1-D or 2-D, got shape "
                         f"{arr.shape}")
    width = op_width(entry, op)
    if arr.shape[1] != width:
        raise ValueError(
            f"{entry.name!r}/{op}: expected width {width}, got "
            f"{arr.shape[1]}")
    rows = arr.shape[0]
    if rows == 0:
        raise ValueError("empty request")
    if rows > buckets[-1]:
        raise RequestTooLargeError(rows, buckets[-1])
    return arr, rows, squeeze


def fanout_results(requests: list[Request], host, rows_axis: int,
                   on_latency=None) -> None:
    """Slice one dispatched batch's host result tree back to its requests
    (in queue order) and resolve their futures; shared by the engine and
    gateway dispatches. ``on_latency(request, seconds)`` fires per
    request before its future resolves."""
    now = monotime()
    ofs = 0
    for r in requests:
        sl = ((slice(None),) * rows_axis
              + (slice(ofs, ofs + r.rows),))
        res = _map_leaves(lambda a: a[sl], host)
        if r.squeeze:
            sq = (slice(None),) * rows_axis + (0,)
            res = _map_leaves(lambda a: a[sq], res)
        ofs += r.rows
        if on_latency is not None:
            on_latency(r, now - r.t_submit)
        r.future._set_result(res)


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Shape and dtype of a program's padded input."""

    shape: tuple
    dtype: torch.dtype


def build_bucket_program(entry: RegistryEntry, op: str, bucket: int,
                         dtype, topk_k: int) -> tuple[Callable, InputSpec]:
    """(fn, input spec) of one (entry, op, bucket) program — the exact
    function and shape the engine captures."""
    fn = bucket_op_fn(op, k=min(topk_k, entry.n_feats))
    if op == "vote":
        # union_vote consumes the stacked tree whole and reduces the
        # member axis — mapping it over the members would split the
        # stack before the vote can count across them
        if not entry.is_stack:
            raise ValueError(
                f"op 'vote' aggregates a multi-dict stack; register "
                f"{entry.name!r} via register_stack")
    elif entry.is_stack:
        fn = over_members(fn)
    return fn, InputSpec((int(bucket), op_width(entry, op)),
                         _torch_dtype(dtype))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class _Program:
    """One prepared (model, op, bucket) program and its staging buffers.
    ``__call__(x)`` runs it on [rows, width] host rows (zero-padded to
    the bucket) and returns the host result tree cut to ``rows``."""

    def __init__(self, captured: xcache.CapturedProgram,
                 static_in: torch.Tensor, rows_axis: int,
                 lock: threading.Lock, stream):
        self.captured = captured
        self.static_in = static_in
        self.rows_axis = rows_axis
        self.lock = lock
        self.stream = stream
        self.on_card = static_in.device.type == "cuda"
        if self.on_card:
            self.host_in = torch.empty(static_in.shape, dtype=static_in.dtype,
                                       pin_memory=True)
            self.host_out = _map_leaves(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True), captured.outputs)
        else:
            self.host_in = static_in
            self.host_out = None

    def host_bytes(self) -> int:
        if not self.on_card:
            return 0
        leaves = [self.host_in] + list(_leaves(self.host_out))
        return sum(t.numel() * t.element_size() for t in leaves)

    def __call__(self, x: np.ndarray) -> Any:
        rows = x.shape[0]
        sl = (slice(None),) * self.rows_axis + (slice(0, rows),)
        with self.lock:
            staged = self.host_in.numpy()
            staged[:rows] = x
            staged[rows:] = 0
            if not self.on_card:
                return _map_leaves(lambda t: t[sl].numpy().copy(),
                                   self.captured.replay())
            with torch.cuda.stream(self.stream):
                self.static_in.copy_(self.host_in, non_blocking=True)
                out = self.captured.replay()
                # the readback moves only the request rows: one copy, or
                # one per stack member (its rows are the second axis)
                for h, d in zip(_leaves(self.host_out), _leaves(out)):
                    if self.rows_axis == 0:
                        h[:rows].copy_(d[:rows], non_blocking=True)
                    else:
                        for i in range(d.shape[0]):
                            h[i, :rows].copy_(d[i, :rows], non_blocking=True)
            self.stream.synchronize()
            return _map_leaves(lambda t: t.numpy()[sl].copy(), self.host_out)


class ProgramCache:
    """Captured-program table, shareable between engines.

    Engines serving the SAME registry (a gateway's replica pool) prepare
    IDENTICAL (model, op, bucket) programs. Sharing one table means N
    replicas hold one captured graph per program instead of N, and a warm
    spare activates by table lookup with zero captures. The table owns
    the graphs' memory pool, the replay stream and the replay lock that
    every program of the table holds from copy-in to readback (captured
    graphs have static buffers and share the pool); per-key locks keep
    two engines from capturing one program twice."""

    def __init__(self):
        self.lock = threading.Lock()
        self.compiled: dict[tuple, _Program] = {}
        self.key_locks: dict[tuple, threading.Lock] = {}
        self.replay_lock = threading.Lock()
        self._pool = None
        self._stream = None

    def pool(self, device: torch.device):
        """The table's CUDA graph memory pool (None off the card)."""
        if device.type != "cuda":
            return None
        with self.lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            return self._pool

    def stream(self, device: torch.device):
        """The stream the table's programs are captured and replayed on
        (None off the card): their products use its cuBLAS workspace."""
        if device.type != "cuda":
            return None
        with self.lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            return self._stream

    def pinned_bytes(self) -> int:
        """Pinned host staging bytes of every program in the table."""
        with self.lock:
            programs = list(self.compiled.values())
        return sum(p.host_bytes() for p in programs)

    def pool_bytes(self) -> int | None:
        """Device bytes the graph pool holds (segments of the caching
        allocator tagged with the pool), None where the allocator's
        snapshot does not tag segments."""
        if self._pool is None:
            return 0
        total, tagged = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            tagged = True
            if tuple(pid) == tuple(self._pool):
                total += int(seg["total_size"])
        return total if tagged else None


class ServingEngine:
    """Request-driven feature extraction over a :class:`ModelRegistry`.

    ``submit`` enqueues and returns a :class:`ServeFuture`; ``query`` is
    the blocking convenience. ``warmup()`` captures every (model, op,
    bucket) program; after it returns, ``stats()["recompiles"]`` staying
    0 proves steady-state serving never captures. ``device=None`` means
    the card (raising without one); pass ``device="cpu"`` to serve on the
    CPU.
    """

    def __init__(self, registry: ModelRegistry,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 ops: Sequence[str] = DEFAULT_OPS,
                 topk_k: int = 16,
                 max_wait_ms: float = 2.0,
                 max_queue_rows: int = 8192,
                 donate: bool | None = None,
                 dtype=torch.float32,
                 latency_window: int = 4096,
                 breaker: CircuitBreaker | None = None,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0,
                 dispatch_retries: int = 2,
                 stream_retry_budget: int = 16,
                 retry_backoff_s: float = 0.002,
                 warmup_workers: int | None = None,
                 program_cache: ProgramCache | None = None,
                 perf_probe_every: int = obs.perf.DEFAULT_PROBE_EVERY,
                 mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "serving on a torch.distributed mesh needs a rank-0 front "
                "door that broadcasts requests to every rank; it waits for "
                "ROADMAP.md queue 1, item 17. Serve each card's registry "
                "with its own engine (mesh=None)")
        self._device = resolve_device(device)
        self._placed_trees: dict[str, Any] = {}
        self._registry = registry
        self._buckets = self._validate_buckets(buckets)
        # every ladder this engine has EVER served (construction + swaps):
        # their programs are in the shared ProgramCache, so an admitted
        # request a shrink-swap left above the active max falls back to a
        # known larger rung instead of being stranded
        self._known_buckets = self._buckets
        self._ops = tuple(ops)
        self._topk_k = int(topk_k)
        self._dtype = _torch_dtype(dtype)
        self._np_dtype = np.dtype(torch.empty((), dtype=self._dtype)
                                  .numpy().dtype)
        # kept for the JAX signature: donation has no torch meaning, and
        # captures run one at a time (they share the table's graph pool)
        del donate, warmup_workers
        self.metrics = ServingMetrics(latency_window=latency_window)
        # dispatch resilience: transient failures retry against a
        # per-stream budget (refilled on success); consecutive failures
        # trip the breaker, which sheds load at BOTH ends — submit refuses
        # new work, the worker fails queued flushes fast — until a
        # half-open probe heals it
        self._dispatch_retries = int(dispatch_retries)
        self._stream_retry_budget = int(stream_retry_budget)
        self._retry_backoff_s = float(retry_backoff_s)
        self._retry_tokens: dict[tuple, int] = {}
        self._retry_lock = threading.Lock()
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=breaker_threshold,
            reset_timeout_s=breaker_reset_s)
        self._breaker.set_on_transition(self.metrics.record_breaker_transition)
        self._programs = (program_cache if program_cache is not None
                          else ProgramCache())
        # device-time perf evidence (obs/perf.py): every Nth flush's
        # dispatch wall (already host-synced by the readback) lands as
        # serve.mfu + serve.device_step_s, on the PROCESS registry so a
        # replica pool's samples merge into one distribution
        self._perf_probe = obs.DeviceStepProbe(
            "serve", every=max(0, int(perf_probe_every)),
            device=self._device)
        self._warmed = False
        self._batcher = MicroBatcher(
            dispatch=self._dispatch,
            max_rows_per_batch=self._buckets[-1],
            max_wait_s=max_wait_ms / 1e3,
            max_queue_rows=max_queue_rows,
            metrics=self.metrics)

    # -- bucket ladder -------------------------------------------------------

    def _validate_buckets(self, buckets: Sequence[int]) -> tuple[int, ...]:
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be unique ascending: {buckets}")
        return tuple(int(b) for b in buckets)

    @property
    def buckets(self) -> tuple[int, ...]:
        """The ACTIVE bucket ladder (may differ from construction after
        a gateway ladder swap, serve/ladder.py)."""
        return self._buckets

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def program_cache(self) -> ProgramCache:
        return self._programs

    def set_buckets(self, buckets: Sequence[int]) -> None:
        """Atomically replace the active ladder (gateway ladder swap).
        The old rungs stay in the known set so already-admitted oversize
        work still finds a captured program; capture the NEW rungs first
        (:meth:`warm_buckets`) or steady state pays recompiles."""
        new = self._validate_buckets(buckets)
        self._known_buckets = tuple(sorted(set(self._known_buckets)
                                           | set(new)))
        self._buckets = new
        self._batcher.set_max_rows(new[-1])

    def _warm(self, todo: list[tuple], max_workers: int | None,
              **span_attrs) -> int:
        """Capture ``todo``'s programs one at a time (``max_workers`` is
        validated and ignored: captures share the table's graph pool)."""
        if max_workers is not None and int(max_workers) < 1:
            raise ValueError("max_workers must be >= 1")
        with obs.span("serve.warmup", programs=len(todo), workers=1,
                      **span_attrs):
            for key in todo:
                self._get_compiled(*key, count_miss=False)
        return len(todo)

    def _missing(self, names, ops, rungs) -> list[tuple]:
        return [(name, op, bucket)
                for name in names for op in ops for bucket in rungs
                if (name, op, bucket) not in self._programs.compiled
                # vote is stack-only: a mixed pool (single-dict catalog
                # entries + one stack) warms each entry's valid ops
                and (op != "vote" or self._registry.get(name).is_stack)]

    def warm_buckets(self, buckets: Sequence[int],
                     max_workers: int | None = None) -> int:
        """Capture every (model, op) program for the GIVEN rungs that the
        shared table lacks — the candidate-ladder pass of a ladder swap,
        so the subsequent :meth:`set_buckets` is a pure table flip.
        Returns the number of programs captured; does not change the
        active ladder."""
        rungs = self._validate_buckets(buckets)
        return self._warm(self._missing(self._registry.names(), self._ops,
                                        rungs), max_workers,
                          source="ladder")

    # -- lifecycle -----------------------------------------------------------

    def warmup(self, max_workers: int | None = None) -> int:
        """Capture every (model, op, bucket) program of the CURRENT
        registry contents the table lacks — the full set is ready BEFORE
        the engine admits traffic. Returns the number of programs
        captured. Idempotent; re-run after registering more models. With
        the warm cache enabled (``xcache.enable``) every program is
        recorded in the warmup manifest."""
        n = self._warm(self._missing(self._registry.names(), self._ops,
                                     self._buckets), max_workers)
        self._warmed = True
        return n

    def warmup_from_manifest(self, manifest=None,
                             max_workers: int | None = None) -> int:
        """Capture exactly the program set the warmup manifest records —
        how a restarted engine knows the full warm set before it admits
        traffic. ``manifest`` defaults to the active cache's;
        descriptors naming models/ops/buckets this engine does not serve
        are skipped. With no manifest (or none of its descriptors
        matching) this falls back to the full registry-product
        :meth:`warmup`. Returns the number of programs captured (0 for a
        spare whose pool already holds the set)."""
        if manifest is None:
            cache = xcache.active_cache()
            manifest = cache.warmup if cache is not None else None
        descs = manifest.descriptors(kind="serve") if manifest else []
        names = set(self._registry.names())
        matched = sorted({
            (d["model"], d["op"], int(d["bucket"]))
            for d in descs
            if (d.get("model") in names and d.get("op") in self._ops
                # known (not just active) rungs: after a shrink-swap a
                # spare may still be routed admitted old-ladder work
                and int(d.get("bucket", -1)) in self._known_buckets
                and (d.get("op") != "vote"
                     or self._registry.get(d["model"]).is_stack))})
        if not matched:
            return self.warmup(max_workers=max_workers)
        todo = [key for key in matched
                if key not in self._programs.compiled]
        n = self._warm(todo, max_workers, source="manifest")
        self._warmed = True
        return n

    def shutdown(self, wait: bool = True) -> None:
        self._batcher.shutdown(wait=wait)

    def pause(self) -> None:
        self._batcher.pause()

    def resume(self) -> None:
        self._batcher.resume()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- request path --------------------------------------------------------

    def submit(self, model: str, x, op: str = "encode") -> ServeFuture:
        """Enqueue one request. ``x`` is [rows, width] (or a single [width]
        row, returned un-batched); width is d_activation for
        encode/predict/topk/neighbors/vote and n_feats for decode. Raises
        :class:`QueueFullError` under backpressure and
        :class:`RequestTooLargeError` past the largest bucket."""
        entry = self._registry.get(model)
        if not self._breaker.admission_allowed():
            # graceful load shedding: while the circuit is open there is
            # no point queueing work behind a sick backend
            self.metrics.record_shed()
            raise CircuitOpenError((model, op),
                                   self._breaker.seconds_until_probe())
        arr, rows, squeeze = prepare_request(entry, op, self._ops,
                                             self._buckets, self._np_dtype,
                                             x)
        req = Request(key=(model, op), x=arr, rows=rows, squeeze=squeeze,
                      t_submit=monotime())
        return self._batcher.submit(req)

    def query(self, model: str, x, op: str = "encode",
              timeout: float | None = 60.0):
        """Blocking submit+result."""
        return self.submit(model, x, op=op).result(timeout=timeout)

    def topk(self, model: str, x, timeout: float | None = 60.0):
        """Top-k feature query: (values, indices) of the k strongest
        features per row (k fixed per engine at construction — it is a
        static shape of the captured programs)."""
        return self.query(model, x, op="topk", timeout=timeout)

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["warmed"] = self._warmed
        # the JAX schema's name: here, the captured programs in the table
        snap["compiled_programs"] = len(self._programs.compiled)
        snap["breaker"] = self._breaker.snapshot()
        return snap

    # -- captured-program table ----------------------------------------------

    def _op_width(self, entry: RegistryEntry, op: str) -> int:
        return op_width(entry, op)

    def _bucket_for(self, rows: int) -> int:
        buckets = self._buckets
        i = bisect.bisect_left(buckets, rows)
        if i < len(buckets):
            return buckets[i]
        # a shrink-swap may land while work admitted against the OLD
        # ladder is still queued — its old rungs stay in the shared table,
        # so cover from the known set rather than stranding admitted
        # requests. Fresh oversize submissions are still rejected against
        # the ACTIVE ladder (prepare_request).
        known = self._known_buckets
        j = bisect.bisect_left(known, rows)
        if j < len(known):
            return known[j]
        raise RequestTooLargeError(rows, buckets[-1])

    def _entry_tree(self, model: str):
        """The served tree of one entry, on the engine's device (placed
        once)."""
        tree = self._placed_trees.get(model)
        if tree is None:
            tree = self._registry.get(model).tree.to(self._device)
            self._placed_trees[model] = tree
        return tree

    def _compile(self, entry: RegistryEntry, op: str, bucket: int,
                 model: str) -> _Program:
        """Capture one program through ``xcache.cached_capture``; its
        descriptor goes into the warmup manifest, so a restarted process
        knows the warm set."""
        fn, spec = build_bucket_program(entry, op, bucket, self._dtype,
                                        self._topk_k)
        static_in = torch.zeros(spec.shape, dtype=spec.dtype,
                                device=self._device)
        desc = {"kind": "serve", "model": model, "op": op,
                "bucket": int(bucket), "dtype": self._np_dtype.name,
                "stack": bool(entry.is_stack)}
        programs = self._programs
        with programs.replay_lock:  # no replay of the pool mid-capture
            captured = xcache.cached_capture(
                fn, (self._entry_tree(model), static_in),
                label=f"serve/{model}/{op}/{bucket}", manifest_desc=desc,
                pool=programs.pool(self._device),
                stream=programs.stream(self._device))
        return _Program(captured, static_in, op_rows_axis(entry, op),
                        programs.replay_lock, programs.stream(self._device))

    def _get_compiled(self, model: str, op: str, bucket: int,
                      count_miss: bool = True) -> _Program:
        key = (model, op, bucket)
        programs = self._programs
        compiled = programs.compiled.get(key)
        if compiled is None:
            with programs.lock:
                compiled = programs.compiled.get(key)
                if compiled is not None:
                    return compiled
                lock = programs.key_locks.setdefault(key, threading.Lock())
            with lock:
                compiled = programs.compiled.get(key)
                if compiled is None:
                    if self._warmed and count_miss:
                        self.metrics.record_recompile(key)
                    compiled = self._compile(self._registry.get(model), op,
                                             bucket, model)
                    programs.compiled[key] = compiled
        return compiled

    # -- dispatch (runs on the batcher worker thread) ------------------------

    def run_padded(self, model: str, op: str, x: np.ndarray):
        """One coalesced batch through one program: [rows, w] zero-padded
        up to its bucket, one replay, results cut back to ``rows`` on the
        host. Shared by the online dispatch and the offline scorer;
        returns (bucket, numpy result tree)."""
        rows = x.shape[0]
        bucket = self._bucket_for(rows)
        program = self._get_compiled(model, op, bucket)
        # the readback host-syncs the replay, so its wall IS the device
        # wall: the probe needs no extra barrier, just the cadence check
        sample_perf = self._perf_probe.should_sample()
        if sample_perf:
            t_perf = monotime()
        fault_point("serve.dispatch")
        host = program(x)
        if sample_perf:
            from sparse_coding_tpu_torch.ops.roofline import serve_flush_plan

            entry = self._registry.get(model)
            plan = serve_flush_plan(op, bucket, entry.n_feats,
                                    entry.d_activation,
                                    n_stack=entry.n_stack or 1,
                                    itemsize=self._np_dtype.itemsize)
            # MFU numerator policy: model-REQUIRED flops — the real rows,
            # not the padded bucket, so an underfilled flush reads as LOW
            # utilization (the pad waste the bucket ladder must see)
            self._perf_probe.record(
                monotime() - t_perf,
                cost=obs.StepCost(flops=plan.flops * (rows / bucket),
                                  path=f"serve.{op}", activations=rows))
        return bucket, host

    def _take_retry_token(self, key: tuple) -> bool:
        with self._retry_lock:
            left = self._retry_tokens.get(key, self._stream_retry_budget)
            if left <= 0:
                return False
            self._retry_tokens[key] = left - 1
            return True

    def _refill_retry_budget(self, key: tuple) -> None:
        with self._retry_lock:
            self._retry_tokens[key] = self._stream_retry_budget

    def _fail_requests(self, requests: list[Request],
                       err: ServeError) -> None:
        self.metrics.record_request_errors(len(requests), type(err).__name__)
        for r in requests:
            if not r.future.done():
                r.future._set_error(err)

    def _dispatch(self, key: tuple, requests: list[Request],
                  deadline_flush: bool) -> int | None:
        """Returns rows served (the batcher's service-rate input), None
        for a shed or failed flush."""
        model, op = key
        # the admission token identifies THIS dispatch to the breaker: a
        # half-open probe's outcome is honored only when reported with
        # its own token, so a raced stale dispatch can't fake-heal it
        token = self._breaker.allow()
        if not token:
            self.metrics.record_shed(len(requests))
            self._fail_requests(requests, CircuitOpenError(
                key, self._breaker.seconds_until_probe()))
            return None
        rows = sum(r.rows for r in requests)
        if len(requests) == 1:
            x = requests[0].x
        else:
            x = np.concatenate([r.x for r in requests], axis=0)
        attempt = 0
        while True:
            try:
                bucket, host = self.run_padded(model, op, x)
                break
            except BaseException as e:  # noqa: BLE001 — typed fan-out
                transient = (isinstance(e, TRANSIENT_DISPATCH_ERRORS)
                             and not isinstance(e, ServeError))
                if (transient and attempt < self._dispatch_retries
                        and self._take_retry_token(key)):
                    attempt += 1
                    self.metrics.record_dispatch_retry()
                    time.sleep(self._retry_backoff_s * attempt)
                    continue
                self._breaker.record_failure(token)
                self.metrics.record_dispatch_failure()
                err = e if isinstance(e, ServeError) else DispatchError(key, e)
                self._fail_requests(requests, err)
                return None
        self._breaker.record_success(token)
        self._refill_retry_budget(key)
        self.metrics.record_batch(bucket, len(requests), rows,
                                  deadline_flush)
        rows_axis = op_rows_axis(self._registry.get(model), op)
        fanout_results(
            requests, host, rows_axis,
            on_latency=lambda r, lat: self.metrics.record_latency(bucket,
                                                                  lat))
        return rows
