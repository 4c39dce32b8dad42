"""Fault-tolerant async ingest: multi-stream chunk decode and the
host→device stage (the port's copy of the JAX package's
``data/ingest.py``).

:func:`chunk_stream` delivers chunks in order with up to ``streams``
decodes in flight on pool threads, each one ``store.load_chunk`` (digest,
finite check, bounded retry and the durable quarantine ledger all apply),
so the pipeline changes when chunks decode, never what arrives. Corrupt
chunks yield None in position. A stream worker that dies for another
reason (an injected ``ingest.decode`` error, a failing thread) degrades
the rest of the sequence to the foreground single-stream reader: the
epoch completes with identical data and ``ingest.degraded`` counts the
incident. A store without its own serial reader (the sharded store) gets
the generic foreground loop.

:func:`device_batches` (``data/chunk_store.py::device_prefetch`` is the
same function) is the host→device stage: pinned host buffers copied with
``non_blocking=True`` on a side CUDA stream, ``buffer_size`` copies in
flight, each behind fault site ``ingest.transfer`` under a bounded retry,
and one ``ingest.transfer`` span per drained stream with the batch count
and the host-side wait (staging and dispatch, not the copy on the wire).

The consumer beats the lease at every delivered chunk and every staged
batch, on the main thread, so a wedged decode or transfer stops the beats.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.resilience import lease
from sparse_coding_tpu_torch.resilience.errors import ChunkCorruptionError
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.resilience.retry import retry_io

logger = logging.getLogger(__name__)

register_fault_site("ingest.decode",
                    "async ingest stream decode — each background chunk "
                    "read (data/ingest.py chunk_stream), the decoded chunk "
                    "as payload; an injected error kills the stream and "
                    "forces the single-stream path, an injected nan or "
                    "corrupt payload must fail the finite gate")
register_fault_site("ingest.transfer",
                    "host->device batch transfer — inside device_batches' "
                    "bounded-retry scope (data/ingest.py)")


def default_streams(chunk_nbytes: Optional[int] = None) -> int:
    """Decode streams that pay: at most 4 and the usable cores, and —
    when the decoded chunk size is known — few enough that the
    ``streams + 2`` resident chunks fit in half the free host RAM."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:
        cpus = os.cpu_count() or 1
    n = max(1, min(4, cpus))
    if chunk_nbytes:
        try:
            avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError, AttributeError):
            avail = None
        if avail is not None:
            n = max(1, min(n, avail // (2 * int(chunk_nbytes)) - 2))
    return n


def _decoded_chunk_nbytes(store, indices, dtype) -> Optional[int]:
    """One decoded chunk's size from the first sound chunk's .npy header
    (no payload read); None when it cannot be had cheaply."""
    try:
        ci = next(i for i in indices if i not in store.quarantined)
        arr = np.load(store._path(ci), mmap_mode="r")
        itemsize = 2 if dtype is torch.bfloat16 else np.dtype(dtype).itemsize
        return int(np.prod(arr.shape)) * itemsize
    except Exception:
        return None


def _finite(chunk) -> bool:
    if isinstance(chunk, torch.Tensor):
        return bool(torch.isfinite(chunk).all())
    return bool(np.isfinite(chunk).all())


def _serial_chunks(store, indices, dtype) -> Iterator:
    """The foreground single-stream path, with an ``ingest.decode`` span
    per delivered chunk: the store's own serial reader where it has one,
    else a generic loop with the same contract (positional Nones, a lease
    beat per position)."""
    serial = getattr(store, "serial_chunk_reader", None)
    if serial is not None:
        it = serial(indices, dtype)
        for ci in indices:
            t0 = obs.monotime()
            chunk = next(it, None)
            if chunk is not None:
                obs.record_span("ingest.decode", obs.monotime() - t0,
                                chunk=int(ci), rows=int(chunk.shape[0]))
            yield chunk
        return
    for ci in indices:
        ci = int(ci)
        chunk = None
        if not (store.quarantine_corrupt and ci in store.quarantined):
            t0 = obs.monotime()
            try:
                chunk = store.load_chunk(ci, dtype)
            except ChunkCorruptionError as e:
                if not store.quarantine_corrupt:
                    raise
                store._quarantine(e)
            if chunk is not None:
                obs.record_span("ingest.decode", obs.monotime() - t0,
                                chunk=ci, rows=int(chunk.shape[0]))
        lease.beat()
        yield chunk


def chunk_stream(store, indices, dtype=np.float32,
                 streams: Optional[int] = None) -> Iterator:
    """In-RAM chunks for ``indices`` in order, up to ``streams`` decodes in
    flight and at most ``streams + 1`` decoded chunks resident beyond the
    one being consumed. ``streams`` None picks :func:`default_streams`;
    ``streams <= 1`` is the store's single-stream reader."""
    indices = [int(i) for i in indices]
    if streams is None:
        streams = default_streams(_decoded_chunk_nbytes(store, indices,
                                                        dtype))
    if streams <= 1 or not indices:
        yield from _serial_chunks(store, indices, dtype)
        return
    lookahead = int(streams) + 1

    def decode(ci: int):
        t0 = obs.monotime()
        chunk = store.load_chunk(ci, dtype)
        out = fault_point("ingest.decode", chunk)
        # a fired nan/corrupt fault returns a mutated copy, which must
        # re-pass the finite gate the store applied to the real bytes
        if out is not chunk and not _finite(out):
            raise ChunkCorruptionError(ci, store._path(ci),
                                       "non-finite values in decoded rows")
        return out, obs.monotime() - t0

    pool = ThreadPoolExecutor(max_workers=int(streams),
                              thread_name_prefix="ingest")
    pending: deque = deque()  # (chunk index, future | None), in order
    cursor = 0

    def refill() -> None:
        nonlocal cursor
        while cursor < len(indices) and len(pending) < lookahead:
            ci = indices[cursor]
            known_bad = store.quarantine_corrupt and ci in store.quarantined
            pending.append((ci, None if known_bad
                            else pool.submit(decode, ci)))
            cursor += 1

    def result(ci, fut):
        """The decoded chunk, or None for a corrupt one under
        quarantine_corrupt; any other failure propagates."""
        try:
            chunk, dur = fut.result()
        except ChunkCorruptionError as e:
            if not store.quarantine_corrupt:
                raise
            store._quarantine(e)
            return None
        obs.record_span("ingest.decode", dur, chunk=ci,
                        rows=int(chunk.shape[0]))
        return chunk

    try:
        refill()
        while pending:
            ci, fut = pending.popleft()
            try:
                chunk = None if fut is None else result(ci, fut)
            except ChunkCorruptionError:
                raise
            except Exception as e:
                # a stream worker died (not corruption): finish on the
                # foreground path — same chunks, same order, counted
                obs.counter("ingest.degraded").inc()
                logger.warning(
                    "ingest stream failed on chunk %d (%r); degrading to "
                    "the single-stream path for the remaining %d chunk(s)",
                    ci, e, 1 + len(pending) + len(indices) - cursor)
                pool.shutdown(wait=False, cancel_futures=True)
                rest = [ci] + [c for c, _ in pending] + indices[cursor:]
                pending.clear()
                yield from _serial_chunks(store, rest, dtype)
                return
            lease.beat()
            yield chunk
            chunk = None  # drop before refilling: the RAM bound
            refill()
    finally:
        # an early exit must not leave decodes working for nobody
        pool.shutdown(wait=False, cancel_futures=True)


def _host_tensor(b) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b.contiguous()
    return torch.from_numpy(np.ascontiguousarray(b))


def device_batches(batches: Iterable, device,
                   buffer_size: int = 2) -> Iterator[torch.Tensor]:
    """Host → device stage: batch i+1 is copied while batch i computes.
    On CUDA each batch is staged in pinned host memory and copied with
    ``non_blocking=True`` on a side stream, up to ``buffer_size`` copies
    in flight; the consumer's stream waits on the copy's event before it
    sees the tensor. On the CPU the batches pass as tensors. Every
    transfer sits behind fault site ``ingest.transfer`` with a bounded
    retry, every staged batch beats the lease, and one ``ingest.transfer``
    span per drained stream records the batch count and the host-side
    wait."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    stage = {"batches": 0, "wait_s": 0.0}

    def put(b):
        t0 = obs.monotime()
        host = _host_tensor(b)

        def _put_once():
            fault_point("ingest.transfer")
            if side is None:
                return host.to(device), None
            pinned = host.pin_memory()
            with torch.cuda.stream(side):
                dev = pinned.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            return dev, done

        out = retry_io(_put_once, attempts=3)
        stage["wait_s"] += obs.monotime() - t0
        stage["batches"] += 1
        lease.beat()
        return out

    pending: deque = deque()
    it = iter(batches)
    try:
        for b in it:
            pending.append(put(b))
            if len(pending) >= buffer_size:
                break
        while pending:
            dev, done = pending.popleft()
            if done is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(done)
                dev.record_stream(compute)
            nxt = next(it, None)
            if nxt is not None:
                pending.append(put(nxt))
            yield dev
    finally:
        if stage["batches"]:
            obs.record_span("ingest.transfer", stage["wait_s"],
                            batches=stage["batches"])
