"""Asynchronous checkpoints for one host: the backend the sweep selects
with ``checkpoint_backend="orbax"`` (the port's counterpart of the JAX
package's ``utils/orbax_ckpt.py``; the module keeps that name so a reader
finds its counterpart).

It uses no orbax: orbax is not on the card's host, and one host needs
none of its per-host sharding (ROADMAP.md queue 1, item 11). It keeps the
contract the sweep's deferred swap rests on:

- ``save`` returns once the ensemble's state is snapshotted into host
  memory (pinned buffers on the card); training goes on at once;
- the sha256, the write and the fsync run on a worker thread, one per
  target path: saves to different ensembles overlap, a save to the same
  path waits for the one before it;
- ``wait()`` blocks until every pending write is durable. A worker's
  exception — the ``ckpt.save`` fault site included — is raised again,
  typed and unchanged, from ``wait()`` or ``close()`` on the caller's
  thread; it is never swallowed.

On disk it writes exactly what the msgpack backend writes
(``utils/checkpoint.py``: the ``.tensors`` payload and its
``.meta.json`` sidecar with the payload's sha256), through the same
streaming writer. So ``train/sweep.py::resume_sweep_state`` reads both
backends' sets, and their sets compare byte for byte. The JAX orbax path
also stamps a directory digest manifest, because orbax writes a
directory; a single payload file whose digest its sidecar records needs
none.
"""

from __future__ import annotations

import logging
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.utils.checkpoint import (
    SUFFIX,
    _leaves,
    _state_meta,
    _write_checkpoint,
    host_array,
    restore_ensemble,
)

logger = logging.getLogger(__name__)


def checkpoint_path(base: str | Path, name: str) -> Path:
    """Where one ensemble's checkpoint lives in a set directory; the sweep
    builds save and resume paths through this, for both backends."""
    return Path(base) / f"{name}{SUFFIX}"


def _snapshot(leaves: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Host copies of a state's tensors, complete when this returns.

    The hazard: the next training step writes new params and Adam
    moments — on the card into buffers the caching allocator may hand out
    from the very memory a replaced state held, on the CPU possibly in
    place. So the snapshot must be complete, in stream order, before that
    step's kernels run. Card tensors are copied into pinned host buffers
    with non-blocking copies on the current stream (queued behind every
    kernel that wrote the state, ahead of the next step's), and one
    synchronize of that stream waits for them before ``save`` returns."""
    host, stream = {}, None
    for key, t in leaves.items():
        t = t.detach()
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            stream = torch.cuda.current_stream(t.device)
        else:
            buf = t.clone(memory_format=torch.contiguous_format)
        host[key] = buf
    if stream is not None:
        stream.synchronize()
    return {key: host_array(buf) for key, buf in host.items()}


def _write(path: Path, arrays: dict[str, np.ndarray], state_meta: dict,
           extra: dict) -> None:
    t0 = obs.monotime()
    try:
        size = _write_checkpoint(path, arrays, state_meta, extra)
    except BaseException as e:
        obs.record_span("ckpt.write", obs.monotime() - t0, ok=False,
                        error=type(e).__name__, file=path.name)
        raise
    obs.record_span("ckpt.write", obs.monotime() - t0, file=path.name,
                    bytes=size)


class AsyncEnsembleCheckpointer:
    """Asynchronous ensemble checkpoints: one single-thread worker per
    target path (made at its first save, reused by later rounds). Share
    one instance per training loop and ``close()`` it when done, so no
    write outlives the run."""

    def __init__(self):
        self._workers: dict[str, ThreadPoolExecutor] = {}
        self._pending: dict[str, Future] = {}

    def save(self, ens: Ensemble, path: str | Path,
             extra: Optional[dict] = None) -> None:
        """Snapshot ``ens``'s state and hand its write to the path's
        worker; returns before the write."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        key = str(path)
        prev = self._pending.pop(key, None)
        if prev is not None:
            prev.result()  # a save to the same path waits for the last one
        state = ens.state
        arrays = _snapshot(_leaves(state))
        if key not in self._workers:
            self._workers[key] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt")
        self._pending[key] = self._workers[key].submit(
            _write, path, arrays, _state_meta(state), dict(extra or {}))

    def restore(self, ens: Ensemble, path: str | Path) -> dict:
        """Load a checkpoint into a freshly built Ensemble of the same
        shape (``utils/checkpoint.py::restore_ensemble``), once every
        pending write is durable."""
        self.wait()
        return restore_ensemble(ens, path)

    def wait(self) -> None:
        """Block until every pending write is durable; the first worker
        exception is raised again here (any others are logged)."""
        pending, self._pending = self._pending, {}
        errors = []
        for key, fut in pending.items():
            try:
                fut.result()
            except Exception as e:
                errors.append(e)
                if len(errors) > 1:
                    logger.error("checkpoint write to %s failed too: %r",
                                 key, e)
        if errors:
            raise errors[0]

    def close(self) -> None:
        """``wait()``, then stop the workers (also when the wait raises)."""
        try:
            self.wait()
        finally:
            for worker in self._workers.values():
                worker.shutdown(wait=True)
            self._workers.clear()


def save_ensemble_orbax(ens: Ensemble, path: str | Path,
                        extra: Optional[dict] = None) -> None:
    """One synchronous save through the asynchronous backend."""
    ckptr = AsyncEnsembleCheckpointer()
    try:
        ckptr.save(ens, path, extra)
    finally:
        ckptr.close()


def restore_ensemble_orbax(ens: Ensemble, path: str | Path) -> dict:
    ckptr = AsyncEnsembleCheckpointer()
    try:
        return ckptr.restore(ens, path)
    finally:
        ckptr.close()
