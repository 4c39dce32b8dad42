"""Asynchronous checkpoints: the backend the sweep selects with
``checkpoint_backend="orbax"`` (the port's counterpart of the JAX
package's ``utils/orbax_ckpt.py``; the module keeps that name so a reader
finds its counterpart).

It uses no orbax: orbax is not on the card's host. It keeps the contract
the sweep's deferred swap rests on:

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

On a mesh each rank writes exactly its own member shard, as the JAX
backend's hosts write theirs: the ranks of data index 0 (one per model
shard; the other data ranks hold the same members) write
``<path>.shard-<m>-of-<M>`` and its sidecar, and rank 0 also writes the
index sidecar ``<path>.meta.json`` (the state's metadata, the caller's
extras, the shard count) after its shard. No rank gathers. The sweep
swaps the set in once every rank's ``wait()`` returned
(``utils/checkpoint.py::restore_ensemble`` reads it back onto any mesh).
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.ensemble import Ensemble
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.utils.checkpoint import (
    SUFFIX,
    _leaves,
    _meta_path,
    _state_meta,
    _write_checkpoint,
    host_array,
    restore_ensemble,
    shard_path,
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
           extra: dict, index: Optional[tuple[Path, dict]] = None) -> None:
    """Write one tensor file and its sidecar; then, for a sharded set's
    rank 0, the index sidecar (``index``: its path and contents)."""
    t0 = obs.monotime()
    try:
        size = _write_checkpoint(path, arrays, state_meta, extra)
        if index is not None:
            atomic_write_text(index[0], json.dumps(index[1], indent=2,
                                                   default=str))
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
        worker; returns before the write. On a mesh this rank's member
        shard, if it writes one (see the module docstring)."""
        path = Path(path)
        mesh, index = ens.mesh, None
        if mesh is not None:
            if mesh.coords["data"] != 0:
                return  # a model shard's members are written once
            n_shards = mesh.shape["model"]
            if mesh.rank == 0:
                index = (_meta_path(path),
                         {**_state_meta(ens.state), **dict(extra or {}),
                          "shards": n_shards, "members": ens.n_members})
            path = shard_path(path, mesh.coords["model"], n_shards)
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
            _write, path, arrays, _state_meta(state), dict(extra or {}),
            index)

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
