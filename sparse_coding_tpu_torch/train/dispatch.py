"""Chunk dispatch: drive many ensembles through one in-RAM chunk (the
port's copy of the JAX package's ``train/dispatch.py``, the API of the
reference's ``dispatch_job_on_chunk`` / ``dispatch_lite`` /
``collect_lite``). The reference forks a process per GPU; here each
ensemble's step is queued on the card without blocking the host, so
interleaving the step calls keeps every ensemble on one device busy. An
``EnsembleGroup`` steps every bucket; its last aux is a dict by bucket."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch.data.chunk_store import (
    device_prefetch,
    shuffled_batches,
)
from sparse_coding_tpu_torch.ensemble import EnsembleLike


def _queue_chunk(ensembles: Sequence[EnsembleLike], chunk, batch_size: int,
                 seed: int, progress=None) -> dict[str, Any]:
    rng = np.random.default_rng(seed)
    total = chunk.shape[0] // batch_size
    device = ensembles[0].buckets()[0][1].device if ensembles else "cpu"
    last_aux: dict[str, Any] = {}
    for i, batch in enumerate(device_prefetch(
            shuffled_batches(chunk, batch_size, rng), device)):
        for j, ens in enumerate(ensembles):
            last_aux[str(j)] = ens.step_batch(batch)  # queued, not waited
        if progress is not None:
            progress(i + 1, total)
    return last_aux


def dispatch_job_on_chunk(ensembles: Sequence[EnsembleLike], chunk,
                          batch_size: int = 1024, seed: int = 0,
                          progress: Optional[Callable[[int, int], None]]
                          = None) -> dict[str, Any]:
    """Train every ensemble over one shuffled pass of the chunk and wait
    for the card; returns the last aux per ensemble index."""
    return LiteJob(ensembles, _queue_chunk(ensembles, chunk, batch_size,
                                           seed, progress)).collect()


class LiteJob:
    """Handle on queued work; ``collect()`` is the barrier."""

    def __init__(self, ensembles, last_aux):
        self.ensembles = ensembles
        self.last_aux = last_aux

    def collect(self):
        for e in self.ensembles:
            for _, ens in e.buckets():
                if ens.device.type == "cuda":
                    torch.cuda.synchronize(ens.device)
        return self.last_aux


def dispatch_lite(ensembles: Sequence[EnsembleLike], chunk,
                  batch_size: int = 1024, seed: int = 0) -> LiteJob:
    """Queue a full chunk pass without waiting (the card works while the
    host e.g. loads the next chunk)."""
    return LiteJob(ensembles, _queue_chunk(ensembles, chunk, batch_size,
                                           seed))


def collect_lite(job: LiteJob):
    return job.collect()
