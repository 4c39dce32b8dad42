"""Activation harvesting: LM forward → on-disk chunk store (the JAX
package's ``data/harvest.py``).

One multi-tap forward per token batch, pruned at the deepest tapped
layer (``stop_at_layer``), every requested layer captured in one pass,
each tap streamed to its own chunk folder. On the card the activations
come back through pinned host buffers filled by non-blocking copies:
batch i drains into the chunk writers while batch i+1 computes.

With ``mesh=`` the contexts run sequence-parallel (``lm/long_context.py``,
ring attention over the mesh's data axis), so a context can be longer
than one forward holds: every rank of the mesh runs the harvest over the
same token rows, each tap is gathered back along the sequence before its
rows are flattened (the single-device row order), and the mesh's rank 0
alone writes the chunks.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import obs, resolve_device
from sparse_coding_tpu_torch.config import DataArgs
from sparse_coding_tpu_torch.data.chunk_store import ChunkWriter, chunk_rows
from sparse_coding_tpu_torch.lm import hooks
from sparse_coding_tpu_torch.lm.model_config import LMConfig
from sparse_coding_tpu_torch.parallel.mesh import AXES
from sparse_coding_tpu_torch.resilience import lease


def make_harvest_fn(params, cfg: LMConfig, taps: Sequence[str], forward=None,
                    mesh=None, scan_batches: int = 1):
    """tokens [b, s] → {tap: [b*s, width]} on the params' device (the
    reference's run_with_cache and "b s n -> (b s) n").

    ``scan_batches=K > 1`` returns a function of a [K, b, s] token stack
    that runs the K forwards one after another and returns their rows
    joined in batch order — the same values as K single calls, in one
    buffer a tap, so the host pulls once per K batches.

    With a ``mesh``, contexts run sequence-parallel
    (:func:`lm.long_context.sequence_parallel_forward`, GPT-NeoX): every
    rank calls the function with the same tokens [b, s] (s divisible by
    the data axis), and gets every tap gathered back along the sequence
    before the "(b s)" flattening, so its rows are in the single-device
    order."""
    taps = tuple(taps)
    stop = hooks.max_tap_layer(taps) + 1
    if mesh is not None:
        if forward is not None:
            raise ValueError(
                "forward= and mesh= are mutually exclusive: the mesh path "
                "always uses the sequence-parallel GPT-NeoX forward "
                "(lm/long_context.py)")
        if scan_batches > 1:
            raise ValueError(
                "scan_batches > 1 is a single-device lever; the mesh "
                "(sequence-parallel) path runs one sharded forward per "
                "model batch instead")
        from sparse_coding_tpu_torch.lm.long_context import (
            SEQ_AXIS,
            sequence_parallel_forward,
        )

        @torch.inference_mode()
        def harvest_sp(tokens):
            _, tapped = sequence_parallel_forward(params, tokens, cfg, mesh,
                                                  taps=taps,
                                                  stop_at_layer=stop)
            return {name: mesh.all_gather(acts, SEQ_AXIS, dim=1)
                    .reshape(-1, acts.shape[-1])
                    for name, acts in tapped.items()}

        return harvest_sp
    if forward is None:
        from sparse_coding_tpu_torch.lm.convert import forward_fn
        forward = forward_fn(cfg)

    @torch.inference_mode()
    def harvest(tokens):
        _, tapped = forward(params, tokens, cfg, taps=taps,
                            stop_at_layer=stop)
        return {name: acts.reshape(-1, acts.shape[-1])
                for name, acts in tapped.items()}

    if scan_batches > 1:
        @torch.inference_mode()
        def harvest_scan(token_stack):  # [K, b, s]
            outs = [harvest(tokens) for tokens in token_stack]
            return {name: torch.cat([o[name] for o in outs])
                    for name in outs[0]}

        return harvest_scan
    return harvest


class _HostPull:
    """Device → host copies of a step's taps: on the card into one of two
    pinned buffers a tap (non-blocking, an event after them), so the
    previous step drains while this one computes; on the CPU the rows as
    they are."""

    def __init__(self, device: torch.device, max_rows: int):
        self.cuda = device.type == "cuda"
        self.max_rows = max_rows
        self.slots: dict[tuple[str, int], torch.Tensor] = {}
        self.step = 0

    def issue(self, tapped: dict):
        if not self.cuda:
            return None, tapped
        slot, self.step = self.step % 2, self.step + 1
        host = {}
        for name, acts in tapped.items():
            buf = self.slots.get((name, slot))
            if buf is None:
                buf = torch.empty((self.max_rows, acts.shape[1]),
                                  dtype=acts.dtype, pin_memory=True)
                self.slots[(name, slot)] = buf
            view = buf[:acts.shape[0]]
            view.copy_(acts, non_blocking=True)
            host[name] = view
        event = torch.cuda.Event()
        event.record()
        return event, host

    @staticmethod
    def wait(event, host: dict) -> dict[str, np.ndarray]:
        """The rows as numpy arrays the caller may keep (a pinned slot is
        reused two steps on, so its rows are copied out)."""
        if event is None:
            return {name: a.numpy() for name, a in host.items()}
        event.synchronize()
        return {name: a.numpy().copy() for name, a in host.items()}


def harvest_activations(
    params,
    cfg: LMConfig,
    token_rows: np.ndarray,
    layers: Sequence[int],
    layer_loc: str,
    output_folder: str | Path,
    model_batch_size: int = 4,
    chunk_size_gb: float = 2.0,
    n_chunks: Optional[int] = None,
    skip_chunks: int = 0,
    center: bool = False,
    dtype: str = "bfloat16",
    forward=None,
    mesh=None,
    scan_batches: int = 1,
    tap_dirs: Optional[dict] = None,
    device=None,
) -> dict[str, int]:
    """Run the LM (its params on ``device``, default the card) over packed
    token rows [n, s], streaming each tap's activations to its own chunk
    folder ``{output_folder}/{tap}/`` (``tap_dirs`` remaps a tap's
    folder). Returns {tap: chunks written}.

    Chunk boundaries fall on whole model batches, so ``skip_chunks``
    resumes exactly past the chunks already written; ``n_chunks`` caps
    the chunks written, in whole batches; a partial last batch is
    dropped. ``center=True`` subtracts the first chunk's mean inside the
    writers. ``scan_batches=K`` pulls K model batches at a time (values
    bit-identical to K=1; the tail runs as single batches). Any exception
    aborts every writer: whole chunks stay, no ``meta.json`` is written.
    Each finalized folder's meta.json carries ``model``, ``layer_loc``,
    ``tap`` and ``layer``.

    ``mesh``: every rank of the mesh calls this with the same arguments
    and the params on its device (``mesh.device``); the contexts run
    sequence-parallel (:func:`make_harvest_fn`, GPT-NeoX, the context
    length divisible by the data axis). The mesh's rank 0 (model 0, data
    0) holds the writers, pulls the gathered rows to the host and writes
    every chunk and meta.json; the other ranks run the forwards and the
    collectives and write nothing. Every rank returns rank 0's counts."""
    if scan_batches > 1 and mesh is not None:
        raise ValueError("scan_batches > 1 is not supported on the mesh "
                         "(sequence-parallel) harvesting path")
    dev = mesh.device if mesh is not None else resolve_device(device)
    taps = hooks.taps_for(layers, layer_loc)
    harvest = make_harvest_fn(params, cfg, taps, forward=forward, mesh=mesh)
    harvest_window = (make_harvest_fn(params, cfg, taps, forward=forward,
                                      scan_batches=scan_batches)
                      if scan_batches > 1 else None)
    width = hooks.get_activation_size(layer_loc, cfg)
    seq_len = token_rows.shape[1]
    tap_dirs = dict(tap_dirs or {})
    writes = mesh is None or mesh.rank == 0
    writers = {
        t: ChunkWriter(Path(tap_dirs.get(t, Path(output_folder) / t)), width,
                       chunk_size_gb=chunk_size_gb, dtype=dtype,
                       start_index=skip_chunks,
                       round_rows_to=model_batch_size * seq_len,
                       center=center)
        for t in taps
    } if writes else {}
    n_rows = token_rows.shape[0]
    rows_per_chunk = chunk_rows(width, chunk_size_gb, dtype,
                                model_batch_size * seq_len)
    skip_rows = skip_chunks * (rows_per_chunk // seq_len)
    if n_chunks is not None:
        # never feed rows past the cap: a window crossing the last chunk
        # boundary would leave buffered rows that finalize() flushes as an
        # extra chunk
        n_rows = min(n_rows, skip_rows + n_chunks * (rows_per_chunk // seq_len))

    pull = _HostPull(dev, max(scan_batches, 1) * model_batch_size * seq_len)
    pending: deque = deque()
    drained_rows = obs.counter("harvest.rows_drained")

    def drain_one() -> bool:
        for name, host in pull.wait(*pending.popleft()).items():
            writers[name].add(host)
            drained_rows.inc(int(host.shape[0]))
        # a drained batch proves the LM, the copy and the writer advanced
        lease.beat()
        return n_chunks is not None and all(
            w.chunk_index - skip_chunks >= n_chunks for w in writers.values())

    def tokens_of(lo: int, hi: int) -> torch.Tensor:
        rows = torch.as_tensor(token_rows[lo:hi], dtype=torch.long)
        if not pull.cuda:
            return rows
        # from pinned memory the copy is queued behind the previous batch's
        # work instead of waiting for it (the host allocator keeps the
        # block until the copy is done)
        return rows.pin_memory().to(dev, non_blocking=True)

    done = False
    lo = skip_rows
    t_harvest = obs.monotime()
    try:
        while lo < n_rows and not done:
            n_avail = (n_rows - lo) // model_batch_size  # full batches left
            if n_avail == 0:
                break  # the partial last batch is dropped
            if harvest_window is not None and n_avail >= scan_batches:
                step_rows = model_batch_size * scan_batches
                tapped = harvest_window(tokens_of(lo, lo + step_rows).reshape(
                    scan_batches, model_batch_size, seq_len))
            else:
                step_rows = model_batch_size
                tapped = harvest(tokens_of(lo, lo + step_rows))
            lo += step_rows
            if not writes:
                lease.beat()  # the forward and its collectives advanced
                continue
            pending.append(pull.issue(tapped))
            if len(pending) > 1:
                done = drain_one()
        while pending and not done:
            done = drain_one()
    except BaseException:
        for w in writers.values():
            w.abort()
        obs.record_span("harvest.run", obs.monotime() - t_harvest, ok=False,
                        error="aborted", taps=list(taps))
        raise

    result = {name: w.finalize({"model": cfg.arch, "layer_loc": layer_loc,
                                "tap": name,
                                "layer": hooks.parse_tap_name(name)[1]})
              for name, w in writers.items()}
    if mesh is not None:
        # rank 0's counts on every rank (the others contribute zeros)
        counts = mesh.psum(torch.tensor([float(result.get(t, 0))
                                         for t in taps], device=dev), AXES)
        result = {t: int(c) for t, c in zip(taps, counts.tolist())}
    obs.record_span("harvest.run", obs.monotime() - t_harvest,
                    taps=list(taps), rows=int(n_rows - skip_rows),
                    chunks={k: int(v) for k, v in result.items()})
    return result


def make_one_chunk_per_layer(params, lm_cfg: LMConfig, token_rows: np.ndarray,
                             layers: Sequence[int], layer_loc: str,
                             output_folder: str | Path,
                             chunk_size_gb: float = 0.5,
                             model_batch_size: int = 4,
                             forward=None, device=None) -> dict[str, int]:
    """One eval chunk per layer, for metric sweeps."""
    return harvest_activations(params, lm_cfg, token_rows, layers, layer_loc,
                               output_folder, model_batch_size=model_batch_size,
                               chunk_size_gb=chunk_size_gb, n_chunks=1,
                               forward=forward, device=device)


def setup_data(cfg: DataArgs, params, lm_cfg: LMConfig, texts, tokenizer,
               forward=None, device=None) -> dict[str, int]:
    """Tokenize and pack ``texts``, then harvest them as ``cfg`` says."""
    from sparse_coding_tpu_torch.data.tokenize import chunk_and_tokenize

    rows, _ = chunk_and_tokenize(texts, tokenizer, max_length=cfg.context_len,
                                 eos_token_id=lm_cfg.eos_token_id,
                                 max_docs=cfg.max_docs)
    return harvest_activations(
        params, lm_cfg, rows, cfg.layers, cfg.layer_loc, cfg.dataset_folder,
        model_batch_size=cfg.model_batch_size, chunk_size_gb=cfg.chunk_size_gb,
        n_chunks=cfg.n_chunks, skip_chunks=cfg.skip_chunks,
        center=cfg.center_dataset, dtype=cfg.activation_dtype, forward=forward,
        scan_batches=cfg.scan_batches, device=device)
