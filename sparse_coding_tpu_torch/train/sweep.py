"""The full sweep (the port's copy of the JAX package's
``train/sweep.py``).

Flow, as in the JAX package (the reference's big_sweep.py:298-386):
  1. the dataset: an existing chunk store, or synthetic data written to
     disk (``SyntheticEnsembleArgs``);
  2. ``ensemble_init_fn(cfg, mesh, device=...)`` →
     ``[(Ensemble | EnsembleGroup, member_hyperparams, name)]``
     (``train/experiments.py``); a group's buckets train, log
     (``{bucket}/...`` keys), checkpoint (``{name}_{j}``) and quarantine
     one by one, and its dicts flatten in bucket order;
  3. the chunk order, shuffled once per repetition from
     ``np.random.default_rng(cfg.seed)``, the batches from the same rng;
     optional centering on the first sound chunk's mean;
  4. per chunk: shuffled batches through every ensemble, each on its
     kernel path (the same resolution as ``basic_l1_sweep``), the
     guardian's per-window combine and its chunk-boundary ladder;
  5. a full-state checkpoint set every ``checkpoint_every_chunks``
     chunks, staged and swapped in by renames, the previous set kept as
     ``ckpt_prev/``. ``checkpoint_backend="msgpack"`` writes the set and
     swaps it in at once; ``"orbax"`` (``utils/orbax_ckpt.py``) snapshots
     it to host memory, writes it on worker threads while the next chunk
     trains, and swaps it in at the next round (or when the sweep ends,
     preemption and crashes included) — so a kill while a set is being
     written resumes from the set before it. Both write the same files;
     exact resume (``resume=True``) and SIGTERM preemption
     (``SweepPreempted``) continue bitwise;
  6. learned dicts and quick evals at chunk counts {7, 15, 31, ...} (or
     every ``save_every_chunks``) and at the end.

The store is flat or sharded (``data/shard_store.py::open_store``). The
entry point runs on the card; ``device="cpu"`` (``--device cpu``) runs
the kernels' plain versions on the CPU. ``profile_steps > 0`` opens one
managed profiler window (``obs/trace.py``) into
``<output>/trace`` once the first steps have run, and closes it
``profile_steps`` steps later. ``use_wandb`` sends the metrics lines to
a wandb run as well, where ``wandb`` imports (``utils/logging.py``). The
executable-cache warm start of the JAX sweep has no counterpart: the
port runs no compiled executables a cache could keep (ROADMAP.md, known
gaps: ``xcache/store.py``).

On a mesh (``mesh_model``/``mesh_data`` > 1, or a ``mesh`` argument;
:mod:`parallel.mesh`) every rank reads the same chunks and batches, and
each trains its member shard on its rows. Decisions with collectives
inside — preemption, the guardian's ladder — are agreed by every rank
(``parallel.agree_any``); rank 0 alone writes the metrics, the checkpoint
sets (gathered from every rank, the bytes a single-device run writes for
the same numbers) and the artifacts, and barriers keep the other ranks
from reading a set before it is swapped in. The msgpack backend gathers
the state to rank 0, so it needs every rank on one node
(``LOCAL_WORLD_SIZE == WORLD_SIZE``: the JAX package's single host); the
orbax backend writes each model shard from its own rank
(``utils/orbax_ckpt.py``), and every rank waits for its writes before
rank 0 swaps the set in.

Run: ``python -m sparse_coding_tpu_torch.train.sweep --experiment
tied_vs_not --dataset_folder DIR --output_folder DIR [--resume true]
[--device cpu] [config flags]``; with ``--mesh_model M --mesh_data D``
under ``torchrun --nproc_per_node M*D``. ``SPARSE_CODING_CRASH_PLAN`` and
``SPARSE_CODING_FAULT_PLAN`` drive the crash barriers and fault sites;
``SPARSE_CODING_OBS_DIR`` collects the spans and metrics.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sparse_coding_tpu_torch import obs, resolve_device
from sparse_coding_tpu_torch.config import (
    EnsembleArgs,
    SyntheticEnsembleArgs,
    _parse_value,
)
from sparse_coding_tpu_torch.data.chunk_store import (
    ChunkStore,
    ChunkWriter,
    device_prefetch,
    window_stacks,
)
from sparse_coding_tpu_torch.data.ingest import chunk_stream
from sparse_coding_tpu_torch.data.shard_store import (
    first_sound_chunk,
    open_store,
)
from sparse_coding_tpu_torch.ensemble import (
    Ensemble,
    EnsembleGroup,
    EnsembleLike,
)
from sparse_coding_tpu_torch.metrics.core import (
    fraction_variance_unexplained,
    mean_l0,
    mean_nonzero_activations,
    mmcs_from_list,
)
from sparse_coding_tpu_torch.obs.perf import synchronize
from sparse_coding_tpu_torch.parallel import agree_any
from sparse_coding_tpu_torch.parallel.mesh import (
    initialize_distributed,
    local_world_is_world,
    make_mesh,
    shutdown_distributed,
)
from sparse_coding_tpu_torch.resilience import lease
from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_save_npy,
    atomic_write_text,
)
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)
from sparse_coding_tpu_torch.resilience.errors import (
    CheckpointCorruptionError,
)
from sparse_coding_tpu_torch.resilience.preempt import (
    PreemptionGuard,
    SweepPreempted,
)
from sparse_coding_tpu_torch.train.guardian import Guardian, GuardianRollback
from sparse_coding_tpu_torch.utils.artifacts import save_learned_dicts
from sparse_coding_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    restore_ensemble,
    save_ensemble,
)
from sparse_coding_tpu_torch.utils.logging import (
    MetricsLogger,
    make_hyperparam_name,
)
from sparse_coding_tpu_torch.utils.orbax_ckpt import (
    AsyncEnsembleCheckpointer,
    checkpoint_path,
)
from sparse_coding_tpu_torch.utils.profiling import StepTimer

logger_mod = logging.getLogger(__name__)

register_crash_site("sweep.chunk",
                    "end of one sweep chunk's train+checkpoint+artifact "
                    "block (train/sweep.py)")
register_crash_site("ckpt.swap",
                    "mid checkpoint-set swap: old set renamed to "
                    "ckpt_prev/, new set not yet renamed in "
                    "(_swap_in_checkpoint_set)")

# ensemble_init_fn(cfg, mesh, device=...) -> [(EnsembleLike, hypers, name)]
EnsembleInitFn = Callable[..., list[tuple[EnsembleLike, list[dict], str]]]


def _flat_dicts(e: EnsembleLike) -> list:
    """Every member's LearnedDict, a group's buckets in insertion order
    (the order of its hyperparameters)."""
    return [d for _, ens in e.buckets() for d in ens.to_learned_dicts()]


def init_synthetic_dataset(cfg: SyntheticEnsembleArgs) -> ChunkStore:
    """Write a synthetic dataset to chunk files (float16 on disk), or open
    the one already there. The generator is the port's, seeded from
    ``cfg.seed``; its numbers differ from ``jax.random``'s."""
    from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator

    folder = Path(cfg.dataset_folder)
    if (folder / "meta.json").exists():
        return ChunkStore(folder)
    gen = RandomDatasetGenerator.create(
        torch.Generator().manual_seed(cfg.seed), cfg.activation_dim,
        cfg.n_ground_truth_features, cfg.feature_num_nonzero,
        cfg.feature_prob_decay, correlated=cfg.correlated_components)
    writer = ChunkWriter(folder, cfg.activation_dim,
                         chunk_size_gb=max(cfg.dataset_size * cfg.activation_dim
                                           * 2 / cfg.n_chunks / 2**30, 1e-6),
                         dtype="float16")
    g = torch.Generator().manual_seed(cfg.seed + 1)
    remaining = cfg.dataset_size
    while remaining > 0:
        n = min(remaining, 65536)
        writer.add(gen.batch(g, n))
        remaining -= n
    writer.finalize({"synthetic": True})
    atomic_save_npy(folder / "ground_truth_feats.npy", gen.feats.numpy())
    return ChunkStore(folder)


def _member_names(hypers: Sequence[dict], n_members: int) -> list[str]:
    """Unique per-member stream names from the hyperparameters; colliding
    names get an index suffix so log streams never merge."""
    names = []
    for i in range(n_members):
        name = f"member{i}"
        if i < len(hypers):
            scalars = {k: v for k, v in hypers[i].items()
                       if isinstance(v, (int, float)) and not isinstance(v, bool)}
            if scalars:
                name = make_hyperparam_name(scalars)
        names.append(name)
    return [f"{name}_{i}" if names.count(name) > 1 else name
            for i, name in enumerate(names)]


def _check_supported(cfg: EnsembleArgs, mesh) -> None:
    """Raise on what the port cannot do yet, naming its ROADMAP item."""
    if cfg.checkpoint_backend not in ("msgpack", "orbax"):
        raise ValueError(f"checkpoint_backend must be 'msgpack' or 'orbax', "
                         f"got {cfg.checkpoint_backend!r}")
    if (mesh is not None and cfg.checkpoint_backend == "msgpack"
            and not local_world_is_world()):
        raise ValueError(
            "checkpoint_backend='msgpack' gathers the full state to one "
            "host and is single-host only; use checkpoint_backend='orbax' "
            "for multi-host runs (sharded per-host writes)")
    if cfg.train_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"train_dtype must be 'float32' or 'bfloat16', got "
                         f"{cfg.train_dtype!r}")


class _SilentLogger:
    """The metrics logger of a mesh rank other than 0: rank 0 writes the
    run's one metrics file."""

    def log(self, metrics, step=None) -> None:
        pass

    def close(self) -> None:
        pass


def _is_writer(mesh) -> bool:
    """Whether this process writes the run's files: always off a mesh,
    rank 0 on one."""
    return mesh is None or mesh.rank == 0


def _sync_ranks(mesh) -> None:
    """Every rank waits here (no-op off a mesh): rank 0 alone mutates the
    checkpoint directories, and no rank may read a set before it is
    swapped in."""
    if mesh is not None:
        mesh.barrier()


def _swap_in_checkpoint_set(out_dir: Path, staging: Path) -> None:
    """Rename-swap a complete staged checkpoint set into ckpt/. The old
    set stays as ckpt_prev/: it covers a crash at any instant of the swap
    and later corruption of ckpt/ (``resume_sweep_state`` falls back to
    it), at the cost of one more set on disk."""
    ckpt_dir = out_dir / "ckpt"
    prev = out_dir / "ckpt_prev"
    with obs.span("sweep.ckpt_swap"):
        if ckpt_dir.exists():
            shutil.rmtree(prev, ignore_errors=True)
            ckpt_dir.rename(prev)
        # the swap's worst instant: ckpt/ is gone, the new set not yet
        # named in — a kill here must leave resume falling back to
        # ckpt_prev/
        crash_barrier("ckpt.swap")
        staging.rename(ckpt_dir)


def _subtract_center(chunk, center: np.ndarray):
    """Center a decoded chunk in place, in its own dtype: the mean is cast
    down rather than the chunk up, so a bfloat16 chunk stays half width."""
    if isinstance(chunk, torch.Tensor):
        return chunk.sub_(torch.from_numpy(center).to(chunk.dtype))
    chunk -= center.astype(chunk.dtype)
    return chunk


def sweep(
    ensemble_init_fn: EnsembleInitFn,
    cfg: EnsembleArgs,
    store: Optional[ChunkStore] = None,
    mesh=None,
    log_every: int = 100,
    image_metrics_every: Optional[int] = 10,
    resume: bool = False,
    device=None,
) -> dict[str, list]:
    """Run the sweep; returns ``{name: [(LearnedDict, hyperparams), ...]}``.

    ``cfg.n_chunks`` limits the chunks per repetition. ``resume=True``
    restores every ensemble and the batch rng from the newest complete
    checkpoint set and skips the chunks it covers. ``device=None`` runs on
    the card and raises without one. Without a ``mesh``, a config with
    ``mesh_model``/``mesh_data`` > 1 joins the world torchrun set up and
    builds one on ``device``'s type (each rank on ``cuda:LOCAL_RANK``)."""
    if mesh is None and (cfg.mesh_data > 1 or cfg.mesh_model > 1):
        dev_type = torch.device(device).type if device is not None else "cuda"
        initialize_distributed(device_type=dev_type)
        mesh = make_mesh(cfg.mesh_model, cfg.mesh_data, device_type=dev_type)
    _check_supported(cfg, mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = _is_writer(mesh)
    out_dir = Path(cfg.output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    if writer:
        cfg.save(out_dir / "config.json")

    if store is None:
        if isinstance(cfg, SyntheticEnsembleArgs):
            # rank 0 writes a missing dataset, the other ranks open it
            if writer:
                store = init_synthetic_dataset(cfg)
            _sync_ranks(mesh)
            if not writer:
                store = init_synthetic_dataset(cfg)
        else:
            # a scrub-repaired store must train through its holes
            store = open_store(cfg.dataset_folder, quarantine_corrupt=True)

    ensembles = ensemble_init_fn(cfg, mesh, device=dev)
    member_names = [_member_names(hypers, len(hypers))
                    for _, hypers, _ in ensembles]
    logger = (MetricsLogger(out_dir, use_wandb=cfg.use_wandb,
                            run_name=out_dir.name, config=cfg.to_dict())
              if writer else _SilentLogger())

    guardian: Optional[Guardian] = None
    if cfg.guardian:
        guardian = Guardian(out_dir, ensembles, member_names,
                            member_fraction=cfg.guardian_member_fraction,
                            rollback_budget=cfg.guardian_rollback_budget,
                            fresh=not resume)
        # a chunk the guardian quarantines must replay as a positional hole
        store.quarantine_corrupt = True

    rng = np.random.default_rng(cfg.seed)
    n_chunks = min(cfg.n_chunks, store.n_chunks)
    chunk_order = np.concatenate([rng.permutation(n_chunks)
                                  for _ in range(cfg.n_repetitions)])
    # the rollback target when an incident lands before the first set
    rng0_state = rng.bit_generator.state

    chunks_done = 0
    if resume:
        t0 = obs.monotime()
        chunks_done, rng_state = resume_sweep_state(ensembles, out_dir)
        if rng_state is not None:
            rng.bit_generator.state = rng_state
        if guardian is not None:
            # a restored checkpoint predates the quarantines it resumes past
            guardian.refreeze()
        obs.record_span("sweep.resume", obs.monotime() - t0,
                        chunks_done=chunks_done)

    center = None
    if cfg.center_activations:
        # the reference centers on chunk 0; over a scrub-repaired store
        # the first sound chunk stands in
        center = store.chunk_mean(first_sound_chunk(store))

    # bfloat16 keeps activations half width from disk through the
    # host→device copy; the step promotes them to float32 on the device
    train_dtype = (torch.bfloat16 if cfg.train_dtype == "bfloat16"
                   else np.float32)
    if cfg.save_every_chunks:
        save_points = set(range(cfg.save_every_chunks - 1, len(chunk_order),
                                cfg.save_every_chunks))
    else:
        save_points = {2**k - 1 for k in range(3, 10)}
    step = last_log = 0
    # scan_steps > 1: windows of K steps through run_steps
    scan_k = max(1, int(cfg.scan_steps))
    timer = StepTimer(warmup=3 if scan_k == 1 else 1)
    # every Nth window is bracketed by syncs → train.mfu (obs/perf.py)
    perf_probe = (obs.DeviceStepProbe("train", every=cfg.perf_probe_every,
                                      device=dev)
                  if cfg.perf_probe_every > 0 else None)
    # the JAX sweep's executable-cache warm start has no counterpart: the
    # port compiles no executables a cache could keep (ROADMAP.md, known
    # gaps: xcache/store.py)
    # profile_steps > 0: one managed trace window (obs/trace.py: tmp then
    # atomic finalize, counted skip on error, closed in the finally),
    # opened once the first steps have run — step 2, or the second window
    # under scan — and closed profile_steps steps later, on a window
    # boundary, so it covers at least profile_steps steps. Rank 0 alone
    # traces on a mesh: the ranks would share one trace directory.
    profile_start = 2 if scan_k == 1 else scan_k + 1
    profiling = profile_done = False
    tracer = (obs.TraceCapture(out_dir / "trace")
              if cfg.profile_steps > 0 and writer else None)

    def _open_reader(from_chunk: int):
        """(positions, reader) from ``from_chunk`` to the end; re-opened
        after a rollback, with the quarantined chunk now a hole."""
        positions = list(range(from_chunk, len(chunk_order)))
        return positions, chunk_stream(
            store, [int(chunk_order[ci]) for ci in positions],
            dtype=train_dtype, streams=cfg.ingest_streams or None)

    def _reinit_states() -> None:
        """The rollback target before any checkpoint set exists: the init
        is a function of cfg.seed (or of carried inits), so a fresh
        ensemble_init_fn reproduces the chunk-0 state bitwise."""
        for (e_old, _, _), (e_new, _, _) in zip(
                ensembles, ensemble_init_fn(cfg, mesh, device=dev)):
            for (_, s_old), (_, s_new) in zip(e_old.buckets(),
                                              e_new.buckets()):
                s_old.state = s_new.state

    ckptr = (AsyncEnsembleCheckpointer()
             if cfg.checkpoint_backend == "orbax" else None)
    # orbax: a fully issued set whose swap waits for the next round (or
    # the finally), so its writes overlap the next chunk's training
    pending_staging: Optional[Path] = None

    def _swap_pending() -> None:
        """Wait for the issued set's writes, then swap it in. The set is
        dropped first: after a failed write it is never swapped in, nor
        waited on again."""
        nonlocal pending_staging
        staged, pending_staging = pending_staging, None
        with obs.span("sweep.ckpt_wait"):
            ckptr.wait()
        # on a mesh: every rank's shard is durable before rank 0 swaps,
        # and the swap is done before any rank goes on
        _sync_ranks(mesh)
        if writer:
            _swap_in_checkpoint_set(out_dir, staged)
        _sync_ranks(mesh)

    todo, reader = _open_reader(chunks_done)
    # SIGTERM sets a flag polled at chunk boundaries: the chunk finishes,
    # a checkpoint set is forced, and SweepPreempted propagates
    preempt = PreemptionGuard()
    preempt.__enter__()  # paired in the finally (keeps the loop unindented)
    try:
        # one pass is the whole sweep; a guardian rollback restores the
        # last-good set and replays with the offending chunk quarantined
        while True:
            try:
                for ci, chunk in zip(todo, reader):
                    # a fresh throughput window per chunk: checkpoint and
                    # artifact time must not dilute the training rate
                    timer.reset()
                    t_chunk = obs.monotime()
                    rows = 0
                    if chunk is not None and center is not None:
                        chunk = _subtract_center(chunk, center)
                    # a quarantined chunk (None) trains nothing, but the
                    # boundary bookkeeping below still runs at this ci
                    batches = (iter(()) if chunk is None
                               else store.batches(chunk, cfg.batch_size, rng))
                    if guardian is not None:
                        # fault site sweep.anomaly: the divergence drills
                        batches = map(guardian.inject_anomaly, batches)
                    if scan_k > 1:
                        batches = window_stacks(batches, scan_k)
                    # on a mesh each rank moves only its own rows to its
                    # device (Ensemble.step_batch)
                    for batch in (device_prefetch(batches, dev)
                                  if mesh is None else batches):
                        k_steps = batch.shape[0] if scan_k > 1 else 1
                        n_rows = batch.shape[-2] * k_steps
                        step += k_steps
                        rows += n_rows
                        if (tracer is not None and not profiling
                                and not profile_done
                                and step >= profile_start):
                            profiling = tracer.begin()
                            # a counted begin-skip must not retry per step
                            profile_done = not profiling
                        elif (profiling and step
                              >= profile_start + cfg.profile_steps):
                            synchronize(dev)  # the window's kernels done
                            tracer.end()
                            profiling = False
                            profile_done = True
                        do_log = step - last_log >= log_every
                        if do_log:
                            last_log = step
                        # log windows sync mid-window, trace windows carry
                        # the profiler: neither is sampled
                        sample_perf = (perf_probe is not None and not do_log
                                       and not profiling
                                       and perf_probe.should_sample())
                        if sample_perf:
                            synchronize(dev)
                            t_perf = obs.monotime()
                        for ens_idx, (ensemble, hypers, name) in enumerate(
                                ensembles):
                            aux = (ensemble.run_steps(batch) if scan_k > 1
                                   else ensemble.step_batch(batch))
                            is_group = isinstance(ensemble, EnsembleGroup)
                            # (bucket name, aux): a plain entry observes
                            # and logs under its own name
                            items = (list(aux.items()) if is_group
                                     else [(name, aux)])
                            for sub_name, sub_aux in items:
                                if guardian is not None:
                                    guardian.observe(ens_idx, sub_name,
                                                     sub_aux)
                                if do_log:
                                    # a group's streams are positional:
                                    # its hypers do not align with
                                    # bucket-local indices
                                    _log_window(
                                        logger, step, ens_idx, sub_name,
                                        sub_aux, scan_k > 1,
                                        [] if is_group
                                        else member_names[ens_idx],
                                        guardian)
                        if sample_perf:
                            synchronize(dev)
                            perf_probe.record(
                                obs.monotime() - t_perf,
                                cost=obs.combine_costs(
                                    [e.step_cost(batch.shape[-2])
                                     for e, _, _ in ensembles]),
                                steps=k_steps)
                        timer.tick(n_rows)
                        lease.beat()  # a finished window is progress
                        if do_log:
                            logger.log({"activations_per_sec":
                                        timer.items_per_sec}, step=step)
                    # the guardian's one host sync per chunk, before the
                    # checkpoint, so a poisoned chunk's state is never
                    # checkpointed
                    if guardian is not None:
                        guardian.check_boundary(ci, int(chunk_order[ci]),
                                                store)
                    synchronize(dev)
                    train_s = obs.monotime() - t_chunk
                    last_chunk = ci == len(chunk_order) - 1
                    cadence = cfg.checkpoint_every_chunks
                    # sampled once per boundary; a signal landing later is
                    # honored at the next one. A signal may reach one rank
                    # only: every rank takes the checkpoint branch, with
                    # its collectives, together
                    preempted = agree_any(preempt.requested,
                                          "sweep-preempt")
                    if ((cadence > 0 and (ci + 1) % cadence == 0)
                            or last_chunk or preempted):
                        if pending_staging is not None:
                            # the last round's writes overlapped this
                            # chunk's training
                            _swap_pending()
                        _save_checkpoint_set(ensembles, out_dir, ci + 1,
                                             rng.bit_generator.state, ckptr,
                                             mesh)
                        if ckptr is not None:
                            # fully issued; a crash mid-issue leaves it
                            # unset, and the staged set is discarded
                            pending_staging = out_dir / "ckpt_staging"
                    if (ci in save_points or last_chunk) and chunk is not None:
                        _save_artifacts(
                            ensembles, out_dir / f"_{ci}", chunk, logger,
                            image_metrics=image_metrics_every is not None
                            and (ci + 1) % image_metrics_every == 0,
                            guardian=guardian, device=dev, writer=writer)
                    # chunk telemetry before the barrier: a kill there
                    # leaves the span as durable as the chunk's artifacts
                    snap = timer.snapshot()
                    timer.publish(prefix="sweep")
                    obs.record_span("sweep.chunk", obs.monotime() - t_chunk,
                                    index=ci, chunk=int(chunk_order[ci]),
                                    steps=snap["steps"], rows=rows,
                                    train_s=round(train_s, 6),
                                    acts_per_sec=round(snap["items_per_sec"],
                                                       1))
                    obs.flush_metrics()
                    # one chunk's train+checkpoint+artifact block is durable:
                    # the crash-resume unit
                    crash_barrier("sweep.chunk")
                    if preempted and not last_chunk:
                        raise SweepPreempted(ci + 1)
            except GuardianRollback as rollback:
                # the incident and the chunk quarantine are durable; close
                # the stream, make a fully issued set current (it is the
                # newest last-good state), restore it, replay
                reader.close()
                if pending_staging is not None:
                    _swap_pending()

                def _restore():
                    done, rng_state = resume_sweep_state(ensembles, out_dir)
                    if done == 0 and rng_state is None:
                        _reinit_states()
                        rng_state = rng0_state
                    return done, rng_state

                chunks_done, rng_state = guardian.rollback_restore(_restore)
                if rng_state is not None:
                    rng.bit_generator.state = rng_state
                logger_mod.warning(
                    "guardian rollback (%s at %s): resuming from chunk %d "
                    "with chunk %d quarantined", rollback.incident,
                    rollback.site, chunks_done, rollback.chunk_index)
                todo, reader = _open_reader(chunks_done)
                continue
            break
    finally:
        preempt.__exit__(None, None, None)
        reader.close()
        if profiling:
            # a short sweep or a crash inside the window: the capture is
            # still finalized, so the steps it recorded stay viewable
            tracer.end()
        try:
            if pending_staging is not None:
                # a fully issued set reflects completed training: swapped
                # in on a clean exit, on SweepPreempted and on a crash
                _swap_pending()
        finally:
            logger.close()
            if ckptr is not None:
                ckptr.close()  # no write outlives the run
    result = {}
    for ensemble, hypers, name in ensembles:
        tagged = list(zip(_flat_dicts(ensemble), hypers))
        if guardian is not None:
            # quarantined members ship tagged diverged=True, as every
            # artifact does
            tagged = guardian.tag_hypers(name, tagged)
        result[name] = tagged
    return result


def _log_window(logger: MetricsLogger, step: int, ens_idx: int, name: str,
                aux, stacked: bool, names: Sequence[str],
                guardian: Optional[Guardian]) -> None:
    """One metrics line for an entry or a group's bucket (``name``): the
    window's last step, aggregates over the live members (a quarantined
    member's NaN loss must not poison them; its own stream still logs)
    and per-member streams (``member{i}`` past ``names``)."""
    last = (lambda v: v[-1]) if stacked else (lambda v: v)
    losses = last(aux.losses["loss"]).detach().cpu().numpy()
    l0 = last(aux.l0).detach().float().cpu().numpy()
    mask = np.ones(len(losses), np.bool_)
    if guardian is not None:
        mask[guardian.dead_indices(ens_idx, name)] = False
    rec = {}
    if mask.any():
        rec = {f"{name}/loss_mean": float(np.mean(losses[mask])),
               f"{name}/loss_max": float(np.max(losses[mask])),
               f"{name}/l0_mean": float(np.mean(l0[mask]))}
    if not mask.all():
        rec[f"{name}/quarantined"] = int((~mask).sum())
    for mi, (loss_i, l0_i) in enumerate(zip(losses, l0)):
        member = names[mi] if mi < len(names) else f"member{mi}"
        rec[f"{name}/{member}/loss"] = float(loss_i)
        rec[f"{name}/{member}/l0"] = float(l0_i)
    logger.log(rec, step=step)


def _save_checkpoint_set(ensembles, out_dir: Path, chunks_done: int,
                         rng_state: dict,
                         ckptr: Optional[AsyncEnsembleCheckpointer] = None,
                         mesh=None) -> None:
    """Write every ensemble's state to a staging directory, so a crash
    mid-save never leaves ensembles at mixed chunks_done; the rng state
    lets the data stream resume exactly. Without ``ckptr`` (msgpack) the
    complete set is swapped in here; with it (orbax) the set is only
    issued — its writes go on in the background and the caller swaps it
    in once they are durable. The span records the write, or the issue.
    On a mesh every rank takes part: under msgpack each gathers its shards
    for rank 0, which writes and swaps the set; under orbax each model
    shard's rank issues its own write; no rank leaves before the msgpack
    set is in place."""
    t0 = obs.monotime()
    staging = out_dir / "ckpt_staging"
    writer = _is_writer(mesh)
    if writer:
        shutil.rmtree(staging, ignore_errors=True)
    _sync_ranks(mesh)  # no rank writes into a staging rank 0 clears
    extra = {"chunks_done": chunks_done, "rng_state": rng_state}
    for ensemble, _, name in ensembles:
        # one file a bucket: {name}_{j}, j in the group's bucket order
        for j, (_, sub) in enumerate(ensemble.buckets()):
            path = checkpoint_path(staging, f"{name}_{j}")
            if ckptr is None:
                save_ensemble(sub, path, extra=extra)
            else:
                ckptr.save(sub, path, extra=extra)
    if ckptr is not None:
        obs.record_span("sweep.checkpoint", obs.monotime() - t0,
                        chunks_done=chunks_done, backend="orbax")
        return
    if writer:
        nbytes = sum(p.stat().st_size for p in staging.iterdir())
        _swap_in_checkpoint_set(out_dir, staging)
        obs.record_span("sweep.checkpoint", obs.monotime() - t0,
                        chunks_done=chunks_done, bytes=nbytes,
                        backend="msgpack")
    _sync_ranks(mesh)


def _save_artifacts(ensembles, folder: Path, chunk, logger: MetricsLogger,
                    image_metrics: bool = False, guardian=None,
                    device="cpu", writer: bool = True) -> None:
    """Learned dicts and quick evals. Quarantined members are tagged
    ``diverged=True``, skipped by the evals and left out of the image
    panels: a NaN dictionary must never poison an eval. On a mesh every
    rank gathers the dicts and the ``writer`` (rank 0) alone evaluates
    and writes."""
    dicts = [_flat_dicts(ensemble) for ensemble, _, _ in ensembles]
    if not writer:
        return
    folder.mkdir(parents=True, exist_ok=True)
    sel = np.random.default_rng(0).permutation(chunk.shape[0])[:4096]
    # evals run in float32 even when training streams bfloat16
    rows = (chunk[torch.from_numpy(sel)] if isinstance(chunk, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(chunk[sel])))
    eval_batch = rows.to(device=device, dtype=torch.float32)
    for (ensemble, hypers, name), flat in zip(ensembles, dicts):
        tagged = list(zip(flat, hypers))
        if guardian is not None:
            tagged = guardian.tag_hypers(name, tagged)
        save_learned_dicts(tagged, folder / f"{name}_learned_dicts.pkl")
        evals, live = [], []
        for di, (ld, hyper) in enumerate(tagged):
            scalars = {k: v for k, v in hyper.items()
                       if isinstance(v, (int, float, str))}
            if hyper.get("diverged"):
                evals.append({**scalars, "skipped": True})
                continue
            ld = ld.to(device)
            live.append((di, ld))
            evals.append({**scalars,
                          "fvu": float(fraction_variance_unexplained(
                              ld, eval_batch)),
                          "l0": float(mean_l0(ld, eval_batch))})
        atomic_write_text(folder / f"{name}_eval.json",
                          json.dumps(evals, indent=2))
        if image_metrics:
            # the MMCS grid and per-dict sparsity histograms (the
            # reference's wandb image panels, as files)
            from sparse_coding_tpu_torch.plotting.helpers import plot_hist

            if len(live) > 1:
                grid = mmcs_from_list([ld for _, ld in live[:8]])
                atomic_save_npy(folder / f"{name}_mmcs_grid.npy",
                                grid.numpy())
            for di, ld in live:
                freqs = mean_nonzero_activations(ld, eval_batch)
                plot_hist(torch.log10(torch.clamp(freqs, min=1e-6)),
                          x_label="log10 firing frequency",
                          y_label="features",
                          save_path=folder / f"{name}_{di}_sparsity_hist.png")


def _restore_checkpoint_set(
        targets: Sequence[tuple[Ensemble, Path]]) -> tuple[int, Optional[dict]]:
    chunks_done: Optional[int] = None
    rng_state = None
    for ens, path in targets:
        meta = restore_ensemble(ens, path)
        done = int(meta.get("chunks_done", 0))
        if chunks_done is None or done < chunks_done:
            chunks_done = done
            rng_state = meta.get("rng_state", rng_state)
    return (chunks_done or 0), rng_state


def resume_sweep_state(ensembles: Sequence[tuple[EnsembleLike, list, str]],
                       out_dir: str | Path) -> tuple[int, Optional[dict]]:
    """Restore every ensemble from the newest complete checkpoint set;
    returns (chunks_done, the batch rng's bit-generator state), or (0,
    None) without a set. ``ckpt/`` only ever holds a consistent set;
    ``ckpt_prev/`` covers a crash inside the swap and a corrupt
    ``ckpt/``: a set failing its digests raises
    :class:`CheckpointCorruptionError` and the older set is tried. Only
    when every present set is corrupt does the error propagate — never a
    silent restart from scratch. min(chunks_done) over the set guards
    against an ensemble skipping a chunk it never trained on."""
    out_dir = Path(out_dir)
    last_err: Optional[CheckpointCorruptionError] = None
    for ckpt_dir in (out_dir / "ckpt", out_dir / "ckpt_prev"):
        if not ckpt_dir.exists():
            continue
        targets = [(sub, checkpoint_path(ckpt_dir, f"{name}_{j}"))
                   for ens, _, name in ensembles
                   for j, (_, sub) in enumerate(ens.buckets())]
        if not all(checkpoint_exists(path) for _, path in targets):
            continue  # incomplete set: fall through to the older one
        try:
            return _restore_checkpoint_set(targets)
        except CheckpointCorruptionError as e:
            last_err = e
            logger_mod.warning(
                "checkpoint set %s is corrupt (%s); falling back to the "
                "previous set", ckpt_dir.name, e)
    if last_err is not None:
        raise last_err
    return 0, None


def main(argv=None) -> None:
    """CLI: ``python -m sparse_coding_tpu_torch.train.sweep --experiment
    dense_l1_range --dataset_folder chunks/ --output_folder out/`` plus the
    sweep flags ``--synthetic``, ``--resume``, ``--device`` (default: the
    card), ``--log_every`` and ``--image_metrics_every`` (``none`` turns
    the image panels off) and any config flag."""
    import argparse
    import sys

    from sparse_coding_tpu_torch.train.experiments import EXPERIMENTS

    argv_list = list(argv) if argv is not None else sys.argv[1:]
    if "-h" in argv_list or "--help" in argv_list:
        print(f"sweep flags: --experiment {{{','.join(sorted(EXPERIMENTS))}}} "
              "--synthetic BOOL --resume BOOL --device DEV --log_every N "
              "--image_metrics_every N|none\nconfig flags:")
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--experiment", default="dense_l1_range",
                        choices=sorted(EXPERIMENTS))
    parser.add_argument("--synthetic", default="false")
    parser.add_argument("--resume", default="false")
    parser.add_argument("--device", default=None)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--image_metrics_every", default="10")
    ns, rest = parser.parse_known_args(argv_list)

    synthetic = _parse_value(ns.synthetic, bool)
    cfg = (SyntheticEnsembleArgs if synthetic else EnsembleArgs).from_cli(rest)
    every = (None if ns.image_metrics_every.lower() == "none"
             else int(ns.image_metrics_every))
    try:
        result = sweep(EXPERIMENTS[ns.experiment], cfg,
                       resume=_parse_value(ns.resume, bool),
                       device=ns.device, log_every=ns.log_every,
                       image_metrics_every=every)
    except SweepPreempted as e:
        # a SIGTERM shutdown is a success: the state is durable, and
        # --resume true continues bitwise
        print(f"sweep: {e}")
        return
    finally:
        shutdown_distributed()  # a mesh run's world; a no-op without one
    for name, dicts in result.items():
        print(f"{name}: {len(dicts)} dicts -> {cfg.output_folder}")


if __name__ == "__main__":
    main()
