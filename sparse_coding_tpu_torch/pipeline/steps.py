"""Built-in pipeline step children: the harvests, manifest, scrub, group,
sweep, eval and catalog (the port's counterpart of the JAX package's
``pipeline/steps.py``).

Each step is a subprocess entry point (``python -m
sparse_coding_tpu_torch.pipeline.steps <step> --config pipeline.json``)
obeying the crash-only contract the supervisor depends on:

- **re-runnable from scratch at any instant**: the harvests resume from
  the durable chunk prefix (``complete_chunk_count`` and a producer-row
  skip, or ``skip_chunks`` on the LM path), the sweep from its checkpoint
  sets (``resume=True``), eval and catalog are idempotent behind their
  output markers — so a SIGKILL anywhere costs only the unit of work in
  flight, and the finished run is bitwise the uninterrupted one;
- **heartbeats from the work loop** (:mod:`resilience.lease`), so a
  wedged step goes visibly stale;
- **every durable transition sits behind a named crash barrier**
  (:mod:`resilience.crash`).

**The device.** A step runs its entry points on the card: each takes
``device=None``, which ``resolve_device`` turns into ``cuda`` — and which
raises when there is no card. Only ``SPARSE_CODING_DEVICE`` (set by the
supervisor under ``cpu_only=True`` and on a journaled degrade-to-CPU)
moves a step elsewhere: its value is passed to every entry point as
``device``. The step's ``step.<name>`` span records the device the entry
points resolve, and ``card_peak_bytes``, the most the step held on a card
at once (0 for a step that never touched one).

**The synthetic stream.** The JAX harvest draws its batches from
``jax.random`` keys split off one seed; torch cannot reproduce those
streams (a deliberate deviation, as for ``data/synthetic.py``). Here
batch ``b`` is drawn from its own generator seeded by
``batch_seed(seed, b)`` on the step's device, always ``batch_rows`` rows
(the last batch the remainder), so a resumed harvest skips the batches
its durable chunks cover without drawing them and replays the rest to
the same bytes. The ground-truth dictionary comes from a generator
seeded by ``seed``.

Config file: one JSON object with ``harvest`` / ``scrub`` / ``group`` /
``sweep`` / ``eval`` / ``catalog`` sections, the JAX package's keys (see
each step function).
All seeds are explicit.
"""

from __future__ import annotations

import json
import os
import signal
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.resilience import lease
from sparse_coding_tpu_torch.resilience.atomic import atomic_write_text
from sparse_coding_tpu_torch.resilience.crash import (
    crash_barrier,
    register_crash_site,
)

register_crash_site("eval.write",
                    "pipeline eval step — results computed, output file "
                    "not yet written")

# the device every entry point of a step child runs on; unset = the card
ENV_DEVICE = "SPARSE_CODING_DEVICE"

class HarvestConfigError(ValueError):
    """Typed harvest-config contradiction: ``layer`` and ``layers`` given
    inconsistently, or a ``dataset_folder`` that is not the primary tap
    subfolder the multi-layer harvester writes."""


def run_harvest(config: dict, device=None) -> None:
    """``config["harvest"]`` keys — common: ``mode`` ("synthetic" | "lm"),
    ``dataset_folder`` (the chunk store the sweep reads; completion marker
    is its ``meta.json``), ``seed``. Synthetic: ``activation_dim``,
    ``n_ground_truth_features``, ``feature_num_nonzero``,
    ``feature_prob_decay``, ``dataset_size``, ``n_chunks``,
    ``batch_rows``, ``dtype``. LM: ``arch``, ``layer``/``layers``,
    ``layer_loc``, ``n_rows``, ``context_len``, ``model_batch_size``,
    ``chunk_size_gb`` — the dataset_folder must be the tap subfolder the
    harvester writes."""
    from sparse_coding_tpu_torch.data.chunk_store import clean_write_debris

    cfg = config["harvest"]
    folder = Path(cfg["dataset_folder"])
    if (folder / "meta.json").exists():
        return  # complete store: nothing to do (idempotent)
    folder.mkdir(parents=True, exist_ok=True)
    clean_write_debris(folder)  # tmp debris from a killed writer
    if cfg.get("mode", "synthetic") == "synthetic":
        _synthetic_harvest(cfg, device=device)
    else:
        _lm_harvest(cfg, device=device)


def batch_seed(seed: int, b: int) -> int:
    """The seed of synthetic batch ``b``'s generator."""
    return int(np.random.SeedSequence([int(seed), 1, int(b)])
               .generate_state(1, dtype=np.uint64)[0])


def _synthetic_harvest(cfg: dict, folder: Optional[Path] = None,
                       row_range: Optional[tuple] = None,
                       transform=None, extra_meta: Optional[dict] = None,
                       device=None) -> None:
    """Deterministic synthetic activation store with crash-resume: the
    batches already covered by durable chunks are skipped (each batch has
    its own seeded generator), the rest replayed, so the finished store —
    chunks, digests, meta — is byte-identical however many times the
    process died along the way. ``row_range=(lo, hi)`` writes only that
    slice of the stream into ``folder`` (a shard writer's rows);
    ``transform`` maps each kept float32 row block before it is written
    (the group harvest's per-layer mix) and ``extra_meta`` joins
    ``meta.json`` (its tap stamps)."""
    import torch

    from sparse_coding_tpu_torch import resolve_device
    from sparse_coding_tpu_torch.data.chunk_store import (
        ChunkWriter,
        complete_chunk_count,
    )
    from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator

    dev = resolve_device(device)
    folder = Path(cfg["dataset_folder"]) if folder is None else folder
    dim = int(cfg["activation_dim"])
    total = int(cfg["dataset_size"])
    n_chunks = int(cfg.get("n_chunks", 4))
    seed = int(cfg.get("seed", 0))
    dtype = cfg.get("dtype", "float16")
    rows_per_chunk = total // n_chunks
    bytes_per_row = dim * np.dtype(np.float16 if dtype == "float16"
                                   else np.float32).itemsize
    lo_row, hi_row = row_range if row_range is not None else (0, total)
    k = complete_chunk_count(folder)
    gen = RandomDatasetGenerator.create(
        torch.Generator(dev).manual_seed(seed), dim,
        int(cfg["n_ground_truth_features"]),
        int(cfg.get("feature_num_nonzero", 5)),
        float(cfg.get("feature_prob_decay", 0.99)),
        correlated=bool(cfg.get("correlated_components", False)))
    writer = ChunkWriter(folder, dim,
                         chunk_size_gb=rows_per_chunk * bytes_per_row / 2**30,
                         dtype=dtype, start_index=k)
    skip_rows = lo_row + k * writer.rows_per_chunk
    batch_rows = int(cfg.get("batch_rows", 8192))
    produced, b = 0, 0
    while produced < hi_row:
        n = min(total - produced, batch_rows)
        if produced + n > skip_rows:
            g = torch.Generator(dev).manual_seed(batch_seed(seed, b))
            batch = gen.batch(g, n).to("cpu", torch.float32).numpy()
            b_lo = max(0, skip_rows - produced)
            b_hi = min(n, hi_row - produced)
            if b_hi > b_lo:
                kept = batch[b_lo:b_hi]
                writer.add(transform(kept) if transform is not None
                           else kept)
        produced += n
        b += 1
        lease.beat()
    writer.finalize({"synthetic": True, "seed": seed,
                     **({"row_range": [lo_row, hi_row]}
                        if row_range is not None else {}),
                     **(extra_meta or {})})


def _resolve_layers(cfg: dict) -> list[int]:
    """The harvest layer list: ``layers`` with ``layer`` kept as the
    single-tap alias; both given must agree."""
    layers, layer = cfg.get("layers"), cfg.get("layer")
    if layers is None:
        return [int(layer if layer is not None else 1)]
    layers = [int(v) for v in layers]
    if not layers:
        raise HarvestConfigError("harvest.layers must be non-empty")
    if layer is not None and int(layer) not in layers:
        raise HarvestConfigError(
            f"harvest.layer={int(layer)} contradicts "
            f"harvest.layers={layers} — drop the alias or include it")
    return layers


def _lm_harvest(cfg: dict, tap_dirs: Optional[dict] = None,
                device=None) -> None:
    """Tiny-LM harvest through the real ``harvest_activations`` path
    (``tiny_test_config``'s shapes, random weights from a torch generator
    seeded by ``seed``, seeded numpy token rows — no network), resuming
    via ``skip_chunks`` from the shortest durable tap prefix. Multi-tap
    when ``layers`` lists several: ``dataset_folder`` must be the PRIMARY
    (first) tap subfolder, the step's completion marker; ``tap_dirs``
    remaps tap → folder (the group harvest's shards)."""
    import torch

    from sparse_coding_tpu_torch.data.chunk_store import complete_chunk_count
    from sparse_coding_tpu_torch.data.harvest import harvest_activations
    from sparse_coding_tpu_torch.lm.hooks import tap_name, taps_for
    from sparse_coding_tpu_torch.lm.model_config import tiny_test_config

    folder = Path(cfg["dataset_folder"])
    layers = _resolve_layers(cfg)
    layer_loc = cfg.get("layer_loc", "residual")
    taps = taps_for(layers, layer_loc)
    tap_dirs = dict(tap_dirs or {})
    if not tap_dirs and folder.name != tap_name(layers[0], layer_loc):
        raise HarvestConfigError(
            f"harvest.dataset_folder must be the primary tap subfolder "
            f"{tap_name(layers[0], layer_loc)!r} the harvester writes "
            f"(got {folder.name!r})")
    arch = cfg.get("arch", "gptneox")
    lm_cfg = tiny_test_config(arch)
    if arch == "gptneox":
        from sparse_coding_tpu_torch.lm.gptneox import init_params
    else:
        from sparse_coding_tpu_torch.lm.gpt2 import init_params
    seed = int(cfg.get("seed", 0))
    params = init_params(torch.Generator().manual_seed(seed), lm_cfg,
                         device=device)
    rng = np.random.default_rng(seed)
    token_rows = rng.integers(
        0, lm_cfg.vocab_size,
        (int(cfg["n_rows"]), int(cfg.get("context_len", 16))))
    # one forward feeds every tap's writer, so resume from the shortest
    # durable prefix; a tap ahead of the others re-seals idempotently
    skip = min(complete_chunk_count(Path(tap_dirs.get(t, folder.parent / t)))
               for t in taps)
    harvest_activations(
        params, lm_cfg, token_rows, layers, layer_loc, folder.parent,
        model_batch_size=int(cfg.get("model_batch_size", 2)),
        chunk_size_gb=float(cfg["chunk_size_gb"]), skip_chunks=skip,
        dtype=cfg.get("dtype", "float16"), tap_dirs=tap_dirs or None,
        device=device)


def run_shard_harvest(config: dict, shard: int, device=None) -> None:
    """One harvest writer owning one shard: ``config["harvest"]`` plus
    ``n_shards`` — this child writes ``<dataset_folder>/shard-<i>/`` and
    nothing else, rows ``[i*per_shard, (i+1)*per_shard)`` of the same
    seeded stream the unsharded harvest replays (so the shard-major
    concatenation is bitwise the unsharded harvest), then seals it
    (``shard.finalize`` crash barrier inside ``write_shard_digest``)."""
    from sparse_coding_tpu_torch.data.chunk_store import clean_write_debris
    from sparse_coding_tpu_torch.data.shard_store import (
        shard_name,
        write_shard_digest,
    )

    cfg = config["harvest"]
    if cfg.get("mode", "synthetic") != "synthetic":
        raise ValueError(
            "sharded harvest currently supports mode='synthetic' only "
            "(the LM path needs a token-row partitioner first)")
    n_shards = int(cfg["n_shards"])
    shard = int(shard)
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range [0, {n_shards})")
    total = int(cfg["dataset_size"])
    n_chunks = int(cfg.get("n_chunks", 4))
    if total % n_chunks or n_chunks % n_shards:
        raise ValueError(
            f"dataset_size={total} must divide into n_chunks={n_chunks} "
            f"and n_chunks into n_shards={n_shards} for bitwise-stable "
            "shard boundaries")
    folder = Path(cfg["dataset_folder"]) / shard_name(shard)
    per_shard = total // n_shards
    if not (folder / "meta.json").exists():
        folder.mkdir(parents=True, exist_ok=True)
        clean_write_debris(folder)
        _synthetic_harvest(cfg, folder=folder,
                           row_range=(shard * per_shard,
                                      (shard + 1) * per_shard),
                           device=device)
    write_shard_digest(folder)


def _layer_mixer(dim: int, layer: int, seed: int, phase_step: float):
    """Deterministic per-layer mix for the synthetic multi-tap harvest:
    ``x ↦ cos(φ)·x + sin(φ)·(x·Q)`` with one orthogonal Q shared by all
    layers and φ = phase_step·layer, so two layers' rows subtend angle
    ≈ |φ_i − φ_j| and adjacent layers are measurably more similar — the
    Group-SAE premise (arXiv 2410.21508 §3), reproduced synthetically.
    Pure rowwise numpy on the host (bitwise the JAX package's), a function
    of (dim, layer, seed) only — resume replays bitwise."""
    q, _ = np.linalg.qr(
        np.random.default_rng(int(seed) + 7919).normal(size=(dim, dim)))
    q = q.astype(np.float32)
    c, s = np.float32(np.cos(phase_step * layer)), \
        np.float32(np.sin(phase_step * layer))

    def mix(rows: np.ndarray) -> np.ndarray:
        x = rows.astype(np.float32, copy=False)
        return c * x + s * (x @ q)

    return mix


def run_group_harvest(config: dict, shard: int, device=None) -> None:
    """One multi-tap writer owning one layer (= one shard of the
    multi-tap store): ``config["harvest"]`` plus ``layers`` — child ``i``
    harvests layer ``layers[i]`` into ``<dataset_folder>/shard-<i>/`` and
    nothing else. Taps are shards: the sealed-shard layout, the manifest
    step, scrub and fsck's shard checkers carry the multi-tap store
    unchanged, and the DAG has no edges between the writers.

    Every writer replays the SAME producer stream over all rows, so row
    ``r`` of shard ``i`` and row ``r`` of shard ``j`` are the same input
    observed at two depths — the row alignment ``groups/similarity.py``
    depends on. Synthetic mode applies the deterministic per-layer mix
    (``_layer_mixer``); LM mode runs the real ``harvest_activations`` with
    this child's tap remapped to its shard dir. ``meta.json`` carries the
    shard's ``tap``/``layer``/``layer_loc``. Resume and seal follow
    ``run_shard_harvest``: durable chunk prefix + row skip, an idempotent
    re-seal behind the ``shard.finalize`` crash barrier."""
    from sparse_coding_tpu_torch.data.chunk_store import clean_write_debris
    from sparse_coding_tpu_torch.data.shard_store import (
        shard_name,
        write_shard_digest,
    )
    from sparse_coding_tpu_torch.lm.hooks import tap_name

    cfg = config["harvest"]
    layers = _resolve_layers(cfg)
    shard = int(shard)
    if not 0 <= shard < len(layers):
        raise ValueError(f"shard {shard} out of range [0, {len(layers)})")
    layer = layers[shard]
    layer_loc = cfg.get("layer_loc", "residual")
    tap = tap_name(layer, layer_loc)
    folder = Path(cfg["dataset_folder"]) / shard_name(shard)
    if not (folder / "meta.json").exists():
        folder.mkdir(parents=True, exist_ok=True)
        clean_write_debris(folder)  # tmp debris from a killed writer
        if cfg.get("mode", "synthetic") == "synthetic":
            mixer = _layer_mixer(int(cfg["activation_dim"]), layer,
                                 int(cfg.get("seed", 0)),
                                 float(cfg.get("phase_step", 0.35)))
            _synthetic_harvest(cfg, folder=folder, transform=mixer,
                               extra_meta={"tap": tap, "layer": layer,
                                           "layer_loc": layer_loc},
                               device=device)
        else:
            _lm_harvest({**cfg, "layers": [layer], "layer": layer,
                         "dataset_folder": str(folder)},
                        tap_dirs={tap: folder}, device=device)
    # seal (idempotent): meta durable -> crash barrier -> shard.digest
    write_shard_digest(folder)


def run_group(config: dict, device=None) -> None:
    """``config["group"]`` keys: ``n_groups``, optional
    ``n_sample_chunks`` / ``n_sample_rows`` / ``seed``. Similarity pass
    + greedy adjacent assignment over the multi-tap store, finalizing
    ``groups.json``. Host numpy only, like scrub: the step runs on a host
    whose card is wedged. Idempotent behind a digest-sound
    ``groups.json`` (a rotted marker is rebuilt, byte-deterministic); a
    killed build rebuilds identically (crash barrier
    ``groups.finalize``)."""
    from sparse_coding_tpu_torch.groups.assign import (
        GroupBuildError,
        build_groups,
        load_groups,
    )

    cfg = config.get("group", {})
    store = Path(config["harvest"]["dataset_folder"])
    try:
        load_groups(store)
        return  # digest-sound completion marker: idempotent skip
    except (FileNotFoundError, GroupBuildError):
        pass  # absent or rotted: (re)build overwrites atomically
    build_groups(store, n_groups=int(cfg.get("n_groups", 2)),
                 n_sample_chunks=int(cfg.get("n_sample_chunks", 1)),
                 n_sample_rows=int(cfg.get("n_sample_rows", 2048)),
                 seed=int(cfg.get("seed", 0)))


def run_store_manifest(config: dict, device=None) -> None:
    """Aggregate the sealed shards into the store-level manifest: the
    sharded harvest's ``n_shards``, or one shard per layer for the group
    (multi-tap) harvest. A manifest already at this run's shard count is
    an idempotent skip; one from a different shard count is rebuilt
    (byte-deterministic)."""
    from sparse_coding_tpu_torch.data.shard_store import (
        build_store_manifest,
        read_store_manifest,
    )

    cfg = config["harvest"]
    folder = Path(cfg["dataset_folder"])
    n_shards = (int(cfg["n_shards"]) if "n_shards" in cfg
                else len(_resolve_layers(cfg)))
    existing = read_store_manifest(folder)
    if existing is not None and int(existing.get("n_shards", -1)) == n_shards:
        return
    build_store_manifest(folder, expect_shards=n_shards)


SCRUB_MARKER_NAME = "scrub.done.json"


def scrub_marker_path() -> Optional[Path]:
    """The run-scoped scrub completion marker
    ``<run_dir>/scrub.done.json``, from the obs dir the supervisor exports
    (``<run_dir>/obs``); None outside a supervised run."""
    obs_dir = os.environ.get(obs.ENV_OBS_DIR)
    if not obs_dir:
        return None
    return Path(obs_dir).parent / SCRUB_MARKER_NAME


def run_scrub(config: dict, device=None) -> None:
    """Re-verify every chunk digest between harvest and sweep,
    quarantine/repair corrupt chunks (``config["scrub"]["repair"]``,
    default true). The marker is run-scoped, so a later run over the same
    store scrubs again; the scrub itself is idempotent."""
    from sparse_coding_tpu_torch.data.scrub import scrub_store

    cfg = config.get("scrub", {})
    store = Path(config["harvest"]["dataset_folder"])
    marker = scrub_marker_path()
    if marker is not None and marker.exists():
        return
    report = scrub_store(store, repair=bool(cfg.get("repair", True)))
    if marker is not None:
        atomic_write_text(marker,
                          json.dumps(report, indent=2, sort_keys=True))


def _final_dicts_path(config: dict) -> Path:
    name = config["sweep"].get("experiment", "dense_l1_range")
    return (Path(config["sweep"]["ensemble"]["output_folder"]) / "final"
            / f"{name}_learned_dicts.pkl")


def run_sweep(config: dict, device=None) -> None:
    """``config["sweep"]`` keys: ``experiment`` (EXPERIMENTS registry
    name), ``ensemble`` (EnsembleArgs fields), ``log_every``. Always
    ``resume=True``: a fresh run resumes from nothing, a killed run from
    its newest complete checkpoint set. The completion marker
    ``<output>/final/<name>_learned_dicts.pkl`` is written here from the
    end state, so it exists even when the resume had no chunk left to
    train — which makes "retry after any kill" converge."""
    import sparse_coding_tpu_torch.train.sweep as sweep_mod
    from sparse_coding_tpu_torch.config import EnsembleArgs
    from sparse_coding_tpu_torch.train.experiments import EXPERIMENTS
    from sparse_coding_tpu_torch.utils.artifacts import save_learned_dicts

    cfg = config["sweep"]
    ens_cfg = EnsembleArgs(**cfg["ensemble"])
    result = sweep_mod.sweep(
        EXPERIMENTS[cfg.get("experiment", "dense_l1_range")], ens_cfg,
        resume=True, log_every=int(cfg.get("log_every", 100)),
        image_metrics_every=None, device=device)
    final = Path(ens_cfg.output_folder) / "final"
    for name, tagged in result.items():
        save_learned_dicts(tagged, final / f"{name}_learned_dicts.pkl")


def run_eval(config: dict, device=None) -> None:
    """``config["eval"]`` keys: ``output_folder``, ``n_eval_rows``,
    ``seed``. Scores every dictionary of the sweep's final artifact (FVU
    and mean L0 on a seeded slice of the first sound chunk) and writes
    ``eval.json`` atomically behind the ``eval.write`` crash barrier."""
    import torch

    from sparse_coding_tpu_torch import resolve_device
    from sparse_coding_tpu_torch.data.shard_store import (
        first_sound_chunk,
        open_store,
    )
    from sparse_coding_tpu_torch.metrics.core import (
        fraction_variance_unexplained,
        mean_l0,
    )
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    cfg = config["eval"]
    out = Path(cfg["output_folder"])
    marker = out / "eval.json"
    if marker.exists():
        return
    dev = resolve_device(device)
    out.mkdir(parents=True, exist_ok=True)
    name = config["sweep"].get("experiment", "dense_l1_range")
    tagged = load_learned_dicts(_final_dicts_path(config))
    store = open_store(config["harvest"]["dataset_folder"],
                       quarantine_corrupt=True)
    # a scrub-repaired store still evaluates: it skips the holes
    chunk = store.load_chunk(first_sound_chunk(store))
    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    rows = rng.permutation(chunk.shape[0])[:int(cfg.get("n_eval_rows", 2048))]
    eval_batch = torch.as_tensor(
        np.asarray(chunk[rows], np.float32)).to(dev)
    records = []
    for ld, hyper in tagged:
        ld = ld.to(dev)
        records.append({
            **{k: v for k, v in hyper.items()
               if isinstance(v, (int, float, str, bool))},
            "fvu": float(fraction_variance_unexplained(ld, eval_batch)),
            "l0": float(mean_l0(ld, eval_batch))})
        lease.beat()
    crash_barrier("eval.write")
    atomic_write_text(marker, json.dumps(
        {"experiment": name, "n_eval_rows": int(len(rows)),
         "dicts": records}, indent=2))


def run_catalog(config: dict, device=None) -> None:
    """``config["catalog"]`` keys: ``output_folder``, optional
    ``dead_threshold`` and ``group``. Builds the feature index from the
    sweep's final artifact and the harvest's chunk store, idempotent
    behind ``index.json`` (written behind the ``catalog.finalize`` crash
    barrier); a killed build rebuilds byte-identically."""
    from sparse_coding_tpu_torch.catalog.build import build_catalog

    cfg = config["catalog"]
    out = Path(cfg["output_folder"])
    if (out / "index.json").exists():
        return
    build_catalog(_final_dicts_path(config),
                  config["harvest"]["dataset_folder"], out,
                  dead_threshold=float(cfg.get("dead_threshold", 0.0)),
                  experiment=config["sweep"].get("experiment",
                                                 "dense_l1_range"),
                  group=cfg.get("group"), device=device)


STEPS = {"harvest": run_harvest, "shard_harvest": run_shard_harvest,
         "group_harvest": run_group_harvest, "group": run_group,
         "manifest": run_store_manifest, "scrub": run_scrub,
         "sweep": run_sweep, "eval": run_eval, "catalog": run_catalog}

_SHARDED_STEPS = {"shard_harvest", "group_harvest"}


def _card_peak_bytes() -> int:
    """The most bytes this process held at once on any card (0 when it
    allocated on none; asking initializes nothing)."""
    import torch

    if not torch.cuda.is_initialized():
        return 0
    return max((torch.cuda.memory_stats(i).get("allocated_bytes.all.peak", 0)
                for i in range(torch.cuda.device_count())), default=0)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    shard = None
    if "--shard" in argv:
        at = argv.index("--shard")
        if at + 1 >= len(argv) or not argv[at + 1].lstrip("-").isdigit():
            raise SystemExit("--shard requires an integer value")
        shard = int(argv[at + 1])
        del argv[at:at + 2]
    if len(argv) != 3 or argv[1] != "--config" or argv[0] not in STEPS \
            or (argv[0] in _SHARDED_STEPS) != (shard is not None):
        raise SystemExit(
            f"usage: python -m sparse_coding_tpu_torch.pipeline.steps "
            f"{{{'|'.join(STEPS)}}} --config pipeline.json "
            "[--shard I  (shard_harvest/group_harvest only)]")
    step, config_path = argv[0], argv[2]
    # claim the lease before any real work: from here on, silence = hang
    lease.configure_from_env(step=step)
    # join the run's event stream (a no-op outside a supervisor)
    obs.configure_sink_from_env(step)
    # the capture cache's warmup manifest, shared by every child of a run
    from sparse_coding_tpu_torch import xcache

    xcache.enable_from_env()
    config = json.loads(Path(config_path).read_text())
    device = os.environ.get(ENV_DEVICE, "").strip() or None
    if step == "sweep":
        # the sweep's graceful SIGTERM path ends in a checkpoint and a typed
        # exit. This outer guard holds a signal as a flag for the child's
        # whole life: one that lands before the sweep opens its own guard
        # is taken over by it (a checkpoint after the first chunk, then
        # exit 75), and a fleet scheduler's repeat that lands after that
        # guard has closed is absorbed. The exit path below ignores
        # SIGTERM outright, since the interpreter's finalization resets
        # Python-level handlers to the default, which kills.
        from sparse_coding_tpu_torch.resilience.preempt import PreemptionGuard

        PreemptionGuard().__enter__()
    try:
        from sparse_coding_tpu_torch import resolve_device

        # the device the entry points resolve (raises with no card), and
        # what the step held there: 0 bytes = it never ran on a card
        with obs.span(f"step.{step}",
                      device=resolve_device(device).type) as sp:
            try:
                if shard is not None:
                    STEPS[step](config, shard, device=device)
                else:
                    STEPS[step](config, device=device)
            finally:
                sp.attrs["card_peak_bytes"] = _card_peak_bytes()
    except BaseException as e:
        # the two structured shutdowns leave as typed exit codes
        # (pipeline/supervisor.py maps them back); everything else
        # propagates as a plain failure
        from sparse_coding_tpu_torch.pipeline.supervisor import (
            STEP_EXIT_HALTED,
            STEP_EXIT_PREEMPTED,
        )
        from sparse_coding_tpu_torch.resilience.errors import (
            DivergenceHaltError,
        )
        from sparse_coding_tpu_torch.resilience.preempt import SweepPreempted

        if isinstance(e, SweepPreempted):
            print(f"step {step}: {e}", file=sys.stderr)
            raise SystemExit(STEP_EXIT_PREEMPTED) from e
        if isinstance(e, DivergenceHaltError):
            print(f"step {step}: {e}", file=sys.stderr)
            raise SystemExit(STEP_EXIT_HALTED) from e
        raise
    finally:
        if step == "sweep":
            signal.signal(signal.SIGTERM, signal.SIG_IGN)  # outcome decided
        obs.update_memory_gauges()
        obs.flush_metrics()
        obs.close_sink()


if __name__ == "__main__":
    main()
