"""Crash-only pipeline supervision and the fleet (the port's counterpart
of the JAX package's ``pipeline/``):

- :mod:`journal`    — the append-only run journal (the supervisor's only
  memory; atomic appends, artifacts beat the journal);
- :mod:`supervisor` — the step DAG runner: child processes on the card,
  lease takeover, SIGKILL recovery, the hang watchdog's card probe,
  degrade-to-CPU, the resume preflight fsck and the run's perf-ledger
  row; the flat, sharded and group (multi-tap) DAGs;
- :mod:`steps`      — the built-in resumable step children (harvest,
  shard_harvest, group_harvest, manifest, scrub, group, sweep, eval,
  catalog);
- :mod:`fleet` / :mod:`fleet_queue` / :mod:`placement` — the fleet
  scheduler: a durable bitwise-replay run queue bin-packed onto slices
  with serve/slo.py's priority classes, per-run worker subprocesses (one
  Supervisor each), chunk-boundary SIGTERM preemption and per-tenant
  guardian-halt containment;
- :mod:`plane`      — the elastic plane: one arbiter trading slices
  between the serving gateway's replica pool and the fleet's scavenger
  tenants, with durable rebalance records in the fleet queue journal,
  zero-capture warm-spare scale-up, SIGTERM-checkpoint reclaim and
  hysteresis against flapping load (its ``Hysteresis`` is also the
  serving gateway's ladder flap guard).
"""

import importlib

# lazy attribute resolution: ``python -m
# sparse_coding_tpu_torch.pipeline.steps`` is a runpy entry point, and an
# eager import here would load that module twice
_LAZY_ATTRS = {
    "FleetScheduler": ("sparse_coding_tpu_torch.pipeline.fleet",
                       "FleetScheduler"),
    "run_worker": ("sparse_coding_tpu_torch.pipeline.fleet", "run_worker"),
    "FleetQueue": ("sparse_coding_tpu_torch.pipeline.fleet_queue",
                   "FleetQueue"),
    "FleetState": ("sparse_coding_tpu_torch.pipeline.fleet_queue",
                   "FleetState"),
    "RunJournal": ("sparse_coding_tpu_torch.pipeline.journal", "RunJournal"),
    "PlacementPlan": ("sparse_coding_tpu_torch.pipeline.placement",
                      "PlacementPlan"),
    "RunState": ("sparse_coding_tpu_torch.pipeline.placement", "RunState"),
    "plan_placement": ("sparse_coding_tpu_torch.pipeline.placement",
                       "plan_placement"),
    "ElasticPlane": ("sparse_coding_tpu_torch.pipeline.plane",
                     "ElasticPlane"),
    "Hysteresis": ("sparse_coding_tpu_torch.pipeline.plane", "Hysteresis"),
    "PlaneConfig": ("sparse_coding_tpu_torch.pipeline.plane", "PlaneConfig"),
    "PlaneSplit": ("sparse_coding_tpu_torch.pipeline.plane", "PlaneSplit"),
    "desired_replicas": ("sparse_coding_tpu_torch.pipeline.plane",
                         "desired_replicas"),
    "replay_split": ("sparse_coding_tpu_torch.pipeline.plane",
                     "replay_split"),
}
for _name in ("STEP_EXIT_HALTED", "STEP_EXIT_PREEMPTED",
              "ConcurrentSupervisorError", "PipelineError",
              "PreflightAuditError", "Step",
              "StepFailed", "StepHalted", "StepHung", "StepPreempted",
              "Supervisor", "build_group_pipeline",
              "build_group_tenant_pipeline", "build_pipeline",
              "build_sharded_pipeline",
              "load_or_create_run_id", "step_argv", "supervise_bench"):
    _LAZY_ATTRS[_name] = ("sparse_coding_tpu_torch.pipeline.supervisor",
                          _name)

__all__ = sorted(_LAZY_ATTRS)


def __getattr__(name):
    if name in _LAZY_ATTRS:
        module, attr = _LAZY_ATTRS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'sparse_coding_tpu_torch.pipeline' has no attribute "
        f"{name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_ATTRS))
