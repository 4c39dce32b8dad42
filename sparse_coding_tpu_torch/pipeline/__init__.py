"""Crash-only pipeline supervision (the port's counterpart of the JAX
package's ``pipeline/``):

- :mod:`journal`    — the append-only run journal (the supervisor's only
  memory; atomic appends, artifacts beat the journal);
- :mod:`supervisor` — the step DAG runner: child processes on the card,
  lease takeover, SIGKILL recovery, the hang watchdog's card probe,
  degrade-to-CPU, the resume preflight fsck and the run's perf-ledger
  row;
- :mod:`steps`      — the built-in resumable step children (harvest,
  shard_harvest, manifest, scrub, sweep, eval, catalog);
- :mod:`plane`      — the elastic plane's ``Hysteresis`` (the serving
  gateway's ladder flap guard).

The fleet (``fleet.py``, ``fleet_queue.py``, ``placement.py``, the
plane's arbiter) and the groups' steps are ROADMAP.md queue 1, items 18
and 19.
"""

import importlib

# lazy attribute resolution: ``python -m
# sparse_coding_tpu_torch.pipeline.steps`` is a runpy entry point, and an
# eager import here would load that module twice
_LAZY_ATTRS = {
    "RunJournal": ("sparse_coding_tpu_torch.pipeline.journal", "RunJournal"),
    "Hysteresis": ("sparse_coding_tpu_torch.pipeline.plane", "Hysteresis"),
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
