"""One fleet tenant per group: pooled-store training configs + enqueue
(the port's copy of the JAX package's ``groups/tenants.py``).

The Group-SAE training plane is DELIBERATELY not a new scheduler: after
the ``group`` step finalizes ``groups.json``, each group becomes an
ordinary fleet tenant (``pipeline/fleet.py``) whose pipeline is
``sweep → eval (→ catalog)`` over the group's pooled store view
``<store>/group-<g>/`` (``kind="group"`` — no harvest edge: the pooled
chunks are the multi-tap harvest's, referenced relatively).
Guardian halts stay contained per group (one diverging group's tenant
exits ``STEP_EXIT_HALTED`` inside its own run dir while the others
complete), every tenant after the first loads the kernel libraries
already built in ``ops/_build/`` (no nvcc run), and the scheduler's
bin-packing/preemption applies unchanged.

Host code only: nothing here touches the card.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional

from sparse_coding_tpu_torch.groups.assign import load_groups


def group_tenant_config(base_config: dict, group: dict,
                        store_dir: str | Path,
                        out_root: str | Path) -> dict:
    """Derive one group tenant's pipeline config from a base config
    (sweep/eval/catalog sections supply hyperparameters): the tenant
    trains on ``<store>/<group name>/`` (the pooled view) and writes all
    artifacts under ``<out_root>/<group name>/``. The group name is
    stamped into the sweep/eval/catalog sections so every downstream
    artifact — catalog index rows included — carries its group label."""
    cfg = copy.deepcopy(base_config)
    gname = str(group["name"])
    gdir = Path(store_dir) / gname
    out = Path(out_root) / gname
    # eval/catalog read the store through config["harvest"]; the pooled
    # view is already durable, so the tenant pipeline has no harvest step
    cfg["harvest"] = {"dataset_folder": str(gdir)}
    ens = cfg["sweep"]["ensemble"]
    ens["dataset_folder"] = str(gdir)
    ens["output_folder"] = str(out / "sweep")
    # the pooled store concatenates the member layers' chunks
    ens["n_chunks"] = int(group["n_chunks"])
    cfg["sweep"]["group"] = gname
    cfg["eval"] = {**cfg.get("eval", {}), "output_folder": str(out / "eval")}
    if "catalog" in cfg:
        cfg["catalog"] = {**cfg["catalog"],
                          "output_folder": str(out / "catalog"),
                          "group": gname}
    return cfg


def enqueue_group_tenants(sched, store_dir: str | Path, base_config: dict,
                          out_root: str | Path, *,
                          priority: str = "batch",
                          env: Optional[dict] = None,
                          max_attempts: int = 2,
                          heartbeat_stale_s: Optional[float] = None,
                          env_overrides: Optional[dict] = None) -> list[str]:
    """Enqueue one ``kind="group"`` tenant per group of the finalized
    assignment (idempotent per name — the queue dedupes). Returns the
    tenant names in group order. ``env_overrides`` maps a group name to
    extra per-tenant env (the containment drill poisons exactly one)."""
    payload = load_groups(store_dir)
    names: list[str] = []
    for group in payload["groups"]:
        cfg = group_tenant_config(base_config, group, store_dir, out_root)
        tenant_env = dict(env or {})
        tenant_env.update((env_overrides or {}).get(group["name"], {}))
        sched.enqueue(group["name"], cfg, kind="group", priority=priority,
                      env=tenant_env, max_attempts=max_attempts,
                      heartbeat_stale_s=heartbeat_stale_s)
        names.append(group["name"])
    return names
