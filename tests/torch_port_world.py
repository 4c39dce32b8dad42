"""One rank of a gloo world for the port's mesh tests.

Run as ``python torch_port_world.py CASE RANK WORLD STORE OUT [ARGS...]``:
the rank joins the world through a ``FileStore`` at STORE (no TCP port,
so concurrent test workers never collide), runs CASE and writes its
result to ``OUT/<CASE>_<RANK>.pt``. The parent test starts every rank
(``torch_port_helpers.run_world``), waits with a timeout and kills any
survivor. This module imports torch and the port only.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _mesh(shape):
    from sparse_coding_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(int(shape[0]), int(shape[1]), device="cpu")


def case_agree(rank: int, world: int, args) -> dict:
    """agree_any both ways, and the mesh's collectives on a 2 × 2 mesh."""
    from sparse_coding_tpu_torch.parallel import agree_any

    mesh = _mesh((2, world // 2))
    t = torch.arange(3, dtype=torch.float32) + 10 * rank
    return {
        "one": agree_any(rank == world - 1, "test-one"),
        "none": agree_any(False, "test-none"),
        "coords": (mesh.coords["model"], mesh.coords["data"]),
        "data": mesh.psum(t, "data"),
        "model": mesh.psum(t, "model"),
        "both": mesh.psum([t, t.to(torch.int32)], ("model", "data")),
        "gather": mesh.all_gather(t[None], "model"),
        "all_true": bool(mesh.all_true(torch.tensor(rank != 1), "data")),
    }


def case_train(rank: int, world: int, args) -> dict:
    """The inputs' ensemble cases, then their big-SAE cases, on an
    ``args[0]`` × ``args[1]`` mesh."""
    with open(args[2], "rb") as f:
        inp = pickle.load(f)
    mesh = _mesh((args[0], args[1]))
    return {"ensemble": _ensembles(mesh, inp["ensemble"]),
            "big_sae": _big_saes(mesh, inp["big_sae"])}


def _ensembles(mesh, inp: dict) -> dict:
    """Each case on the mesh: the full params after the steps, the last
    aux, the resolved path; with ``frozen``, that member frozen after the
    first step."""
    import sparse_coding_tpu_torch.models.sae  # noqa: F401 (registers)
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.signatures import get_signature
    from sparse_coding_tpu_torch.utils.carry import members_from_numpy

    out = {}
    for key, (sig_name, path, frozen) in inp["cases"].items():
        sig = get_signature(sig_name)
        ens = Ensemble(members_from_numpy(inp["members"][sig_name]), sig,
                       lr=inp["lr"], mesh=mesh, use_fused=path is not None,
                       fused_path=path)
        batches = torch.from_numpy(inp["batches"])
        rec = {}
        for i, batch in enumerate(batches):
            if frozen is not None and i == 1:
                ens.freeze_members([frozen])
                full = ens.full_state()
                rec["before"] = {k: v.clone() for k, v in full.params.items()}
                rec["before_mu"] = {k: v.clone() for k, v in full.mu.items()}
            aux = ens.step_batch(batch)
        full = ens.full_state()
        rec.update(params=full.params, mu=full.mu, losses=aux.losses,
                   l0=aux.l0, activity=aux.feat_activity,
                   finite=aux.finite, grad_norm=aux.grad_norm,
                   path=ens.fused_path, live=ens.live_mask(),
                   local_members=ens.state.n_members)
        out[key] = rec
    return out


def _big_saes(mesh, inp: dict) -> dict:
    """The big SAE's mesh step over each case's batches: the metrics of
    every step, the gathered final state and a resurrection of it."""
    from sparse_coding_tpu_torch.train import big_sae as tbs
    from sparse_coding_tpu_torch.utils.carry import big_state_from_numpy

    out = {}
    for key, case in inp["cases"].items():
        state = tbs.shard_big_sae(big_state_from_numpy(**case["state"]),
                                  mesh)
        step = tbs.make_big_sae_step(
            tbs.BigSAEAdam(inp["lr"]), torch.tensor(inp["l1"]), mesh=mesh,
            fused_compute_dtype=case.get("compute_dtype", "float32"))
        metrics = []
        for batch in torch.from_numpy(inp["batches"]):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        resurrected, n_dead = tbs.resurrect_dead_features(state, mesh)
        full = tbs.gather_big_sae(state, mesh)
        out[key] = {"metrics": metrics, "params": full.params,
                    "c_totals": full.c_totals,
                    "worst_losses": full.worst_losses,
                    "n_dead": int(n_dead),
                    "resurrected": tbs.gather_big_sae(resurrected,
                                                      mesh).params}
    return out


def case_sweep(rank: int, world: int, args) -> dict:
    """The port's sweep for each spec of a list (its mesh from mesh_model
    and mesh_data). ``mode``: ``run``, ``preempt`` (rank 1 takes a
    SIGTERM at the end of each sweep's first chunk) or ``resume``."""
    from sparse_coding_tpu_torch.config import EnsembleArgs
    from sparse_coding_tpu_torch.resilience.preempt import SweepPreempted
    from sparse_coding_tpu_torch.train import experiments as texp
    from sparse_coding_tpu_torch.train import sweep as tsweep

    mode, specs = args[0], json.loads(Path(args[1]).read_text())
    if mode == "preempt" and rank == 1:
        barrier = tsweep.crash_barrier
        fired = []

        def signal_once(site):
            if site == "sweep.chunk" and not fired:
                fired.append(site)
                os.kill(os.getpid(), signal.SIGTERM)
            return barrier(site)

        tsweep.crash_barrier = signal_once
    out = []
    for spec in specs:
        if mode == "preempt" and rank == 1:
            fired.clear()

        def init_fn(c, m, device=None, spec=spec):
            return texp.dense_l1_range_experiment(
                c, m, l1_range=spec["l1_range"],
                activation_dim=spec["activation_dim"], device=device)

        try:
            result = tsweep.sweep(init_fn, EnsembleArgs(**spec["cfg"]),
                                  device="cpu", resume=mode == "resume",
                                  image_metrics_every=None)
        except SweepPreempted as e:
            out.append({"preempted": str(e)})
            continue
        out.append({"dicts": {name: [ld.get_learned_dict().clone()
                                     for ld, _ in tagged]
                              for name, tagged in result.items()}})
    return out


def case_long_context(rank: int, world: int, args) -> dict:
    """Ring attention, the sequence-parallel forward and the mesh harvest
    from a pickled input, on a 1 × world mesh; ring attention also on a
    2 × (world / 2) mesh when the world is even and above 2 (the ring runs
    inside each model row). Each rank returns its sequence blocks; rank 0
    writes the harvest under ``args[1]``."""
    import dataclasses

    from sparse_coding_tpu_torch.data.harvest import harvest_activations
    from sparse_coding_tpu_torch.lm.convert import params_from_numpy
    from sparse_coding_tpu_torch.lm.long_context import (
        sequence_parallel_forward,
    )
    from sparse_coding_tpu_torch.lm.model_config import tiny_test_config
    from sparse_coding_tpu_torch.lm.ring_attention import ring_attention

    with open(args[0], "rb") as f:
        inp = pickle.load(f)
    mesh = _mesh((1, world))
    q, k, v = (torch.from_numpy(inp["qkv"][i]) for i in range(3))

    def block(t, m):
        s = t.shape[1] // m.shape["data"]
        return t[:, m.coords["data"] * s:(m.coords["data"] + 1) * s]

    out = {"ring": ring_attention(block(q, mesh), block(k, mesh),
                                  block(v, mesh), mesh)}
    if world > 2 and world % 2 == 0:
        rows = _mesh((2, world // 2))
        out["ring_2x"] = ring_attention(block(q, rows), block(k, rows),
                                        block(v, rows), rows)
    params = params_from_numpy(inp["params"], device="cpu")
    tokens = torch.from_numpy(inp["tokens"])
    for key, (parallel, taps, stop) in inp["forwards"].items():
        cfg = dataclasses.replace(tiny_test_config("gptneox"),
                                  parallel_residual=parallel)
        out[key] = sequence_parallel_forward(params, tokens, cfg, mesh,
                                             taps=taps, stop_at_layer=stop)
    out["harvest"] = harvest_activations(
        params, tiny_test_config("gptneox"), inp["rows"],
        output_folder=args[1], mesh=mesh, **inp["harvest"])
    return out


CASES = {"agree": case_agree, "train": case_train, "sweep": case_sweep,
         "long_context": case_long_context}


def main(argv) -> None:
    from sparse_coding_tpu_torch.parallel.mesh import (
        initialize_distributed,
        shutdown_distributed,
    )

    case, rank, world, store, out = argv[:5]
    rank, world = int(rank), int(world)
    initialize_distributed(store=dist.FileStore(store, world),
                           num_processes=world, process_id=rank,
                           backend="gloo", device_type="cpu",
                           timeout_s=120.0)
    try:
        result = CASES[case](rank, world, argv[5:])
        torch.save(result, Path(out) / f"{case}_{rank}.pt")
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    torch.manual_seed(0)
    np.random.seed(0)
    main(sys.argv[1:])
