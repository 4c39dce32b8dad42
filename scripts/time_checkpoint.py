#!/usr/bin/env python3
"""Where a sweep checkpoint set's time goes, at chip_smoke phase 8's shape
(tied_vs_not: 16 tied + 16 untied members, d=512, n=2048; 0.58 GiB a set).

Times, for each ensemble, each stage of ``utils/checkpoint.py::
save_ensemble`` alone — the copy of the state to the host, sha256 over
it, the write, the fsync — then whole ``save_ensemble`` and
``restore_ensemble`` calls, each the best of ``--repeats``. Writes into a
temporary directory under ``--dir`` (default: the working directory, the
disk a sweep's output folder would use).

Run: ``python3 scripts/time_checkpoint.py [--device cuda] [--report PATH]``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def best(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> int:
    from sparse_coding_tpu_torch.config import EnsembleArgs
    from sparse_coding_tpu_torch.obs.perf import synchronize
    from sparse_coding_tpu_torch.train.experiments import (
        tied_vs_not_experiment,
    )
    from sparse_coding_tpu_torch.utils import checkpoint as ckpt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dir", type=Path, default=Path.cwd())
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args()

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    cfg = EnsembleArgs(learned_dict_ratio=4.0)
    entries = tied_vs_not_experiment(cfg, activation_dim=512,
                                     device=args.device)
    report = {}
    with tempfile.TemporaryDirectory(prefix=".time_checkpoint_",
                                     dir=args.dir) as tmp:
        for ens, _, name in entries:
            leaves = ckpt._leaves(ens.state)
            synchronize(args.device)
            arrays = ckpt._host_arrays(leaves)
            nbytes = sum(a.nbytes for a in arrays.values())
            path = Path(tmp) / f"{name}.tensors"

            def write(fsync: bool):
                with open(path, "wb") as f:
                    for a in arrays.values():
                        f.write(memoryview(a).cast("B"))
                    f.flush()
                    if fsync:
                        os.fsync(f.fileno())

            def sha():
                h = hashlib.sha256()
                for a in arrays.values():
                    h.update(memoryview(a).cast("B"))

            row = {
                "bytes": nbytes,
                "to_host_s": best(lambda: ckpt._host_arrays(leaves),
                                  args.repeats),
                "sha256_s": best(sha, args.repeats),
                "write_s": best(lambda: write(False), args.repeats),
                "write_fsync_s": best(lambda: write(True), args.repeats),
                "save_ensemble_s": best(
                    lambda: ckpt.save_ensemble(ens, path), args.repeats),
                "restore_ensemble_s": best(
                    lambda: (ckpt.restore_ensemble(ens, path),
                             synchronize(args.device)), args.repeats),
            }
            report[name] = row
            print(f"{name}: {nbytes / 2**20:.0f} MiB; " + ", ".join(
                f"{k} {v:.3f}" for k, v in row.items() if k != "bytes"))
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
