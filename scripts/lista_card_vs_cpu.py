#!/usr/bin/env python3
"""LISTA's card-against-CPU readings over several seeds, at chip_smoke
phase 12 (b)'s shape: the ``residual_denoising`` experiment's first two
grid points (d=512, n=2048, batch 2048, two unrolled layers), three Adam
steps from one init on the card and on the CPU, through
``chip_smoke.card_vs_cpu_steps``. For each seed: the shrinkage flips
between the two sides, the features they touch, and each leaf's
‖Δ‖/‖leaf‖ on every feature and on the features without a flip — the
spread behind chip_smoke's LISTA check.

Run: ``python3 scripts/lista_card_vs_cpu.py [--seeds 0 1 2 3 4]
[--report PATH]`` (needs a card).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[0, 1, 2, 3, 4])
    parser.add_argument("--report", type=Path, default=None)
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    out = {"card": cs.card_line(), "seeds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "store"
        cs.write_store(store, cs.ROWS_PER_CHUNK, seed=cs.SEED)
        chunk = torch.as_tensor(ChunkStore(store).load_chunk(0))
        batches = [chunk[i * cs.BATCH:(i + 1) * cs.BATCH].float()
                   for i in range(cs.GROUP_SIDE_STEPS)]
        for seed in args.seeds:
            side = cs.card_vs_cpu_steps("residual_denoising", store, batches,
                                        seed=seed)
            c, = side["lista"]
            out["seeds"][seed] = {"loss_rel_err": side["loss_rel_err"], **c}
            print(f"seed {seed}: losses {side['loss_rel_err']:.3e}; "
                  f"weights {c['rel_fro']:.3e} {c['rel_fro_leaves']}; "
                  f"first step: elements the other way "
                  f"{c['first_step_opposite']}, the rest "
                  f"{c['first_step_rest']}; flips by step "
                  f"{c['flips_by_step']} of {c['codes']} codes a step (cap "
                  f"{c['flips_allowed']} on the first), in "
                  f"{c['flipped_features']} of {c['features']} features; "
                  f"the features without a flip {c['rel_fro_unflipped']:.3e}",
                  flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: {kk: v[kk] for kk in ("rel_fro", "flips_by_step",
                                               "failed")}
                      for k, v in out["seeds"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
