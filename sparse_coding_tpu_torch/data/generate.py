"""Activation-dataset generation CLI (the JAX package's
``data/generate.py``): load a preset model and a text dataset from the
local caches, tokenize and pack, harvest every requested layer in one
pass on the card.

    python -m sparse_coding_tpu_torch.data.generate --model_name gpt2 \\
        --layers '[1,2]' --layer_loc residual --dataset_folder out/ \\
        [--device cpu]

Every ``DataArgs`` field is a flag; ``--device`` (default: the card) is
the port's own. The model and the tokenizer come from the local Hugging
Face cache and the texts from ``datasets``' cache (or a Pile shard
fetched by hand): nothing is downloaded.
"""

from __future__ import annotations

import argparse
import sys

from sparse_coding_tpu_torch.config import DataArgs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    ns, rest = parser.parse_known_args(
        list(argv) if argv is not None else sys.argv[1:])
    cfg = DataArgs.from_cli(rest)

    from sparse_coding_tpu_torch.data.harvest import setup_data
    from sparse_coding_tpu_torch.data.tokenize import load_text_dataset
    from sparse_coding_tpu_torch.lm.convert import load_model

    params, lm_cfg = load_model(cfg.model_name, device=ns.device)
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError("the tokenizer needs the transformers package, "
                           "which is not installed") from e
    tokenizer = AutoTokenizer.from_pretrained(cfg.model_name,
                                              local_files_only=True)
    texts = load_text_dataset(cfg.dataset_name, max_docs=cfg.max_docs)
    written = setup_data(cfg, params, lm_cfg, texts, tokenizer,
                         device=ns.device)
    for tap, n in written.items():
        print(f"{tap}: {n} chunks -> {cfg.dataset_folder}/{tap}/")


if __name__ == "__main__":
    main()
