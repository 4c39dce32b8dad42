"""Text → packed token rows (the JAX package's ``data/tokenize.py``).

The reference's ``chunk_and_tokenize`` semantics: documents are
tokenized, joined with EOS separators and packed into fixed-length rows
with no padding; the packed [n_rows, max_length] int32 array comes with
the bits-per-byte ratio used to turn a nats-per-token loss into bits per
byte. Host-side numpy, no device. ``load_text_dataset`` imports
``datasets``, and ``load_pile_shard``'s ``.zst`` path ``zstandard``, inside
the function; neither downloads anything.
"""

from __future__ import annotations

import io
import json
import math
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_save_npy,
    atomic_write_text,
)


def pack_tokens(token_lists: Iterable[list[int]], max_length: int,
                eos_token_id: int) -> np.ndarray:
    """EOS-joined GPT-style packing into [n_rows, max_length] int32 rows.
    Trailing tokens that don't fill a row are dropped (the reference's
    drop-last behaviour)."""
    stream: list[int] = []
    rows: list[list[int]] = []
    for toks in token_lists:
        stream.extend(toks)
        stream.append(eos_token_id)
        while len(stream) >= max_length:
            rows.append(stream[:max_length])
            stream = stream[max_length:]
    if not rows:
        return np.zeros((0, max_length), np.int32)
    return np.asarray(rows, np.int32)


def chunk_and_tokenize(texts: Iterable[str], tokenizer, max_length: int = 256,
                       eos_token_id: Optional[int] = None,
                       max_docs: Optional[int] = None
                       ) -> tuple[np.ndarray, float]:
    """Tokenize and pack a text iterable. Returns (rows, ratio) with
    ratio = (total_tokens / total_bytes) / ln 2: a nats-per-token loss
    times it is bits per byte."""
    token_lists = []
    total_tokens = total_bytes = 0
    for i, text in enumerate(texts):
        if max_docs is not None and i >= max_docs:
            break
        toks = tokenizer.encode(text)
        token_lists.append(toks)
        total_tokens += len(toks)
        total_bytes += len(text.encode("utf-8"))
    eos = eos_token_id if eos_token_id is not None else tokenizer.eos_token_id
    rows = pack_tokens(token_lists, max_length, eos)
    return rows, total_tokens / max(total_bytes, 1) / math.log(2)


def save_token_dataset(rows: np.ndarray, path: str | Path,
                       metadata: Optional[dict] = None) -> None:
    """Persist packed token rows (``<path>.npy``, and ``<path>.meta.json``
    with ``metadata``) for reuse across harvests."""
    path = Path(path).with_suffix(".npy")
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_save_npy(path, rows)
    if metadata:
        atomic_write_text(path.with_suffix(".meta.json"),
                          json.dumps(metadata, indent=2))


def load_token_dataset(path: str | Path) -> np.ndarray:
    return np.load(Path(path).with_suffix(".npy"))


PILE_SHARD_URL = "https://the-eye.eu/public/AI/pile/train/{shard:02d}.jsonl.zst"
_PILE_NAMES = {"the_pile", "eleutherai/pile", "pile"}


def load_pile_shard(shard: Optional[int] = None,
                    cache_dir: str | Path = "~/.cache/sparse_coding_tpu/pile",
                    max_docs: Optional[int] = None) -> list[str]:
    """The texts of a Pile shard fetched by hand (the reference's
    curl + unzstd fallback): ``{NN}.jsonl`` or ``{NN}.jsonl.zst`` under
    ``cache_dir`` (``shard=None``: the lowest present). Train-split jsonl
    with a "text" field. Nothing is downloaded: a missing shard raises
    FileNotFoundError naming ``PILE_SHARD_URL``."""
    cache_dir = Path(cache_dir).expanduser()
    if shard is None:
        found = sorted(cache_dir.glob("[0-9][0-9].jsonl*"))
        shard = int(found[0].name[:2]) if found else 0
    plain = cache_dir / f"{shard:02d}.jsonl"
    compressed = cache_dir / f"{shard:02d}.jsonl.zst"
    if not plain.exists() and not compressed.exists():
        raise FileNotFoundError(
            f"no pile shard {shard:02d}.jsonl(.zst) under {cache_dir}; "
            f"fetch one ({PILE_SHARD_URL.format(shard=shard)}) there first")
    texts: list[str] = []

    def take(lines) -> list[str]:
        for line in lines:
            if not line.strip():
                continue
            texts.append(json.loads(line)["text"])
            if max_docs is not None and len(texts) >= max_docs:
                break
        return texts

    if plain.exists():
        with open(plain, encoding="utf-8") as fh:
            return take(fh)
    try:
        import zstandard
    except ImportError as e:
        raise RuntimeError(f"{compressed} needs the zstandard package to "
                           "decompress; unpack it to .jsonl instead") from e
    with open(compressed, "rb") as fh:
        stream = zstandard.ZstdDecompressor().stream_reader(fh)
        return take(io.TextIOWrapper(stream, encoding="utf-8"))


def load_text_dataset(dataset_name: str, split: str = "train",
                      text_key: str = "text",
                      max_docs: Optional[int] = None,
                      pile_shard_dir: Optional[str | Path] = None
                      ) -> list[str]:
    """A Hugging Face dataset's texts (needs ``datasets`` and a populated
    local cache). For the Pile's train split, a shard fetched by hand
    (``load_pile_shard``) is the fallback when the HF load fails."""
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise RuntimeError(
            f"load_text_dataset({dataset_name!r}) needs the datasets "
            "package, which is not installed") from e
    try:
        ds = load_dataset(dataset_name, split=split)
    except Exception as hf_err:
        # manual shards are train-split only: never substitute train text
        # for another requested split
        if dataset_name.lower() in _PILE_NAMES and split == "train":
            kwargs = ({} if pile_shard_dir is None
                      else {"cache_dir": pile_shard_dir})
            try:
                return load_pile_shard(max_docs=max_docs, **kwargs)
            except FileNotFoundError as shard_err:
                raise RuntimeError(
                    f"HF load of {dataset_name} failed ({hf_err}) and the "
                    f"manual-shard fallback found nothing ({shard_err})"
                ) from hf_err
        raise
    if max_docs is not None:
        ds = ds.select(range(min(max_docs, len(ds))))
    return ds[text_key]
