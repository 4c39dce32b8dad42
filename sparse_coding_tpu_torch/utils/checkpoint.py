"""Full-state checkpoints for exact resume (the port's counterpart of the
JAX package's ``utils/checkpoint.py``).

A checkpoint is an ensemble's whole training state — params, buffers,
Adam mu/nu/count, lrs, step and live mask — in the port's own tensor-file
format (``<name>.tensors``; flax msgpack is not on the card's host, and
cross-loading with the JAX package is not a goal), plus a JSON sidecar
``<name>.tensors.meta.json`` with the payload's sha256 and the caller's
extras (the sweep's data cursor: ``chunks_done`` and the numpy
``rng_state``).

The tensor file is ``MAGIC``, the header's length (8 bytes, little
endian), a JSON header listing each leaf's key, dtype, shape and offset,
then the leaves' raw little-endian C-order bytes in header order. Its
bytes depend only on the state, so two equal states give equal files.

Hardening, as in the JAX package: payload and sidecar are written
atomically (tmp + fsync + rename; sidecar last, so its digest certifies
the payload beside it; the payload is streamed and hashed as it is
written, never joined in memory), fault sites ``ckpt.save`` and ``ckpt.restore``
cover both paths, and a digest mismatch or a payload that does not load
raises :class:`CheckpointCorruptionError`, which
``train/sweep.py::resume_sweep_state`` falls back from.

On a mesh (``Ensemble(..., mesh=...)``) a save gathers the member shards
and rank 0 writes the file a single-device run writes for the same
numbers; a restore reads the whole file on every rank and keeps the
rank's shard (``ensemble.shard_ensemble_state``). Both are collectives.
The orbax backend writes a mesh's state as shards instead, one tensor
file per model shard (``<path>.shard-<m>-of-<M>``, each with its own
sidecar) beside an index sidecar ``<path>.meta.json`` that names their
count; :func:`restore_ensemble` reads either layout, onto any mesh or
none.

``save_pytree``/``restore_pytree`` write any tree of tensors, arrays and
scalars in the same tensor-file format, beside a ``.sha256`` sidecar;
the template given to the restore decides the nesting.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sparse_coding_tpu_torch.ensemble import Ensemble, shard_ensemble_state
from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_write_text,
    fsync_dir,
)
from sparse_coding_tpu_torch.resilience.errors import (
    CheckpointCorruptionError,
)
from sparse_coding_tpu_torch.resilience.faults import (
    fault_point,
    register_fault_site,
)
from sparse_coding_tpu_torch.resilience.manifest import bytes_sha256
from sparse_coding_tpu_torch.utils.tree import flatten_tree, unflatten_like

SUFFIX = ".tensors"
MAGIC = b"SCTENSOR"
_HEADER_LEN = struct.Struct("<Q")
_DTYPES = {torch.float32: "float32", torch.int32: "int32",
           torch.bool: "bool", torch.int64: "int64",
           torch.bfloat16: "bfloat16"}  # what a state holds
# numpy has no bfloat16: a bf16 leaf crosses to the host as its 16-bit
# patterns, in a uint16 dtype tagged so that the header names it
_BF16_BITS = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor's numpy view, bf16 as its tagged bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return (a.dtype.metadata or {}).get("dtype", a.dtype.name)


def _np_dtype(name: str) -> np.dtype:
    return _BF16_BITS if name == "bfloat16" else np.dtype(name)


def _from_host(a: np.ndarray) -> torch.Tensor:
    """The tensor of a decoded leaf (bf16 from its bit patterns)."""
    if _dtype_name(a) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)

register_fault_site("ckpt.save", "checkpoint save (utils/checkpoint.py)")
register_fault_site("ckpt.restore", "checkpoint restore (utils/checkpoint.py)")


def _leaves(state) -> dict[str, torch.Tensor]:
    """The state's tensors under flat keys, in a fixed order."""
    out = {}
    for tree in ("params", "buffers", "mu", "nu"):
        for k, v in getattr(state, tree).items():
            out[f"{tree}/{k}"] = v
    out.update(count=state.count, lrs=state.lrs, step=state.step)
    if state.live is not None:
        out["live"] = state.live
    return out


def _host_arrays(leaves: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: host_array(t.detach().cpu().contiguous())
            for k, t in leaves.items()}


def _header(arrays: dict[str, np.ndarray]) -> bytes:
    entries, offset = [], 0
    for key, a in arrays.items():
        entries.append({"key": key, "dtype": _dtype_name(a),
                        "shape": list(a.shape), "offset": offset})
        offset += a.nbytes
    head = json.dumps({"format": 1, "leaves": entries},
                      separators=(",", ":")).encode()
    return MAGIC + _HEADER_LEN.pack(len(head)) + head


def _write_payload(path: Path, arrays: dict[str, np.ndarray]) -> tuple:
    """Stream the tensor file to ``path`` atomically (tmp + fsync +
    rename), hashing as it writes: no copy of the state is joined in
    memory. Returns (sha256 hex digest, bytes written)."""
    digest = hashlib.sha256()
    tmp = path.parent / f".{path.name}.tmp.{os.getpid()}"
    size = 0
    try:
        with open(tmp, "wb") as f:
            for part in (_header(arrays), *arrays.values()):
                view = memoryview(part).cast("B")
                digest.update(view)
                f.write(view)
                size += view.nbytes
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    fsync_dir(path.parent)
    return digest.hexdigest(), size


def _decode(payload) -> dict[str, np.ndarray]:
    payload = memoryview(payload)
    if bytes(payload[:len(MAGIC)]) != MAGIC:
        raise ValueError("not a tensor file (bad magic)")
    at = len(MAGIC) + _HEADER_LEN.size
    (n,) = _HEADER_LEN.unpack(payload[len(MAGIC):at])
    head = json.loads(bytes(payload[at:at + n]))
    base = at + n
    out = {}
    for leaf in head["leaves"]:
        dt = _np_dtype(leaf["dtype"])
        count = int(np.prod(leaf["shape"], dtype=np.int64))
        arr = np.frombuffer(payload, dtype=dt, count=count,
                            offset=base + int(leaf["offset"]))
        out[leaf["key"]] = arr.reshape(leaf["shape"])
    return out


def _meta_path(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".meta.json")


def _state_meta(state) -> dict:
    return {"sig_name": state.sig_name,
            "static_buffers": [list(kv) for kv in state.static_buffers]}


def _write_checkpoint(path: Path, arrays: dict[str, np.ndarray],
                      state_meta: dict, extra: Optional[dict]) -> int:
    """Write a state's host arrays as the tensor file, then its sidecar;
    returns the payload's bytes. Both backends write through here
    (``utils/orbax_ckpt.py`` on its worker threads)."""
    fault_point("ckpt.save")
    sha, size = _write_payload(path, arrays)
    meta = {**state_meta, "payload_sha256": sha, "payload_bytes": size,
            **(extra or {})}
    # the sidecar last: its digest certifies the payload beside it
    atomic_write_text(_meta_path(path),
                      json.dumps(meta, indent=2, default=str))
    return size


def save_ensemble(ens: Ensemble, path: str | Path,
                  extra: Optional[dict] = None) -> None:
    """Write ``ens``'s full state to ``path`` and its sidecar (on a mesh:
    gathered from every rank, written by rank 0)."""
    path = Path(path)
    state = ens.full_state()
    if ens.mesh is not None and ens.mesh.rank != 0:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_checkpoint(path, _host_arrays(_leaves(state)), _state_meta(state),
                      extra)


def shard_path(path: Path, shard: int, n_shards: int) -> Path:
    """Model shard ``shard`` of ``n_shards``' tensor file of a sharded
    checkpoint at ``path``."""
    return path.with_name(f"{path.name}.shard-{shard}-of-{n_shards}")


def _index(path: Path) -> Optional[dict]:
    """A sharded checkpoint's index sidecar, or None."""
    meta_path = _meta_path(path)
    if path.exists() or not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    return meta if "shards" in meta else None


def checkpoint_exists(path: str | Path) -> bool:
    """Whether a complete checkpoint is at ``path``: the tensor file, or a
    sharded checkpoint's index and every shard it names."""
    path = Path(path)
    if path.exists():
        return True
    index = _index(path)
    return index is not None and all(
        shard_path(path, m, index["shards"]).exists()
        for m in range(index["shards"]))


def _read_payload(path: Path) -> tuple[dict, dict[str, np.ndarray]]:
    """(sidecar, decoded leaves) of one tensor file, its digest checked."""
    meta_path = _meta_path(path)
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    # a writable buffer: the restored tensors share it, no further copy
    payload = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        f.readinto(payload)
    want = meta.get("payload_sha256")
    if want is not None and bytes_sha256(payload) != want:
        raise CheckpointCorruptionError(
            path, "payload sha256 does not match the sidecar manifest")
    try:
        return meta, _decode(payload)
    except (ValueError, KeyError, TypeError, struct.error) as e:
        raise CheckpointCorruptionError(
            path, f"payload does not load: {e}") from e


def _read_sharded(path: Path, index: dict) -> dict[str, np.ndarray]:
    """The whole state's leaves from a sharded checkpoint: each member
    leaf the shards' slices in model order, the 0-d step from the
    first."""
    parts = [_read_payload(shard_path(path, m, index["shards"]))[1]
             for m in range(index["shards"])]
    return {key: (a if a.ndim == 0 else np.concatenate(
                [p[key] for p in parts], axis=0))
            for key, a in parts[0].items()}


def restore_ensemble(ens: Ensemble, path: str | Path) -> dict:
    """Load a checkpoint into a freshly built Ensemble of the same shape,
    in place; returns the sidecar (with the caller's extras). A state
    saved without a live mask restores with every member live. On a mesh
    every rank reads the file and keeps its member shard. A sharded
    checkpoint (the orbax backend's on a mesh) restores the same way,
    onto any mesh shape or a single device."""
    path = Path(path)
    fault_point("ckpt.restore")
    index = _index(path)
    if index is not None:
        meta, arrays = index, _read_sharded(path, index)
    else:
        meta, arrays = _read_payload(path)
    full = ens.full_state()
    template = _leaves(full)
    try:
        loaded = {}
        for key, t in template.items():
            if key == "live" and key not in arrays:
                loaded[key] = torch.ones_like(t)
                continue
            a = arrays[key]
            if (tuple(a.shape) != tuple(t.shape)
                    or _dtype_name(a) != _DTYPES[t.dtype]):
                raise ValueError(f"{key}: {_dtype_name(a)}{list(a.shape)} "
                                 f"where the ensemble holds {t.dtype}"
                                 f"{list(t.shape)}")
            loaded[key] = _from_host(a).to(t.device)
    except (ValueError, KeyError, TypeError, struct.error) as e:
        raise CheckpointCorruptionError(
            path, f"payload does not load: {e}") from e
    tree = lambda name: {k.split("/", 1)[1]: v for k, v in loaded.items()
                         if k.startswith(name + "/")}
    state = full.replace(
        params=tree("params"), buffers=tree("buffers"), mu=tree("mu"),
        nu=tree("nu"), count=loaded["count"], lrs=loaded["lrs"],
        step=loaded["step"], live=loaded.get("live"))
    ens.state = (state if ens.mesh is None
                 else shard_ensemble_state(state, ens.mesh))
    return meta


def _leaf_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return host_array(v.detach().cpu().contiguous())
    return np.ascontiguousarray(np.asarray(v))


def _like(template, a: np.ndarray):
    """A decoded leaf in the template leaf's kind: a tensor on its device,
    a numpy array, or a Python scalar."""
    if isinstance(template, torch.Tensor):
        return _from_host(a.copy()).to(template.device)
    if isinstance(template, np.ndarray):
        return a.copy()
    return type(template)(a.item())


def _sha_path(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".sha256")


def save_pytree(tree, path: str | Path) -> None:
    """Write a tree of tensors, arrays and scalars (nested dicts, lists,
    tuples) as a tensor file with a ``.sha256`` sidecar, both atomic.
    Fault site ``ckpt.save``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: _leaf_array(v) for k, v in flatten_tree(tree).items()
              if v is not None}
    fault_point("ckpt.save")
    sha, _ = _write_payload(path, arrays)
    atomic_write_text(_sha_path(path), sha)


def restore_pytree(template, path: str | Path):
    """The tree :func:`save_pytree` wrote, in ``template``'s nesting and
    leaf kinds. A payload that fails its ``.sha256`` sidecar, or does not
    decode to the template's leaves, raises
    :class:`CheckpointCorruptionError`. Fault site ``ckpt.restore``."""
    path = Path(path)
    fault_point("ckpt.restore")
    payload = path.read_bytes()
    sha_path = _sha_path(path)
    if sha_path.exists() and \
            bytes_sha256(payload) != sha_path.read_text().strip():
        raise CheckpointCorruptionError(
            path, "payload sha256 does not match the .sha256 sidecar")
    try:
        arrays = _decode(payload)
        loaded = {k: None if t is None else _like(t, arrays[k])
                  for k, t in flatten_tree(template).items()}
    except (ValueError, KeyError, TypeError, struct.error) as e:
        raise CheckpointCorruptionError(
            path, f"payload does not load: {e}") from e
    return unflatten_like(template, loaded)
