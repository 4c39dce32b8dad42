"""Atomic durable file writes: tmp + fsync + rename.

``os.replace`` on the same filesystem is atomic, so a reader (or a crash)
only ever observes the old complete file or the new complete file. The
fsync before the rename makes the content durable before the name flips;
the directory fsync after makes the rename itself durable.
"""

from __future__ import annotations

import io
import os
import pickle
from pathlib import Path

import numpy as np


def fsync_dir(path: str | Path) -> None:
    """Best-effort directory fsync (some filesystems refuse it; the rename
    is atomic either way, so failure only weakens durability)."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str | Path, data: bytes) -> None:
    """Write ``data`` so that ``path`` always holds either its previous
    complete content or ``data`` in full."""
    path = Path(path)
    tmp = path.parent / f".{path.name}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    fsync_dir(path.parent)


def atomic_write_text(path: str | Path, text: str) -> None:
    atomic_write_bytes(path, text.encode())


def atomic_save_npy(path: str | Path, arr) -> None:
    """np.save with the tmp+fsync+rename discipline."""
    buf = io.BytesIO()
    np.save(buf, arr)
    atomic_write_bytes(path, buf.getvalue())


def atomic_pickle_dump(path: str | Path, obj) -> None:
    """pickle.dump with the tmp+fsync+rename discipline."""
    atomic_write_bytes(path, pickle.dumps(obj))
