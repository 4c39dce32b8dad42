"""Content digests for durable artifacts (the chunk store's subset)."""

from __future__ import annotations

import hashlib

import numpy as np


def array_sha256(arr) -> str:
    """Digest of an array's raw C-order bytes — byte-identical to the JAX
    package's ``resilience.manifest.array_sha256``, so a store written by
    either side verifies on the other."""
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
