"""Content digests for durable artifacts: chunk and checkpoint digests and
the payload digest small JSON ledgers embed (the port's subset of the JAX
package's ``resilience/manifest.py``, byte-identical in what it
computes)."""

from __future__ import annotations

import hashlib
import json

import numpy as np

# Key under which a small JSON ledger (quarantine.json) embeds the digest
# of its own payload: the sha256 of ``json.dumps(body, sort_keys=True)``
# over every OTHER key. A digest-less payload stays loadable, unverified.
PAYLOAD_DIGEST_KEY = "payload_sha256"


def bytes_sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def array_sha256(arr) -> str:
    """Digest of an array's raw C-order bytes — byte-identical to the JAX
    package's ``resilience.manifest.array_sha256``, so a store written by
    either side verifies on the other."""
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _payload_body_digest(payload: dict) -> str:
    body = {k: payload[k] for k in payload if k != PAYLOAD_DIGEST_KEY}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def embed_payload_digest(payload: dict) -> dict:
    """``payload`` with :data:`PAYLOAD_DIGEST_KEY` set to the digest of the
    rest. Pure, and idempotent on an already-digested payload."""
    out = {k: payload[k] for k in payload if k != PAYLOAD_DIGEST_KEY}
    out[PAYLOAD_DIGEST_KEY] = _payload_body_digest(out)
    return out


def check_payload_digest(payload) -> str:
    """``"ok"`` (digest present and matching), ``"absent"`` (a digest-less
    payload: loadable, unverified) or ``"mismatch"`` (also for a payload
    that is not a dict)."""
    if not isinstance(payload, dict):
        return "mismatch"
    want = payload.get(PAYLOAD_DIGEST_KEY)
    if want is None:
        return "absent"
    return "ok" if _payload_body_digest(payload) == want else "mismatch"
