"""Derived bucket ladders: traffic-shaped serving shapes (the port's copy
of the JAX package's ``serve/ladder.py``).

The engine's shape-bucket ladder (serve/engine.py, default 8/64/512) is a
DERIVED artifact: a pure, byte-deterministic solver reads one
metrics-registry snapshot — the rolling request-size histogram
(``serve.request_rows``) plus the per-bucket fill counters — and returns
the K-rung ladder minimizing expected pad-rows over that traffic, subject
to a max-rungs capture budget and a row-alignment constraint.

- **snapshot in, ladder out** — derivation never reads live mutable
  state. ``snapshot_bytes`` freezes the registry's instruments into
  canonical JSON wrapped with a self-digest; ``parse_snapshot`` verifies
  the digest, so a corrupted snapshot (fault site
  ``gateway.ladder.derive`` in mode=corrupt) fails loudly instead of
  deriving a garbage ladder.
- **byte-determinism** — integer sizes, integer weights, a DP with
  first-strict-improvement tie-breaks: the same snapshot bytes produce
  the same ``ladder_to_json`` bytes, and the same bytes as the JAX
  package's solver.
- **host-only** — the solver imports neither torch nor the engine; it
  runs on the gateway's maintenance path.

The swap itself (capture the candidate's programs in a spare, then
replace the active ladder behind crash barrier ``gateway.ladder.swap``)
lives in serve/gateway.py.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Sequence

STATIC_LADDER = (8, 64, 512)

# manual override: a comma-separated rung list, e.g. "8,24,96" — the
# operator's pin wins over derivation and bypasses the flap guard
PIN_ENV = "SPARSE_CODING_LADDER_PIN"

SNAPSHOT_VERSION = 1

# request-size histogram bounds (rows): denser than the geometric
# latency default and carrying non-power-of-two edges (6/12/24/48/96/
# 192/384/768) so the solver can see — and pick — rungs the static
# ladder never offered. Upper edges are the candidate rung vocabulary.
REQUEST_ROW_BOUNDS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96,
                      128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


class LadderError(ValueError):
    """Typed failure of snapshot parsing or ladder derivation."""


class SnapshotIntegrityError(LadderError):
    """The snapshot bytes do not match their embedded digest (torn or
    corrupted payload) — derivation must be skipped, never guessed."""


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _digest(obj) -> str:
    return hashlib.sha256(_canonical(obj)).hexdigest()


def _split_instrument(key: str) -> tuple[str, dict]:
    """``"serve.rows{bucket=8}"`` → ``("serve.rows", {"bucket": "8"})``."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = {}
    for part in rest.rstrip("}").split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def traffic_snapshot(registry) -> dict:
    """Freeze one registry's serving-traffic instruments into a plain
    JSON-able dict: the rolling request-size histogram plus per-bucket
    batch/row fill counters and latency histograms. This dict — not the
    live registry — is what derivation consumes."""
    raw = registry.snapshot()
    request_rows = None
    latency: dict[str, dict] = {}
    for key, h in raw.get("histograms", {}).items():
        name, labels = _split_instrument(key)
        if name == "serve.request_rows":
            request_rows = h
        elif name == "serve.latency_s" and "bucket" in labels:
            latency[labels["bucket"]] = {
                "count": int(h.get("count", 0)),
                "sum": float(h.get("sum", 0.0))}
    buckets: dict[str, dict] = {}
    for key, v in raw.get("counters", {}).items():
        name, labels = _split_instrument(key)
        if name in ("serve.batches", "serve.rows") and "bucket" in labels:
            b = buckets.setdefault(labels["bucket"],
                                   {"batches": 0, "rows": 0})
            b["batches" if name == "serve.batches" else "rows"] = int(v)
    if request_rows is None:
        request_rows = {"bounds": list(REQUEST_ROW_BOUNDS),
                        "counts": [0] * (len(REQUEST_ROW_BOUNDS) + 1),
                        "sum": 0.0, "count": 0, "min": None, "max": None}
    return {"version": SNAPSHOT_VERSION,
            "request_rows": request_rows,
            "buckets": buckets,
            "latency": latency}


def snapshot_bytes(registry) -> bytes:
    """Canonical self-digested snapshot bytes — the corruptible payload
    the ``gateway.ladder.derive`` fault site carries. Any bit flip is
    caught by :func:`parse_snapshot` (digest mismatch or JSON decode
    error), never silently derived from."""
    snap = traffic_snapshot(registry)
    return _canonical({"digest": _digest(snap), "snapshot": snap})


def parse_snapshot(raw: bytes) -> dict:
    """Decode + integrity-check snapshot bytes; returns the snapshot
    dict. Raises :class:`SnapshotIntegrityError` on any mismatch."""
    if isinstance(raw, (bytes, bytearray)):
        raw = bytes(raw).decode("utf-8", errors="strict")
    try:
        env = json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SnapshotIntegrityError(
            f"ladder snapshot is not valid JSON: {e}") from e
    if not isinstance(env, dict) or "snapshot" not in env:
        raise SnapshotIntegrityError(
            "ladder snapshot envelope missing 'snapshot'")
    snap = env["snapshot"]
    want = env.get("digest")
    got = _digest(snap)
    if want != got:
        raise SnapshotIntegrityError(
            f"ladder snapshot digest mismatch: recorded {want!r}, "
            f"recomputed {got!r}")
    return snap


def _ceil_align(n: int, align: int) -> int:
    return ((int(n) + align - 1) // align) * align


def _weighted_sizes(snapshot: dict, align: int) -> list[tuple[int, int]]:
    """(size, weight) pairs from the request-size histogram: each bin
    contributes its UPPER edge (conservative — derivation never under-
    provisions a bin) weighted by its count; the overflow bin uses the
    observed max rounded up to alignment."""
    hist = snapshot.get("request_rows") or {}
    bounds = [int(b) for b in hist.get("bounds", [])]
    counts = [int(c) for c in hist.get("counts", [])]
    out: list[tuple[int, int]] = []
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if i < len(bounds):
            size = bounds[i]
        else:
            mx = hist.get("max")
            if mx is None:
                continue
            size = _ceil_align(int(mx), align)
        out.append((max(size, 1), c))
    return sorted(out)


def derive_ladder(snapshot: dict, *, max_rungs: int = 4, align: int = 8,
                  min_rung: int = 8,
                  fallback: Sequence[int] = STATIC_LADDER) -> dict:
    """Solve for the ≤``max_rungs`` ladder minimizing expected pad-rows
    over the snapshot's request-size distribution.

    Exact DP over the candidate rung vocabulary (the align-rounded
    distinct observed sizes): ``cost(prev, rung)`` is the pad paid by
    every observed size in ``(prev, rung]`` served at ``rung``; the
    largest candidate is mandatory (the ladder must cover the observed
    max). All-integer arithmetic and first-strict-improvement
    tie-breaks make the result a pure function of the snapshot bytes.
    With no traffic the ``fallback`` ladder is returned verbatim
    (reason ``"no-traffic"``) so a cold gateway never swaps."""
    if max_rungs < 1:
        raise LadderError("max_rungs must be >= 1")
    if align < 1 or min_rung < 1:
        raise LadderError("align and min_rung must be >= 1")
    sizes = _weighted_sizes(snapshot, align)
    base = {"align": int(align), "max_rungs": int(max_rungs),
            "version": SNAPSHOT_VERSION}
    if "digest" in snapshot:
        base["source_digest"] = snapshot["digest"]
    if not sizes:
        return dict(base, rungs=[int(b) for b in fallback],
                    expected_pad_rows=0, request_count=0,
                    reason="no-traffic")
    total_requests = sum(w for _, w in sizes)
    # candidate vocabulary: align-rounded observed sizes, floored at
    # min_rung; ascending and distinct by construction of the set
    cands = sorted({max(_ceil_align(s, align), _ceil_align(min_rung, align))
                    for s, _ in sizes})
    m = len(cands)
    INF = float("inf")

    def seg_cost(prev_c: int, c: int) -> int:
        return sum(w * (c - s) for s, w in sizes if prev_c < s <= c)

    # dp[k][j]: min pad covering every size <= cands[j] with exactly k
    # rungs, rung cands[j] chosen; parent pointers rebuild the ladder
    k_max = min(max_rungs, m)
    dp = [[INF] * m for _ in range(k_max + 1)]
    parent = [[-1] * m for _ in range(k_max + 1)]
    for j in range(m):
        dp[1][j] = seg_cost(0, cands[j])
    for k in range(2, k_max + 1):
        for j in range(k - 1, m):
            best, arg = INF, -1
            for i in range(j):
                prev = dp[k - 1][i]
                if prev == INF:
                    continue
                cost = prev + seg_cost(cands[i], cands[j])
                if cost < best:
                    best, arg = cost, i
            dp[k][j], parent[k][j] = best, arg
    best_k, best_cost = 1, dp[1][m - 1]
    for k in range(2, k_max + 1):
        if dp[k][m - 1] < best_cost:  # strict: prefer FEWER rungs on tie
            best_k, best_cost = k, dp[k][m - 1]
    rungs: list[int] = []
    k, j = best_k, m - 1
    while j >= 0 and k >= 1:
        rungs.append(cands[j])
        j = parent[k][j]
        k -= 1
    rungs.reverse()
    return dict(base, rungs=rungs, expected_pad_rows=int(best_cost),
                request_count=int(total_requests), reason="derived")


def ladder_pad_rows(snapshot: dict, rungs: Sequence[int]) -> int:
    """Expected pad-rows of serving the snapshot's request sizes on a
    GIVEN ladder (the comparison the bench's wasted-pad headline and
    the swap decision read); sizes above the top rung are uncoverable
    and cost the full top-rung pad each (they would be rejected)."""
    rungs = sorted(int(r) for r in rungs)
    sizes = _weighted_sizes(snapshot, align=1)
    pad = 0
    for s, w in sizes:
        cover = next((r for r in rungs if r >= s), None)
        pad += w * ((cover - s) if cover is not None else rungs[-1])
    return int(pad)


def ladder_to_json(ladder: dict) -> str:
    """Canonical JSON of one derived ladder — the byte-determinism
    surface tests assert on (same snapshot ⇒ identical bytes)."""
    return _canonical(ladder).decode("utf-8")


def pinned_ladder(env: Optional[dict] = None) -> tuple[int, ...] | None:
    """The operator's manual ladder pin (``SPARSE_CODING_LADDER_PIN``,
    comma-separated rungs), or None when unset/empty. Raises
    :class:`LadderError` on a malformed pin — a misconfigured override
    must fail loudly, not silently serve the old ladder."""
    raw = (env if env is not None else os.environ).get(PIN_ENV, "").strip()
    if not raw:
        return None
    try:
        rungs = tuple(int(p) for p in raw.split(",") if p.strip())
    except ValueError as e:
        raise LadderError(f"malformed {PIN_ENV}={raw!r}: {e}") from e
    if not rungs or list(rungs) != sorted(set(rungs)) or rungs[0] < 1:
        raise LadderError(
            f"{PIN_ENV}={raw!r} must be unique ascending positive rungs")
    return rungs
