"""Process-wide registry of typed instruments: counters, gauges and
fixed-bucket histograms (the port's copy of the JAX package's
``obs/registry.py``). Plain host-side Python behind locks, so any hot loop
can touch an instrument without a device sync; an instrument is keyed by
its name and sorted labels, so a call site asked twice gets the same
object."""

from __future__ import annotations

import math
import threading
from typing import Iterable, Optional, Sequence

# default duration buckets: 100 µs .. ~100 s, geometric (x√10 per step)
DEFAULT_BUCKETS = tuple(10.0 ** (e / 2.0) for e in range(-8, 5))


def _label_key(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={labels[k]}" for k in sorted(labels)) + "}"


class Counter:
    """Monotonic count."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last written value, with its high-water mark."""

    __slots__ = ("_lock", "_value", "_max")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0
        self._max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._max = max(self._max, float(v))

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max


class Histogram:
    """Fixed-bound bucket histogram with sum, count, min and max:
    ``bounds`` (:data:`DEFAULT_BUCKETS` unless given) are the upper edges
    of the first bins, one overflow bin takes the rest, so two snapshots
    add bin for bin. Quantiles interpolate linearly inside the covering
    bin."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count", "min", "max")

    def __init__(self, lock: threading.Lock,
                 bounds: Optional[Sequence[float]] = None):
        self._lock = lock
        self.bounds = tuple(float(b) for b in (bounds or DEFAULT_BUCKETS))
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be ascending")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = next((i for i, b in enumerate(self.bounds) if v <= b),
                     len(self.bounds))
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another histogram's ``snapshot()`` into this one, bin for
        bin; the bounds must match."""
        with self._lock:
            if tuple(snap["bounds"]) != self.bounds:
                raise ValueError(
                    f"cannot merge histograms with different bounds: "
                    f"{snap['bounds']} vs {list(self.bounds)}")
            for i, c in enumerate(snap["counts"]):
                self.counts[i] += int(c)
            self.sum += float(snap["sum"])
            self.count += int(snap["count"])
            if snap["count"]:
                self.min = min(self.min, float(snap["min"]))
                self.max = max(self.max, float(snap["max"]))

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if self.count == 0:
                return None
            target = q * self.count
            seen = 0
            for i, c in enumerate(self.counts):
                if seen + c >= target and c > 0:
                    lo = 0.0 if i == 0 else self.bounds[i - 1]
                    hi = (self.bounds[i] if i < len(self.bounds)
                          else max(self.max, lo))
                    lo = max(lo, self.min)
                    hi = min(hi, self.max) if self.max >= lo else hi
                    frac = (target - seen) / c
                    return lo + (hi - lo) * min(1.0, max(0.0, frac))
                seen += c
            return self.max

    def snapshot(self) -> dict:
        with self._lock:
            return {"bounds": list(self.bounds), "counts": list(self.counts),
                    "sum": self.sum, "count": self.count,
                    "min": self.min if self.count else None,
                    "max": self.max if self.count else None}


class Registry:
    """One process's instrument table; ``snapshot()`` returns plain
    JSON-serializable data."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, key: str, make):
        with self._lock:
            inst = table.get(key)
            if inst is None:
                inst = table[key] = make()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name + _label_key(labels),
                         lambda: Counter(threading.Lock()))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, name + _label_key(labels),
                         lambda: Gauge(threading.Lock()))

    def histogram(self, name: str, bounds: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        """The histogram of ``name`` and ``labels``; ``bounds`` apply when
        this call creates it."""
        return self._get(self._histograms, name + _label_key(labels),
                         lambda: Histogram(threading.Lock(),
                                           bounds=tuple(bounds) if bounds
                                           else None))

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: {"value": g.value, "max": g.max}
                       for k, g in gauges.items()},
            "histograms": {k: h.snapshot() for k, h in histograms.items()},
        }


_default = Registry()


def get_registry() -> Registry:
    return _default


def set_registry(registry: Registry) -> Registry:
    """Swap the process default (tests); returns the previous one."""
    global _default
    prev, _default = _default, registry
    return prev
