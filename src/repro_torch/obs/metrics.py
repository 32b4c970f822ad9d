"""Process-wide counters, gauges, and fixed-bucket latency histograms.

The registry is the scrape surface for everything the index and serving
tier measure: span-derived stage timers feed latency histograms, the
drift/mass ledgers feed gauges, and work accounting feeds counters.  A
histogram stores only per-bucket counts over a fixed log-spaced bucket
ladder, so percentiles come back as **exact bucket upper bounds** — p50 /
p95 / p99 with bounded relative error (one bucket ratio, ~26 % at the
default 10 buckets/decade) without retaining a single sample.  That also
fixes the sorted-sample estimator's small-n off-by-one for good: with one
observation every quantile is that observation's bucket bound, and the
rank convention ``ceil(q·n)`` never reads past the last sample.

Every mutation and every read goes through one registry lock, so
``snapshot()`` is consistent: the dict it returns is a single point in
time even while other threads observe into the same instruments (the
``BatchingServer`` batcher thread being the motivating case).
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence

SCHEMA = "repro.obs.metrics/v1"   # same schema as the reference registry

# default latency ladder: 10 log-spaced buckets per decade over
# [100 ns, 1000 s] — wide enough for one kernel launch and a cold
# full-size fit, ~0.26 relative bucket-bound error
DEFAULT_BUCKETS = tuple(10.0 ** (e / 10.0) for e in range(-70, 31))


class Counter:
    """Monotone event count."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def _snap(self):
        return self.value


class Gauge:
    """Last-written level (drift fractions, queue depth, versions)."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def _snap(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with exact-bound quantiles.

    ``buckets`` is the ascending ladder of bucket *upper bounds*; an
    observation lands in the first bucket whose bound is ≥ the value, and
    values beyond the last bound land in an overflow bucket whose
    reported quantile is the exact observed ``max``.  ``quantile(q)``
    uses the upper-bound convention at rank ``max(ceil(q·count), 1)`` —
    the returned bound is ≥ at least ``ceil(q·count)`` of the observed
    values, and within one bucket ratio of the true quantile.
    """

    def __init__(self, name: str, lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self._lock = lock
        self.buckets: List[float] = sorted(buckets or DEFAULT_BUCKETS)
        if not self.buckets:
            raise ValueError("need at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)   # +1 → overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket_index(self, v: float) -> int:
        lo, hi = 0, len(self.buckets)
        while lo < hi:                 # first bound >= v (bisect_left)
            mid = (lo + hi) // 2
            if self.buckets[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = max(math.ceil(q * self.count), 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.max)
        return self.max  # pragma: no cover - counts always sum to count

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the rank-``ceil(q·count)``
        observation (0.0 while empty; observed max past the ladder)."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"need 0 < q <= 1, got {q}")
        with self._lock:
            return self._quantile_locked(q)

    def _snap(self):
        nz = [i for i, c in enumerate(self.counts) if c]
        lo = nz[0] if nz else 0
        hi = (nz[-1] + 1) if nz else 0
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self._quantile_locked(0.5),
            "p95": self._quantile_locked(0.95),
            "p99": self._quantile_locked(0.99),
            # only the populated ladder segment, so dumps stay small;
            # bounds[i] is the upper bound of counts[i] (None → overflow)
            "bucket_lo": lo,
            "bounds": [self.buckets[i] if i < len(self.buckets) else None
                       for i in range(lo, hi)],
            "counts": self.counts[lo:hi],
        }


def delta_counts(prev: Optional[dict], cur: dict) -> Dict[int, int]:
    """Per-bucket observation counts that landed *between* two histogram
    snapshots (``Histogram._snap()`` dicts from ``registry.snapshot()``),
    keyed by absolute ladder index.  ``prev=None`` means "since birth"."""
    out: Dict[int, int] = {}
    for i, c in enumerate(cur["counts"]):
        if c:
            out[cur["bucket_lo"] + i] = c
    if prev is not None:
        for i, c in enumerate(prev["counts"]):
            if c:
                j = prev["bucket_lo"] + i
                out[j] = out.get(j, 0) - c
                if out[j] == 0:
                    del out[j]
    return out


def delta_quantile(prev: Optional[dict], cur: dict, q: float) -> float:
    """Windowed quantile between two cumulative histogram snapshots.

    Histograms are cumulative for the life of the process, which makes
    lifetime percentiles useless for *health* decisions — one slow warmup
    batch would keep p99 pinned high forever.  Bucket counts subtract
    cleanly, so the serving ladder snapshots the registry each window and
    reads the quantile of just the observations in between.  Same
    upper-bound convention as :meth:`Histogram.quantile`; observations in
    the overflow bucket report the *cumulative* max (the per-window max
    is not recoverable from counts alone — an acceptable overestimate for
    a degrade-on-slow decision).  Returns 0.0 for an empty window.
    """
    if not 0.0 < q <= 1.0:
        raise ValueError(f"need 0 < q <= 1, got {q}")
    win = delta_counts(prev, cur)
    n = sum(win.values())
    if n <= 0:
        return 0.0
    rank = max(math.ceil(q * n), 1)
    seen = 0
    bounds = cur.get("bounds", [])
    lo = cur["bucket_lo"]
    for i in sorted(win):
        seen += win[i]
        if seen >= rank:
            # a bucket with window mass is populated in cur, so its bound
            # is inside cur's sparse segment; None marks overflow
            b = bounds[i - lo] if 0 <= i - lo < len(bounds) else None
            return cur["max"] if b is None else b
    return cur["max"]  # pragma: no cover - counts always sum to n


def delta_mean(prev: Optional[dict], cur: dict) -> float:
    """Mean of the observations between two snapshots (0.0 if none)."""
    n = cur["count"] - (prev["count"] if prev else 0)
    if n <= 0:
        return 0.0
    return (cur["sum"] - (prev["sum"] if prev else 0.0)) / n


class MetricsRegistry:
    """Name → instrument map; one lock guards maps and instrument state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # get-or-create: instruments are cheap and names are the contract
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self._lock)
            return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, self._lock,
                                                       buckets)
            return h

    def snapshot(self) -> dict:
        """One consistent point-in-time view as plain JSON-able data."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "counters": {n: c._snap()
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g._snap()
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h._snap()
                               for n, h in sorted(self._histograms.items())},
            }

    def dump(self, path: str) -> dict:
        """Write the snapshot as the flat JSON metrics artifact
        (``METRICS_*.json`` — the schema the BENCH artifacts adopt)."""
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        return snap

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry (what the hot paths feed)."""
    return _default
