"""Process-wide metrics registry: counters, gauges, histograms.

Reference parity: NONE (deliberate surplus — see telemetry/trace.py).
The registry is always on (unlike spans): metric updates must be cheap
enough to leave unconditional, and counters like ``transfers_parked`` /
``involuntary_remat`` must be visible even when nobody asked for a
timeline.

WRITE PATH (ISSUE 16 rebuild): counters and histograms are sharded per
writer thread — an update touches only the calling thread's shard, no
lock. Counter shards are plain int cells summed at read; histogram
shards pair the streaming stats with a per-shard uniform reservoir
(Vitter's Algorithm R, per-shard RNG seeded identically so a
single-threaded observation sequence reproduces the exact historical
snapshot) and publish the (count, sum) pair as one atomic tuple store
after every observation. That keeps the consumer-facing invariant EXACT
under concurrency — ``mean * count == sum`` in every snapshot, never a
torn (count, sum) pair — without a lock on observe().

``snapshot()`` returns a plain-JSON dict that travels inside the
``GetTelemetry`` response header; ``merge()`` folds snapshots from many
workers into one fleet view (counters/histograms add, gauges keep the
max — a merged gauge has no single true value, and max is the
conservative read for the RTT/lag gauges this repo records).
"""

from __future__ import annotations

import math
import random
import threading
from typing import Any, Dict, Iterable, List, Optional


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Linear-interpolated quantile over an already-sorted sample."""
    if not sorted_vals:
        return None
    idx = q * (len(sorted_vals) - 1)
    lo = int(math.floor(idx))
    hi = int(math.ceil(idx))
    if lo == hi:
        return sorted_vals[lo]
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Counter:
    """Monotonic counter: per-thread shards, summed at read."""

    __slots__ = ("_tls", "_reg_lock", "_shards")

    def __init__(self):
        self._tls = threading.local()
        self._reg_lock = threading.Lock()
        self._shards: List[List[int]] = []

    def inc(self, n: int = 1) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = [0]
            with self._reg_lock:
                self._shards.append(s)
            self._tls.shard = s
        s[0] += n

    @property
    def value(self) -> int:
        with self._reg_lock:
            shards = list(self._shards)
        return sum(s[0] for s in shards)


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class _HShard:
    """One writer thread's histogram state. ``pub`` is the coherency
    point: the (count, sum) pair is published as ONE tuple store after
    each observation, so a reader always sees a matched pair — never a
    count without its sum. (A seqlock would be the classic shape, but a
    reader spinning on a version counter livelocks under the GIL: a
    preempted writer parks the version odd for a full switch interval.)"""

    __slots__ = ("count", "sum", "min", "max", "reservoir", "rng", "pub")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.reservoir: List[float] = []
        self.rng = random.Random(0x7e9d)
        self.pub = (0, 0.0)


class Histogram:
    """Streaming count/sum/min/max plus a fixed-size uniform reservoir
    (Vitter's Algorithm R) so ``to_dict()`` can report p50/p95/p99 SLO
    percentiles without committing to a bucket layout on the wire. The
    reservoir is exact below RESERVOIR_SIZE observations per shard and
    an unbiased uniform sample above it; each shard's RNG is seeded
    identically so snapshots are deterministic under a fixed observation
    sequence."""

    RESERVOIR_SIZE = 256

    __slots__ = ("_tls", "_reg_lock", "_shards")

    def __init__(self):
        self._tls = threading.local()
        self._reg_lock = threading.Lock()
        self._shards: List[_HShard] = []

    def observe(self, v: float) -> None:
        v = float(v)
        try:
            s = self._tls.shard
        except AttributeError:
            s = _HShard()
            with self._reg_lock:
                self._shards.append(s)
            self._tls.shard = s
        count = s.count + 1
        s.count = count
        total = s.sum + v
        s.sum = total
        if s.min is None or v < s.min:
            s.min = v
        if s.max is None or v > s.max:
            s.max = v
        res = s.reservoir
        if len(res) < self.RESERVOIR_SIZE:
            res.append(v)
        else:
            j = s.rng.randrange(count)
            if j < self.RESERVOIR_SIZE:
                res[j] = v
        s.pub = (count, total)      # the one atomic publish

    @staticmethod
    def _read_shard(s: _HShard):
        # pub is a single tuple load: count and sum always match. min/
        # max/reservoir may run one in-flight observation ahead of pub —
        # harmless for any consumer, and the mean*count == sum identity
        # holds exactly.
        count, total = s.pub
        return count, total, s.min, s.max, s.reservoir[:]

    def to_dict(self) -> Dict[str, Any]:
        with self._reg_lock:
            shards = list(self._shards)
        count = 0
        total = 0.0
        lo: Optional[float] = None
        hi: Optional[float] = None
        pooled: List[float] = []
        for s in shards:
            c, t, mn, mx, res = self._read_shard(s)
            count += c
            total += t
            if mn is not None and (lo is None or mn < lo):
                lo = mn
            if mx is not None and (hi is None or mx > hi):
                hi = mx
            pooled.extend(res)
        pooled.sort()
        mean = total / count if count else 0.0
        sample = pooled
        if len(sample) > self.RESERVOIR_SIZE:
            # Thin the pooled multi-shard sample back to the wire cap by
            # even stride (percentiles were taken over the full pool).
            step = len(sample) / self.RESERVOIR_SIZE
            sample = [pooled[int(i * step)]
                      for i in range(self.RESERVOIR_SIZE)]
        return {"count": count, "sum": total, "mean": mean,
                "min": lo, "max": hi,
                "p50": _quantile(pooled, 0.50),
                "p95": _quantile(pooled, 0.95),
                "p99": _quantile(pooled, 0.99),
                "reservoir": sample}


class MetricsRegistry:
    """Named get-or-create registry; all maps are keyed by metric name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def snapshot(self) -> Dict[str, Any]:
        """One CONSISTENT snapshot: the metric maps are copied under the
        registry lock, then each metric folds its shards (Counter.value
        sums; Gauge assignment is atomic; ``Histogram.to_dict`` reads
        each shard's published (count, sum) pair) — a worker thread mutating mid-snapshot
        can no longer produce a histogram whose count, sum, and mean
        disagree. ``to_prometheus`` consumes this same snapshot
        (telemetry/export.py)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
            "histograms": {k: h.to_dict() for k, h in histograms.items()},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    @staticmethod
    def merge(snapshots: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
        """Fold many ``snapshot()`` dicts into one fleet-wide view."""
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        for snap in snapshots:
            if not snap:
                continue
            for k, v in snap.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
            for k, v in snap.get("gauges", {}).items():
                if v is None:
                    continue
                if k not in gauges or v > gauges[k]:
                    gauges[k] = v
            for k, h in snap.get("histograms", {}).items():
                cur = hists.get(k)
                if cur is None:
                    hists[k] = dict(h)
                    continue
                cur["count"] += h["count"]
                cur["sum"] += h["sum"]
                for fn, key in ((min, "min"), (max, "max")):
                    vals = [x for x in (cur[key], h[key]) if x is not None]
                    cur[key] = fn(vals) if vals else None
                cur["mean"] = (cur["sum"] / cur["count"]
                               if cur["count"] else 0.0)
                # Pool the uniform reservoirs, recompute the percentiles
                # over the pooled sample, then thin back to RESERVOIR_SIZE
                # by even stride (deterministic, distribution-preserving)
                # so repeated merges don't grow the wire payload.
                pooled = sorted(list(cur.get("reservoir", ()))
                                + list(h.get("reservoir", ())))
                if pooled:
                    cur["p50"] = _quantile(pooled, 0.50)
                    cur["p95"] = _quantile(pooled, 0.95)
                    cur["p99"] = _quantile(pooled, 0.99)
                    cap = Histogram.RESERVOIR_SIZE
                    if len(pooled) > cap:
                        step = len(pooled) / cap
                        pooled = [pooled[int(i * step)] for i in range(cap)]
                    cur["reservoir"] = pooled
        return {"counters": counters, "gauges": gauges, "histograms": hists}


_REGISTRY = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY
