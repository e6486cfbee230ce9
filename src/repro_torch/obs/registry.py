"""MetricsRegistry: the one place the service's numbers live.

Three metric kinds, all labeled, all readable from one registry:

  * `Counter` — monotone accumulators (requests, escalations, joules).
    Cleared by `reset()` (the "after a warmup burst" contract).
  * `Gauge` — last-write-wins state (queue depth, shed mode, straggler
    strikes). Gauges describe the service *now*, so `reset()` leaves them
    alone unless the gauge opted in with ``clear_on_reset=True`` (per-run
    aggregates like min/max batch fill).
  * `Histogram` — fixed-bucket latency distributions with TWO views over
    one `observe()` stream: the cumulative counts (cleared by reset, what
    the Prometheus renderer exports) and a bounded **rolling window**
    (survives reset — it feeds the overload policy, and a metrics reset
    must never blind load shedding). Quantiles are computed exactly from
    the bucket counts (deterministic linear interpolation inside the
    containing bucket), so every consumer of "the p99" — `metrics()`,
    the shed check, `health()` — reads the identical value instead of
    running its own `np.percentile` over its own private reservoir.

Accumulation is plain-Python dict/float arithmetic (atomic under the GIL,
no locks taken on the tick path); rendering/iteration happens off the hot
path via `collect()`.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import deque
from typing import Iterator, NamedTuple

#: default latency buckets (ms) — sub-tick through first-tick compile
#: stalls and pathological queueing
DEFAULT_LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                              50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
                              10000.0)

#: hard bound on label-set cardinality per metric family; a tenant-labeled
#: counter growing past this means a label leak, not a big fleet
MAX_LABEL_SETS = 1024


class Sample(NamedTuple):
    """One exported time-series point: (name, labels, value)."""

    name: str
    labels: tuple[tuple[str, str], ...]
    value: float


def _label_key(labels: dict | None) -> tuple[tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """Shared plumbing: a named metric with per-label-set children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: dict[tuple, float] = {}

    def _child(self, labels: dict | None) -> tuple:
        key = _label_key(labels)
        if key not in self._children:
            if len(self._children) >= MAX_LABEL_SETS:
                raise ValueError(
                    f"metric {self.name!r} exceeded {MAX_LABEL_SETS} label "
                    "sets — unbounded label cardinality")
            self._children[key] = 0.0
        return key

    def value(self, **labels) -> float:
        """Read one child (0.0 when the label set was never touched)."""
        return self._children.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum across every label set."""
        return sum(self._children.values())

    def items(self) -> Iterator[tuple[dict, float]]:
        """(labels-as-dict, value) per child — registry-backed views
        (e.g. `health()`'s per-host straggler strikes) read through this."""
        for key, v in sorted(self._children.items()):
            yield dict(key), v

    def samples(self) -> Iterator[Sample]:
        for key, v in sorted(self._children.items()):
            yield Sample(self.name, key, v)


class Counter(_Family):
    """Monotone accumulator; cleared by `MetricsRegistry.reset()`."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._children[self._child(labels)] += amount

    def clear(self) -> None:
        for key in self._children:
            self._children[key] = 0.0


class Gauge(_Family):
    """Last-write-wins state. Survives `reset()` unless constructed with
    ``clear_on_reset=True`` (per-run aggregates such as min/max fill)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", *,
                 clear_on_reset: bool = False):
        super().__init__(name, help)
        self.clear_on_reset = clear_on_reset

    def set(self, value: float, **labels) -> None:
        self._children[self._child(labels)] = float(value)

    def set_min(self, value: float, **labels) -> None:
        """Running minimum; 0.0 doubles as "unset" (every observed fill
        is >= 1, so the sentinel never collides with a real minimum)."""
        key = self._child(labels)
        cur = self._children[key]
        self._children[key] = float(value) if cur == 0.0 \
            else min(cur, float(value))

    def set_max(self, value: float, **labels) -> None:
        key = self._child(labels)
        self._children[key] = max(self._children.get(key, 0.0), value)

    def clear(self) -> None:
        for key in self._children:
            self._children[key] = 0.0


class Histogram:
    """Fixed-bucket histogram with a cumulative view AND a rolling window.

    One `observe()` feeds both. The cumulative counts/sum are what the
    Prometheus renderer exports and what `reset()` clears; the rolling
    window (bounded deque of bucket indices, O(1) per observation) is the
    overload-policy view — `quantile(q)` reads it by default, so the shed
    check and `metrics()` report the IDENTICAL number, and a metrics reset
    does not blind load shedding.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS,
                 window: int = 256):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be strictly increasing, got "
                             f"{buckets}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)  # upper bounds
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._window: deque[int] = deque(maxlen=window)
        self._win_counts = [0] * (len(self.buckets) + 1)

    def observe(self, value: float) -> None:
        i = bisect_left(self.buckets, value)
        self.counts[i] += 1
        self.sum += value
        self.count += 1
        if len(self._window) == self._window.maxlen:
            self._win_counts[self._window[0]] -= 1
        self._window.append(i)
        self._win_counts[i] += 1

    @property
    def window_count(self) -> int:
        return len(self._window)

    def quantile(self, q: float, *, window: bool = True) -> float:
        """Exact-from-buckets quantile: find the bucket holding the q-rank
        observation and interpolate linearly inside it. Deterministic —
        every caller reading the same counts gets the same value. Returns
        0.0 when empty. ``window=False`` reads the cumulative counts."""
        counts = self._win_counts if window else self.counts
        total = len(self._window) if window else self.count
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0.0
        lo = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                lo = self.buckets[i] if i < len(self.buckets) else lo
                continue
            hi = self.buckets[i] if i < len(self.buckets) else lo
            if seen + c >= rank:
                frac = min(max((rank - seen) / c, 0.0), 1.0)
                return lo + (hi - lo) * frac
            seen += c
            lo = hi
        return lo

    def clear(self) -> None:
        """Clear the cumulative view ONLY; the rolling window survives
        (it is health state, not a counter — see module docstring)."""
        self.counts = [0] * len(self.counts)
        self.sum = 0.0
        self.count = 0

    def samples(self) -> Iterator[Sample]:
        cum = 0
        for i, ub in enumerate(self.buckets):
            cum += self.counts[i]
            yield Sample(f"{self.name}_bucket", (("le", repr(ub)),), cum)
        cum += self.counts[-1]
        yield Sample(f"{self.name}_bucket", (("le", "+Inf"),), cum)
        yield Sample(f"{self.name}_sum", (), self.sum)
        yield Sample(f"{self.name}_count", (), self.count)


class MetricsRegistry:
    """Named metric families, one namespace, one reset contract."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _register(self, name: str, factory):
        if name in self._metrics:
            existing = self._metrics[name]
            if type(existing) is not factory.cls:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{existing.kind}")
            return existing
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        fn = lambda: Counter(name, help)
        fn.cls = Counter
        return self._register(name, fn)

    def gauge(self, name: str, help: str = "", *,
              clear_on_reset: bool = False) -> Gauge:
        fn = lambda: Gauge(name, help, clear_on_reset=clear_on_reset)
        fn.cls = Gauge
        return self._register(name, fn)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS,
                  window: int = 256) -> Histogram:
        fn = lambda: Histogram(name, help, buckets, window)
        fn.cls = Histogram
        return self._register(name, fn)

    def get(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def collect(self) -> Iterator[tuple[object, list[Sample]]]:
        """(family, samples) pairs in name order — the exporter's feed."""
        for name in sorted(self._metrics):
            m = self._metrics[name]
            yield m, list(m.samples())

    def reset(self) -> None:
        """The documented reset contract: counters and cumulative histogram
        counts go to zero; gauges (unless ``clear_on_reset``) and histogram
        rolling windows survive — they are live health state, and zeroing
        them would blind the overload policy mid-flight."""
        for m in self._metrics.values():
            if isinstance(m, Counter):
                m.clear()
            elif isinstance(m, Histogram):
                m.clear()
            elif isinstance(m, Gauge) and m.clear_on_reset:
                m.clear()
