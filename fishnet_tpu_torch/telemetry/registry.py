"""Metrics registry: Counter / Gauge / Histogram primitives plus
pull-style collectors, rendered as Prometheus text format or a JSON
snapshot.

The port's own copy of ``fishnet_tpu/telemetry/registry.py`` (plain
Python; the port imports nothing of the JAX package). Design
constraints, as there (doc/observability.md):

* **No shared lock on any hot path.** Instruments write into per-thread
  cells (one plain Python object per thread per instrument child);
  aggregation happens at scrape time by summing the cells. The only
  locks are creation-time (first touch of an instrument from a new
  thread) and scrape-time — a driver thread in ``search/service.py``
  incrementing a counter mid-step never contends with a scrape.
* **Pull beats push.** Most of the port's signals already exist as
  cumulative counters (``SearchService.counters()``, the native
  ``fc_pool_counters``, ``StatsRecorder`` totals, queue depths); those
  are adapted as *collector callbacks* that run only when a scrape
  happens, so serving traffic pays nothing for them.
* Collectors returning ``None`` are dropped (the weakref-to-owner
  idiom: a collector over a closed/garbage service unregisters itself).

The exported metric names are a stable contract shared with the JAX
package — see doc/observability.md before renaming anything here or in
a collector.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_OK = None  # compiled lazily (re import kept out of the hot module load)


def _valid_name(name: str) -> bool:
    global _NAME_OK
    if _NAME_OK is None:
        import re

        _NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
    return bool(_NAME_OK.match(name))


@dataclass
class Sample:
    """One exposition line: ``name{labels} value``. ``name`` may differ
    from the family name (histogram ``_bucket``/``_sum``/``_count``)."""

    name: str
    value: float
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class MetricFamily:
    """A named metric with HELP/TYPE metadata and its samples."""

    name: str
    type: str  # "counter" | "gauge" | "histogram"
    help: str
    samples: List[Sample] = field(default_factory=list)


#: Latency buckets for request-scale histograms (seconds).
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _CounterCell:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class _HistogramCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class _PerThread:
    """Per-thread cell management shared by Counter and Histogram
    children. ``cell()`` is the hot path: one threading.local attribute
    read; the creation lock is taken once per (thread, child)."""

    __slots__ = ("_local", "_cells", "_lock", "_make")

    def __init__(self, make: Callable[[], object]) -> None:
        self._local = threading.local()
        self._cells: List[object] = []
        self._lock = threading.Lock()
        self._make = make

    def cell(self):
        c = getattr(self._local, "cell", None)
        if c is None:
            c = self._make()
            with self._lock:
                self._cells.append(c)
            self._local.cell = c
        return c

    def cells(self) -> List[object]:
        # Snapshot under the creation lock: appends are rare, and the
        # copy keeps iteration safe against one landing mid-scrape.
        with self._lock:
            return list(self._cells)


class _LabeledInstrument:
    """Base for instruments with optional labels: ``labels(**kw)``
    returns a cached child; label-less instruments are their own sole
    child."""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _valid_name(name):
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._children_lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._make_child(())

    def _make_child(self, labelvalues: Tuple[str, ...]):
        raise NotImplementedError

    def labels(self, **labels: str):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        key = tuple(str(labels[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._children_lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child(key)
                    self._children[key] = child
        return child

    def _child_items(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._children_lock:
            return list(self._children.items())

    def _label_dict(self, values: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, values))


class _CounterChild:
    __slots__ = ("_cells",)

    def __init__(self) -> None:
        self._cells = _PerThread(_CounterCell)

    def inc(self, value: float = 1.0) -> None:
        self._cells.cell().value += value

    def value(self) -> float:
        return sum(c.value for c in self._cells.cells())


class Counter(_LabeledInstrument):
    """Monotone counter. ``inc()`` writes a per-thread cell (no shared
    lock); ``value()`` sums the cells at scrape time."""

    type = "counter"

    def _make_child(self, labelvalues: Tuple[str, ...]) -> _CounterChild:
        return _CounterChild()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        (self.labels(**labels) if labels else self._children[()]).inc(value)

    def value(self, **labels: str) -> float:
        return (self.labels(**labels) if labels else self._children[()]).value()

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.type, self.help)
        for values, child in self._child_items():
            fam.samples.append(
                Sample(self.name, child.value(), self._label_dict(values))
            )
        return fam


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value  # single slot: last write wins (GIL-atomic)


class Gauge(_LabeledInstrument):
    """Last-write-wins gauge; ``set_function`` makes it pull-style."""

    type = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._fn: Optional[Callable[[], float]] = None

    def _make_child(self, labelvalues: Tuple[str, ...]) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float, **labels: str) -> None:
        (self.labels(**labels) if labels else self._children[()]).set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        if self.labelnames:
            raise ValueError("set_function requires a label-less gauge")
        self._fn = fn

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.type, self.help)
        if self._fn is not None:
            fam.samples.append(Sample(self.name, float(self._fn()), {}))
            return fam
        for values, child in self._child_items():
            fam.samples.append(
                Sample(self.name, child.value, self._label_dict(values))
            )
        return fam


class _HistogramChild:
    __slots__ = ("_bounds", "_cells")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._bounds = bounds
        self._cells = _PerThread(lambda: _HistogramCell(len(bounds)))

    def observe(self, value: float) -> None:
        cell = self._cells.cell()
        i = bisect_left(self._bounds, value)
        if i < len(cell.counts):
            cell.counts[i] += 1
        cell.sum += value
        cell.count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        counts = [0] * len(self._bounds)
        total = 0.0
        n = 0
        for cell in self._cells.cells():
            for i, c in enumerate(cell.counts):
                counts[i] += c
            total += cell.sum
            n += cell.count
        return counts, total, n


class Histogram(_LabeledInstrument):
    """Fixed-bucket histogram with per-thread cells; rendered with
    cumulative ``_bucket{le=...}`` samples plus ``_sum``/``_count``."""

    type = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DEFAULT_TIME_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames)

    def _make_child(self, labelvalues: Tuple[str, ...]) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float, **labels: str) -> None:
        (self.labels(**labels) if labels else self._children[()]).observe(value)

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.type, self.help)
        for values, child in self._child_items():
            base = self._label_dict(values)
            counts, total, n = child.snapshot()
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                labels = dict(base)
                labels["le"] = _format_bound(bound)
                fam.samples.append(Sample(f"{self.name}_bucket", cum, labels))
            labels = dict(base)
            labels["le"] = "+Inf"
            fam.samples.append(Sample(f"{self.name}_bucket", n, labels))
            fam.samples.append(Sample(f"{self.name}_sum", total, dict(base)))
            fam.samples.append(Sample(f"{self.name}_count", n, dict(base)))
        return fam


def _format_bound(b: float) -> str:
    return repr(int(b)) if float(b).is_integer() else repr(b)


#: The quantiles every histogram summary reports. A stable contract:
#: the JAX package's bench, fleet console and SLO engine read these keys
#: instead of re-deriving percentiles their own way, and so may any
#: reader of the port's /json.
SUMMARY_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over RAW samples (q in [0, 100]); None
    on no samples (the JAX package's definition) — keep percentile math
    in one place."""
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, round(q / 100.0 * (len(vs) - 1))))
    return vs[idx]


def quantile_from_buckets(
    bounds: Sequence[float],
    cumulative: Sequence[float],
    total: float,
    q: float,
) -> Optional[float]:
    """Estimate the ``q`` quantile (q in [0, 1]) from cumulative
    histogram bucket counts (Prometheus ``histogram_quantile``
    semantics: linear interpolation within the bucket; the +Inf bucket
    clamps to the largest finite bound). None when the histogram is
    empty."""
    if total <= 0:
        return None
    rank = q * total
    prev_bound = 0.0
    prev_count = 0.0
    for bound, count in zip(bounds, cumulative):
        if count >= rank:
            in_bucket = count - prev_count
            if in_bucket <= 0:
                return float(bound)
            frac = (rank - prev_count) / in_bucket
            return float(prev_bound + (bound - prev_bound) * frac)
        prev_bound, prev_count = float(bound), float(count)
    return float(bounds[-1]) if bounds else None


def histogram_quantiles(
    fam: "MetricFamily", quantiles: Sequence[float] = SUMMARY_QUANTILES
) -> List[dict]:
    """Per-label-set quantile summaries for a histogram FAMILY (the
    flat ``_bucket``/``_sum``/``_count`` exposition shape — works on a
    live instrument's collect() and on families federated from another
    process alike). Returns one dict per label set:
    ``{"labels": {...}, "count": n, "sum": s, "p50": ..., ...}``."""
    if fam.type != "histogram":
        return []
    groups: Dict[Tuple[Tuple[str, str], ...], dict] = {}
    for s in fam.samples:
        base = {k: v for k, v in s.labels.items() if k != "le"}
        key = tuple(sorted(base.items()))
        g = groups.setdefault(
            key, {"labels": base, "buckets": [], "sum": 0.0, "count": 0.0}
        )
        if s.name.endswith("_bucket"):
            le = s.labels.get("le", "+Inf")
            if le not in ("+Inf", "inf"):
                g["buckets"].append((float(le), float(s.value)))
        elif s.name.endswith("_sum"):
            g["sum"] = float(s.value)
        elif s.name.endswith("_count"):
            g["count"] = float(s.value)
    out = []
    for g in groups.values():
        g["buckets"].sort(key=lambda bc: bc[0])
        bounds = [b for b, _ in g["buckets"]]
        cum = [c for _, c in g["buckets"]]
        row = {"labels": g["labels"], "count": g["count"], "sum": g["sum"]}
        for q in quantiles:
            row[f"p{int(q * 100)}"] = quantile_from_buckets(
                bounds, cum, g["count"], q
            )
        out.append(row)
    return out


class MetricsRegistry:
    """Instrument + collector registry. Scrapes serialize on one lock so
    ``unregister_collector`` can guarantee its callback is not mid-run
    (the SearchService close path relies on this before freeing the
    native pool the collector reads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()  # creation / (un)registration
        self._scrape_lock = threading.Lock()
        self._instruments: Dict[str, _LabeledInstrument] = {}
        self._collectors: Dict[int, Tuple[str, Callable]] = {}
        self._next_token = 0
        self._collector_errors = Counter(
            "fishnet_telemetry_collector_errors_total",
            "Collector callbacks that raised during a scrape.",
            labelnames=("collector",),
        )

    # -- instruments ------------------------------------------------------

    def _instrument(self, cls, name, help, **kwargs):
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type}"
                    )
                return existing
            inst = cls(name, help, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str, labelnames=()) -> Counter:
        return self._instrument(Counter, name, help, labelnames=labelnames)

    def gauge(self, name: str, help: str, labelnames=()) -> Gauge:
        return self._instrument(Gauge, name, help, labelnames=labelnames)

    def histogram(
        self, name: str, help: str, labelnames=(), buckets=DEFAULT_TIME_BUCKETS
    ) -> Histogram:
        return self._instrument(
            Histogram, name, help, labelnames=labelnames, buckets=buckets
        )

    # -- collectors -------------------------------------------------------

    def register_collector(
        self, fn: Callable[[], Optional[Iterable[MetricFamily]]], name: str = ""
    ) -> int:
        """Register a pull callback returning MetricFamily objects (or
        None to self-unregister). Returns a token for unregister."""
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._collectors[token] = (name or f"collector-{token}", fn)
            return token

    def unregister_collector(self, token: int) -> None:
        """Remove a collector; blocks until no scrape is running, so the
        callback can never fire after this returns."""
        with self._scrape_lock:
            with self._lock:
                self._collectors.pop(token, None)

    def scrape_barrier(self) -> None:
        """Block until no scrape is mid-flight. The close-path symmetry
        of :meth:`unregister_collector`: an exporter shutting down calls
        this so no collector callback can still be running against a
        service being torn down when ``close()`` returns."""
        with self._scrape_lock:
            pass

    # -- scraping ---------------------------------------------------------

    def collect(self) -> List[MetricFamily]:
        with self._scrape_lock:
            with self._lock:
                instruments = list(self._instruments.values())
                collectors = list(self._collectors.items())
            families = [inst.collect() for inst in instruments]
            dead = []
            for token, (name, fn) in collectors:
                try:
                    result = fn()
                except Exception:  # noqa: BLE001 - a bad collector must not kill scrapes
                    self._collector_errors.inc(collector=name)
                    continue
                if result is None:
                    dead.append(token)
                    continue
                families.extend(result)
            families.append(self._collector_errors.collect())
            if dead:
                with self._lock:
                    for token in dead:
                        self._collectors.pop(token, None)
        merged: Dict[str, MetricFamily] = {}
        for fam in families:
            seen = merged.get(fam.name)
            if seen is None:
                merged[fam.name] = fam
            else:
                seen.samples.extend(fam.samples)
        return sorted(merged.values(), key=lambda f: f.name)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for fam in self.collect():
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.type}")
            for s in fam.samples:
                out.append(f"{s.name}{_format_labels(s.labels)} {_format_value(s.value)}")
        return "\n".join(out) + "\n"

    def render_json(self) -> dict:
        """JSON snapshot of the same families (the debug endpoint).
        Histogram families carry a ``quantiles`` summary (p50/p90/p99
        per label set, interpolated from the buckets) so consumers — any
        dashboard or bench — read percentiles from one derivation instead of re-deriving from raw buckets."""
        metrics = {}
        for fam in self.collect():
            entry = {
                "type": fam.type,
                "help": fam.help,
                "samples": [
                    {"name": s.name, "labels": s.labels, "value": s.value}
                    for s in fam.samples
                ],
            }
            if fam.type == "histogram":
                entry["quantiles"] = histogram_quantiles(fam)
            metrics[fam.name] = entry
        return {"time": time.time(), "metrics": metrics}


def _format_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + parts + "}"


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _format_value(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 2**63:
        return str(int(f))
    return repr(f)


def counter_family(name: str, help: str, value: float, labels=None) -> MetricFamily:
    """One-sample counter family — the collector-callback convenience."""
    return MetricFamily(
        name, "counter", help, [Sample(name, float(value), dict(labels or {}))]
    )


def gauge_family(name: str, help: str, value: float, labels=None) -> MetricFamily:
    return MetricFamily(
        name, "gauge", help, [Sample(name, float(value), dict(labels or {}))]
    )


#: Process-wide default registry; everything in-tree registers here so
#: one exporter serves the whole process (client, trainers, tests alike).
REGISTRY = MetricsRegistry()
