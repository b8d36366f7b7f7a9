"""Prometheus-style metrics registry: counters, gauges, histograms.

A tiny in-process implementation of the Prometheus data model — metric
*families* keyed by name with typed *series* keyed by label values —
backing the serving loop (queue depth, per-frame latency, straggler
flags, goodput).  Families are created idempotently through a
:class:`MetricsRegistry`, so independent call sites (and, later,
per-tenant serving) can ``registry.counter("frames_total",
labelnames=("tenant",)).labels(tenant="a").inc()`` without coordination
or refactoring.

:meth:`MetricsRegistry.snapshot` renders everything into a plain JSON
document (one entry per family, one record per labelled series;
histograms expose cumulative bucket counts plus ``sum``/``count``,
mirroring Prometheus exposition semantics).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NO_LABELS: Tuple[str, ...] = ()

#: default histogram upper bounds (unitless; callers pass their own for
#: cycle- or second-valued series)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, 5000.0, 10000.0)


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up; use a gauge")
        self.value += v


class _GaugeSeries:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


class _HistogramSeries:
    __slots__ = ("bounds", "bucket_counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        self.bucket_counts[i] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """Prometheus-style cumulative ``le`` buckets ending at +Inf."""
        out: List[Tuple[str, int]] = []
        acc = 0
        for b, c in zip(self.bounds, self.bucket_counts):
            acc += c
            out.append((repr(float(b)), acc))
        out.append(("+Inf", acc + self.bucket_counts[-1]))
        return out


_SERIES_TYPES = {"counter": _CounterSeries, "gauge": _GaugeSeries,
                 "histogram": _HistogramSeries}


class MetricFamily:
    """A named metric with zero or more labelled series."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = _NO_LABELS,
                 buckets: Optional[Sequence[float]] = None):
        if kind not in _SERIES_TYPES:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            bounds = tuple(float(b) for b in
                           (DEFAULT_BUCKETS if buckets is None else buckets))
            if list(bounds) != sorted(bounds):
                raise ValueError("histogram buckets must be sorted")
            self._buckets: Optional[Tuple[float, ...]] = bounds
        else:
            if buckets is not None:
                raise ValueError("buckets only apply to histograms")
            self._buckets = None
        self._series: Dict[Tuple[str, ...], Any] = {}

    def labels(self, **kv: str):
        """The series for these label values (created on first use)."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        s = self._series.get(key)
        if s is None:
            s = (_HistogramSeries(self._buckets) if self.kind == "histogram"
                 else _SERIES_TYPES[self.kind]())
            self._series[key] = s
        return s

    # unlabelled families proxy straight to their single default series
    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        return self.labels()

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def snapshot(self) -> Dict[str, Any]:
        series = []
        for key, s in sorted(self._series.items()):
            rec: Dict[str, Any] = {
                "labels": dict(zip(self.labelnames, key))}
            if self.kind == "histogram":
                rec["count"] = s.count
                rec["sum"] = s.sum
                rec["buckets"] = {le: c for le, c in s.cumulative()}
            else:
                rec["value"] = s.value
            series.append(rec)
        out: Dict[str, Any] = {"type": self.kind, "help": self.help,
                               "series": series}
        if self.labelnames:
            out["labelnames"] = list(self.labelnames)
        return out


class MetricsRegistry:
    """Holds metric families; creation is idempotent by (name, kind)."""

    def __init__(self) -> None:
        self._families: Dict[str, MetricFamily] = {}

    def _get(self, name: str, kind: str, help: str,
             labelnames: Sequence[str],
             buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}")
            if fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{fam.labelnames}")
            return fam
        fam = MetricFamily(name, kind, help, labelnames, buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = _NO_LABELS) -> MetricFamily:
        return self._get(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = _NO_LABELS) -> MetricFamily:
        return self._get(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = _NO_LABELS,
                  buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        return self._get(name, "histogram", help, labelnames, buckets)

    def snapshot(self) -> Dict[str, Any]:
        return {"metrics": {name: fam.snapshot()
                            for name, fam in sorted(self._families.items())}}

    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path
