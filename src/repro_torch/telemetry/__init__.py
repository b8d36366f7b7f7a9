"""Telemetry: per-link NoC heatmaps, Chrome-trace timelines, metrics.

Zero-overhead-when-off instrumentation threaded through the simulator,
serving loop and DSE:

* :mod:`repro_torch.telemetry.heatmap` — :class:`LinkRecorder` hooks
  ``NoCTransport`` accounting and resolves the per-class
  ``TrafficCounters`` totals down to individual mesh links, with an
  exact-integer conservation check against the counters *and* the
  energy model's routed byte-hops.
* :mod:`repro_torch.telemetry.spans` — nestable host wall-clock
  :class:`Span`/:class:`Profiler` plus the streaming stage x frame
  timeline, exported as Chrome trace-event JSON (Perfetto-viewable).
* :mod:`repro_torch.telemetry.metrics` — Prometheus-style
  counters/gauges/histograms with labelled series and JSON snapshots,
  backing ``serve_stream``.

``python -m repro_torch.telemetry`` renders heatmaps and summarizes traces.
"""
from repro_torch.telemetry.heatmap import (FlowStats, LinkHeatmap, LinkRecorder,
                                           TRAFFIC_CLASSES, check_conservation,
                                           record_run)
from repro_torch.telemetry.metrics import (DEFAULT_BUCKETS, MetricFamily,
                                           MetricsRegistry)
from repro_torch.telemetry.spans import (Profiler, TRACE_PID_HOST, TRACE_PID_SIM,
                                         active_profiler, chrome_trace,
                                         load_chrome_trace, span,
                                         stream_timeline_events,
                                         validate_chrome_trace, write_chrome_trace)

__all__ = [
    "FlowStats", "LinkHeatmap", "LinkRecorder", "TRAFFIC_CLASSES",
    "check_conservation", "record_run",
    "DEFAULT_BUCKETS", "MetricFamily", "MetricsRegistry",
    "Profiler", "TRACE_PID_HOST", "TRACE_PID_SIM", "active_profiler",
    "chrome_trace", "load_chrome_trace", "span", "stream_timeline_events",
    "validate_chrome_trace", "write_chrome_trace",
]
