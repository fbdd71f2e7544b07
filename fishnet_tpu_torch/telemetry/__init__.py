"""Live telemetry, the metrics half: the registry and the Prometheus
exposition server — the port of ``fishnet_tpu/telemetry/`` without its
span flight recorder, traces, profiler and fleet layers.

* :mod:`fishnet_tpu_torch.telemetry.registry` — Counter/Gauge/Histogram
  with per-thread cells aggregated at scrape time, plus pull-style
  collector callbacks adapting the port's existing counters;
* :mod:`fishnet_tpu_torch.telemetry.exporter` — ``/metrics``
  (Prometheus text), ``/json`` and ``/healthz`` on a stdlib
  ``http.server`` thread.

The exported names follow doc/observability.md, the JAX package's
contract, so a dashboard built for the JAX worker reads the port.

Hot-path discipline: metric collection is pull-only, so a never-scraped
process pays nothing beyond the always-on per-thread counter cells the
JAX package has too. :func:`enabled` is the JAX package's span flag:
``start_exporter`` flips it on, and nothing reads it yet (the span
recorder is not ported); it stays so that the spans plug in without
changing callers.
"""

from __future__ import annotations

from fishnet_tpu_torch.telemetry.registry import (  # noqa: F401 - public API
    REGISTRY,
    SUMMARY_QUANTILES,
    Counter,
    Gauge,
    Histogram,
    MetricFamily,
    MetricsRegistry,
    Sample,
    counter_family,
    gauge_family,
    histogram_quantiles,
    percentile,
    quantile_from_buckets,
)

_enabled = False


def enabled() -> bool:
    """Whether hot-path span recording is on (off by default)."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def start_exporter(port: int, host: str = "127.0.0.1"):
    """The one-call opt-in: enable the flag and serve ``/metrics`` on
    ``port`` (0 = ephemeral). Returns the :class:`MetricsExporter`. (The
    JAX package also arms a SIGUSR2 span dump and the profiler here;
    neither module is ported.)"""
    from fishnet_tpu_torch.telemetry.exporter import MetricsExporter

    enable()
    return MetricsExporter(port=port, host=host)
