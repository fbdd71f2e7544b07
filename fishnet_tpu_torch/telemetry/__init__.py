"""Live telemetry: the metrics registry, the Prometheus exposition, the
span flight recorder and the profiling plane — the port of
``fishnet_tpu/telemetry/`` without its fleet layer (``fleet``,
``stitch``) and its bench sentinel (``regress``).

* :mod:`fishnet_tpu_torch.telemetry.registry` — Counter/Gauge/Histogram
  with per-thread cells aggregated at scrape time, plus pull-style
  collector callbacks adapting the port's existing counters;
* :mod:`fishnet_tpu_torch.telemetry.spans` — a fixed-size ring of
  monotonic-clock spans around the pipeline stages, dumped as JSONL on
  SIGUSR2, driver crash, clean close and drain;
* :mod:`fishnet_tpu_torch.telemetry.tracing` — the causal trace
  contexts the spans carry (batch traces and step traces);
* :mod:`fishnet_tpu_torch.telemetry.exporter` — ``/metrics``
  (Prometheus text), ``/json``, ``/spans``, ``/trace``, ``/profile``
  and ``/healthz`` on a stdlib ``http.server`` thread;
* :mod:`fishnet_tpu_torch.telemetry.trace_export` — the spans as a
  Chrome/Perfetto trace (``/trace`` and a CLI over dumps);
* :mod:`fishnet_tpu_torch.telemetry.critical_path` — span-tree
  reconstruction, orphan detection and wall-time attribution;
* :mod:`fishnet_tpu_torch.telemetry.cost` — per-tenant / per-workload
  device-time, wire-byte and cache-hit attribution;
* :mod:`fishnet_tpu_torch.telemetry.profiler` — the sampling profiler
  (``/profile``) and the stage-duration histograms;
* :mod:`fishnet_tpu_torch.telemetry.slo` — declarative SLOs as
  multi-window error-budget burn rates (a library).

The exported names, span stages and span fields follow
doc/observability.md, the JAX package's contract, so a dashboard or a
span consumer built for the JAX worker reads the port.

Hot-path discipline: telemetry is **disabled by default**. Span
instrumentation in the serving path is gated on :func:`enabled` (one
module-attribute read when off); metric *collection* is pull-only, so a
never-scraped process pays nothing beyond the always-on per-thread
counter cells the JAX package has too. :func:`enable` is flipped once
at startup by the ``--metrics-port`` wiring (``start_exporter``) or a
test, before traffic starts.
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
from fishnet_tpu_torch.telemetry.spans import (  # noqa: F401 - public API
    EVENT_STAGES,
    RECORDER,
    STAGES,
    SpanRecorder,
    install_signal_dump,
)
from fishnet_tpu_torch.telemetry.tracing import (  # noqa: F401 - public API
    TraceContext,
    batch_child,
    batch_root,
    links_for,
    new_trace,
    trace_id_for_batch,
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
    """The one-call opt-in: enable span recording, arm the SIGUSR2 dump
    (where the platform has it), and serve ``/metrics`` on ``port``
    (0 = ephemeral). ``FISHNET_PROFILE=1`` additionally arms the
    continuous profiling plane (sampling profiler + stage-duration
    histograms + cost attribution — telemetry/profiler.py, cost.py).
    Returns the :class:`MetricsExporter`."""
    from fishnet_tpu_torch.telemetry import cost as _cost
    from fishnet_tpu_torch.telemetry import profiler as _profiler
    from fishnet_tpu_torch.telemetry.exporter import MetricsExporter

    enable()
    install_signal_dump()
    if _profiler.maybe_start_from_env() is not None:
        _cost.enable()
    return MetricsExporter(port=port, host=host)
