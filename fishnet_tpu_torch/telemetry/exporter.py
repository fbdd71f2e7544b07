"""Exposition server: Prometheus text format plus a JSON snapshot on a
stdlib ``http.server`` thread — the port of
``fishnet_tpu/telemetry/exporter.py``.

Opt-in: nothing starts unless ``--metrics-port`` (or the ``MetricsPort``
ini key) is set, or a caller calls ``telemetry.start_exporter``. The
server thread is independent of the asyncio event loop and mutates no
state the serving path reads: scrapes are read-only, and the registry's
scrape lock serializes them against collector unregistration.

Endpoints:

* ``GET /metrics`` — Prometheus text exposition (version 0.0.4)
* ``GET /json``    — JSON snapshot of the same families
* ``GET /healthz`` — serving-state probe. With no registered health
  providers it is a bare liveness check (200 ``ok``). Serving
  subsystems register providers; the probe then returns a JSON state
  document with **503 while shedding, draining, or unhealthy**.
* ``GET /healthz/ready`` — alias for ``/healthz`` (the readiness half).
* ``GET /healthz/live`` — pure liveness: 200 ``ok`` as long as the
  process is up, even while draining or shedding.
* ``GET /spans``   — the span flight recorder's rings as JSON:
  ``{"pid", "monotonic_to_epoch", "spans"}`` (telemetry/spans.py), the
  JAX exporter's body.
* ``GET /profile`` — continuous-profiler snapshot (JSON: folded
  stacks, per-role sample counts, stage-duration quantiles, the
  sampler's own duty cycle). ``?format=collapsed`` returns the
  classic ``role;frame;...;frame count`` text for ``flamegraph.pl``
  or speedscope. 503 with a JSON hint while ``FISHNET_PROFILE`` is
  not armed (telemetry/profiler.py).
* ``GET /trace``   — the recorder's rings as a Chrome/Perfetto trace
  (telemetry/trace_export.py; load the body at https://ui.perfetto.dev).

Every route of the JAX exporter is served, with the JAX exporter's
bodies; ``extra_routes`` mounts more (the fleet aggregator's ``/fleet*``).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from fishnet_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry

#: Registered once per process (first exporter construction): uptime
#: and restarts read from this instead of from logs.
_PROC_START_TIME = time.time()

#: Routes of the JAX exporter whose modules the port lacks: path -> the
#: missing module (the 404 body names it). Empty: every route is served.
NOT_PORTED: Dict[str, str] = {}


def register_process_info(registry: Optional[MetricsRegistry] = None) -> None:
    """Register ``fishnet_build_info{version,abi,jax}`` (value always
    1; identity rides the labels) and ``fishnet_proc_start_time_seconds``
    on ``registry``. The label keys are the JAX package's: ``version``
    is the port's, ``abi`` the native core's C ABI, and ``jax`` is
    ``none`` (the port runs without jax). Idempotent, and called by
    every exporter at construction."""
    registry = registry if registry is not None else REGISTRY
    from fishnet_tpu_torch.chess.core import ABI_VERSION
    from fishnet_tpu_torch.version import __version__

    info = registry.gauge(
        "fishnet_build_info",
        "Build identity as labels (value is always 1): client version, "
        "native-core ABI, jax version.",
        labelnames=("version", "abi", "jax"),
    )
    info.set(1.0, version=__version__, abi=str(ABI_VERSION), jax="none")
    start = registry.gauge(
        "fishnet_proc_start_time_seconds",
        "Unix time this process's telemetry started; uptime = now - "
        "this, and a changed value at the same target means a restart.",
    )
    start.set(_PROC_START_TIME)


#: Health providers: name -> zero-arg callable returning a dict of
#: serving state (or None to self-unregister, the collector idiom).
#: A provider dict with ``healthy: False`` or ``shedding: True`` turns
#: the probe non-200.
_HEALTH_PROVIDERS: Dict[str, Callable[[], Optional[dict]]] = {}
_HEALTH_LOCK = threading.Lock()


def register_health_provider(
    name: str, fn: Callable[[], Optional[dict]]
) -> str:
    """Register (or replace) a named serving-state provider for
    /healthz. Returns the name (the unregister handle)."""
    with _HEALTH_LOCK:
        _HEALTH_PROVIDERS[name] = fn
    return name


def unregister_health_provider(name: str) -> None:
    with _HEALTH_LOCK:
        _HEALTH_PROVIDERS.pop(name, None)


def unregister_health_provider_if(
    name: str, fn: Callable[[], Optional[dict]]
) -> None:
    """Remove ``name`` only if it still maps to ``fn`` — lets an owner
    retire its own provider without clobbering a successor registered
    under the same name."""
    with _HEALTH_LOCK:
        if _HEALTH_PROVIDERS.get(name) is fn:
            _HEALTH_PROVIDERS.pop(name, None)


def health_snapshot() -> Tuple[int, Optional[dict]]:
    """(status_code, body) for /healthz; body None means the bare
    liveness ``ok`` (no providers registered)."""
    with _HEALTH_LOCK:
        providers = list(_HEALTH_PROVIDERS.items())
    stale = []
    states: Dict[str, dict] = {}
    for name, fn in providers:
        try:
            state = fn()
        except Exception:  # noqa: BLE001 - a broken probe must not 500
            state = {"healthy": False, "error": "provider raised"}
        if state is None:
            stale.append(name)
            continue
        states[name] = state
    if stale:
        with _HEALTH_LOCK:
            for name in stale:
                _HEALTH_PROVIDERS.pop(name, None)
    if not states:
        return 200, None
    unhealthy = any(
        s.get("healthy") is False or s.get("shedding") for s in states.values()
    )
    body = {
        "status": "degraded" if unhealthy else "ok",
        "providers": states,
    }
    return (503 if unhealthy else 200), body


class MetricsExporter:
    """Owns the HTTP server + its thread. ``port`` is the bound port
    (useful with port 0 = ephemeral). ``extra_routes`` maps a path to a
    zero-arg callable returning ``(status, content_type, body_bytes)``:
    the fleet aggregator mounts ``/fleet*`` through it."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[MetricsRegistry] = None,
        extra_routes: Optional[
            Dict[str, Callable[[], Tuple[int, str, bytes]]]
        ] = None,
    ) -> None:
        registry = registry if registry is not None else REGISTRY
        register_process_info(registry)
        self._registry = registry
        # Scrape guard: handler threads hold this lock across a scrape;
        # close() takes it to flip _closed, so after close() returns no
        # collector callback from THIS exporter can still be running
        # against a service being torn down, and any later request is
        # refused with a 503 instead of scraping.
        self._scrape_guard = threading.Lock()
        self._closed = False
        handler = _make_handler(registry, self, extra_routes or {})
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        with self._scrape_guard:  # waits out any in-flight scrape
            self._closed = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        # Also drain any scrape running through the registry from
        # another exporter or thread, so `exporter.close();
        # service.close()` never has a collector mid-run against the
        # dying service.
        self._registry.scrape_barrier()


def _make_handler(
    registry: MetricsRegistry,
    exporter: "MetricsExporter",
    extra_routes: Dict[str, Callable[[], Tuple[int, str, bytes]]],
):
    class _Handler(BaseHTTPRequestHandler):
        # Scrapers poll; access-logging them to stderr is pure noise.
        def log_message(self, fmt, *args):  # noqa: D401
            pass

        def _send(self, status: int, content_type: str, body: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _scrape(self, render: Callable[[], Tuple[str, bytes]]) -> None:
            """Run a collector-touching render under the exporter's
            scrape guard; refuse with 503 once close() has begun."""
            with exporter._scrape_guard:
                if exporter._closed:
                    self._send(503, "text/plain", b"closing\n")
                    return
                content_type, body = render()
            self._send(200, content_type, body)

        def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
            path, _, query = self.path.partition("?")
            try:
                if path == "/metrics":
                    self._scrape(lambda: (
                        "text/plain; version=0.0.4; charset=utf-8",
                        registry.render_prometheus().encode(),
                    ))
                elif path == "/json":
                    self._scrape(lambda: (
                        "application/json",
                        json.dumps(registry.render_json()).encode(),
                    ))
                elif path == "/spans":
                    import os as _os

                    from fishnet_tpu_torch.telemetry.spans import RECORDER

                    # pid + the monotonic->epoch anchor ride along so a
                    # fleet aggregator can key span archives per process
                    # incarnation and rebase every process's spans onto
                    # one wall clock before stitching.
                    body = json.dumps({
                        "pid": _os.getpid(),
                        "monotonic_to_epoch": round(
                            RECORDER.epoch_offset, 6
                        ),
                        "spans": RECORDER.spans(),
                    }).encode()
                    self._send(200, "application/json", body)
                elif path == "/profile":
                    from fishnet_tpu_torch.telemetry import (
                        profiler as _profiler,
                    )

                    status, content_type, body = (
                        _profiler.render_endpoint(query)
                    )
                    self._send(status, content_type, body)
                elif path in extra_routes:
                    status, content_type, body = extra_routes[path]()
                    self._send(status, content_type, body)
                elif path == "/trace":
                    from fishnet_tpu_torch.telemetry.spans import RECORDER
                    from fishnet_tpu_torch.telemetry.trace_export import (
                        chrome_trace,
                    )

                    body = json.dumps(chrome_trace(RECORDER.spans())).encode()
                    self._send(200, "application/json", body)
                elif path in NOT_PORTED:
                    self._send(404, "text/plain", (
                        f"{path}: not ported: fishnet_tpu_torch has no "
                        f"{NOT_PORTED[path]} yet\n").encode())
                elif path == "/healthz/live":
                    # Pure liveness: never 503s — draining/shedding is
                    # a readiness concern (/healthz, /healthz/ready).
                    self._send(200, "text/plain", b"ok\n")
                elif path in ("/healthz", "/healthz/ready"):
                    status, health = health_snapshot()
                    if health is None:
                        self._send(200, "text/plain", b"ok\n")
                    else:
                        self._send(
                            status, "application/json",
                            json.dumps(health).encode(),
                        )
                else:
                    self._send(404, "text/plain", b"not found\n")
            except BrokenPipeError:
                pass

    return _Handler
