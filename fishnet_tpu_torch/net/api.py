"""HTTP communication backend: the only server-facing I/O in the client.

The port's copy of ``fishnet_tpu/net/api.py``, on the standard library
instead of aiohttp. Behavioral equivalent of the reference's
ApiActor/ApiStub pair (src/api.rs:28-767): all server traffic is
serialized through one actor task so that error backoff applies
globally; requests carry bearer-key auth plus the legacy
``fishnet.apikey`` body field; 429 responses suspend all traffic for
60 s + jittered backoff; 400/401/403/406 on acquire mean the server
rejected this client and the queue must stop (doc/protocol.md:240-244).

Requests are HTTP/1.1 on ``asyncio`` streams (TLS for https) with
keep-alive: a request takes an idle connection to its host or opens
one, and gives it back after a complete response, so a steady client
pays no TCP or TLS handshake per request (the reference's pool,
api.rs:528). A request cut by the 30 s timeout closes its connection;
no thread is left behind. An acquire may be a long poll, so it runs in
a task of its own on a connection of its own, and submissions are not
queued behind it; every other request is handled in turn. The
future-based message passing mirrors the reference's mpsc/oneshot
channels.

Fault sites and accounting (resilience/): with a fault plan installed,
every acquire passes the ``net.acquire`` site and every analysis or
move submission the ``net.submit`` site before its request, and an
injected fault takes the same error path, backoff and retries as a
transport failure. With a batch ledger installed, the actor records a
batch as acquired when the server hands it out, as submitted only on
the server's 2xx to its final analysis or its move, and as abandoned on
a dropped acquire callback, a fenced 404, a rejected move, spent submit
retries and a submission still parked behind an open breaker at
shutdown; the stub aborts (and abandons) a job handed to a caller that
was cancelled before it took it.

Multi-tenant mode (sched/frontend.py): each tenant owns a stub/actor
pair of its own (``channel(tenant=)``), its breaker named
``submit:<tenant>``, and a ``ShedAwarePacer`` that slows its acquires
while the front end sheds (``fishnet_acquire_paced_total{tenant}``).

Spans (telemetry/spans.py), gated on ``telemetry.enabled()``: a
successful acquire records the batch trace's root, ``acquire``, under
the ids derived from the batch id (``tracing.batch_root``; an empty
acquire records it without a trace), and a completed analysis'
submission records ``submit`` as a child of that root.
"""

from __future__ import annotations

import asyncio
import json
import ssl
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple
from urllib.parse import urlencode, urlsplit

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.protocol.types import (
    Acquired,
    AcquiredKind,
    AcquireResponseBody,
    AnalysisPartJson,
    AnalysisStatus,
    EvalFlavor,
    ProtocolError,
    analysis_request_body,
    move_request_body,
    void_request_body,
)
from fishnet_tpu_torch.resilience import accounting as _accounting
from fishnet_tpu_torch.resilience import faults as _faults
from fishnet_tpu_torch.resilience.supervisor import CircuitBreaker
from fishnet_tpu_torch.telemetry import tracing as _tracing
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS
from fishnet_tpu_torch.utils.backoff import RandomizedBackoff
from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.version import PROTOCOL_VERSION, user_agent

REQUEST_TIMEOUT_SECONDS = 30.0  # api.rs:527
POOL_IDLE_TIMEOUT_SECONDS = 25.0  # api.rs:528

#: Transport attempts for a FINAL analysis submission (and for move
#: submissions) before the batch is abandoned to the server's timeout.
#: Progress reports are never retried — they are redundant by design.
MAX_SUBMIT_ATTEMPTS = 4

#: Submit circuit breaker: failures in a row that open it, and the
#: seconds it stays open before a probe.
BREAKER_THRESHOLD = 5
BREAKER_COOLDOWN_SECONDS = 30.0

# Server-traffic telemetry (doc/observability.md), the JAX package's
# families. Recorded unconditionally: one histogram observe + one
# counter inc per HTTP round trip is noise next to the request itself,
# and the instruments' per-thread cells take no shared lock.
# ``endpoint`` is the message kind (acquire / submit_analysis /
# submit_move / abort / status / check_key); ``outcome`` is ok /
# rate_limited / error.
_REQUEST_SECONDS = _telemetry.REGISTRY.histogram(
    "fishnet_api_request_seconds",
    "Server round-trip latency per endpoint.",
    labelnames=("endpoint",),
)
_REQUESTS = _telemetry.REGISTRY.counter(
    "fishnet_api_requests_total",
    "Completed server requests per endpoint and outcome.",
    labelnames=("endpoint", "outcome"),
)
_REJECTS = _telemetry.REGISTRY.counter(
    "fishnet_api_rejected_total",
    "Acquire-path rejections (HTTP 400/401/403/406): the server "
    "refused this client and the queue will stop.",
    labelnames=("endpoint", "status"),
)
_SUSPENSIONS = _telemetry.REGISTRY.counter(
    "fishnet_api_suspensions_total",
    "429 responses that suspended ALL server traffic.",
)
_SUSPENDED_SECONDS = _telemetry.REGISTRY.counter(
    "fishnet_api_suspended_seconds_total",
    "Cumulative seconds of 429-imposed traffic suspension.",
)
_STUB_ERRORS = _telemetry.REGISTRY.counter(
    "fishnet_api_stub_errors_total",
    "Stub-side calls resolved as errors and returned to the caller as "
    "None (the actor already counted the transport error itself).",
    labelnames=("endpoint",),
)
_SUBMIT_RETRIES = _telemetry.REGISTRY.counter(
    "fishnet_api_submit_retries_total",
    "Final-submission transport failures that were requeued for retry "
    "(exactly-once accounting, doc/resilience.md).",
)
_SUBMIT_DROPPED = _telemetry.REGISTRY.counter(
    "fishnet_api_submit_dropped_total",
    "Final submissions abandoned after exhausting retries (the server "
    "reassigns the batch by timeout).",
)
_PARKED = _telemetry.REGISTRY.gauge(
    "fishnet_api_parked_submissions",
    "Analysis submissions parked behind an open circuit breaker.",
)
_ACQUIRE_PACED = _telemetry.REGISTRY.counter(
    "fishnet_acquire_paced_total",
    "Acquire attempts slowed by shed-aware pacing (the front end is "
    "shedding; pulling more bulk work would only be aborted back).",
    labelnames=("tenant",),
)
_CONN_RESETS = _telemetry.REGISTRY.counter(
    "fishnet_api_conn_resets_total",
    "Requests that died to a connection-level failure (reset, refused, "
    "dropped mid-flight) rather than an HTTP error — the client-side "
    "signature of a network partition.",
    labelnames=("endpoint",),
)
#: The exceptions ``_CONN_RESETS`` counts: the stdlib transport's
#: connection-level failures and the request timeout.
_CONN_ERRORS = (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError)

#: Acquire-stream pause per pacing round while the shed policy is
#: active. Long enough to let the queue drain meaningfully, short
#: enough that latency-lane (move) jobs are still picked up promptly.
SHED_PACE_SECONDS = 0.25


class ShedAwarePacer:
    """Slows a tenant's acquire stream while load shedding is active.

    ``shed_active_fn`` probes the shared ShedPolicy
    (resilience/shedding.py); the pacer sleeps one quantum per call
    while it reports True. It deliberately slows rather than stops the
    stream: admission control still sheds bulk batches on arrival, but
    move jobs must keep flowing into the latency lane."""

    def __init__(
        self, shed_active_fn, tenant: str = "",
        pause_seconds: float = SHED_PACE_SECONDS,
    ) -> None:
        self._shed_active_fn = shed_active_fn
        self._tenant = tenant
        self._pause = pause_seconds

    async def pace(self) -> bool:
        """Sleep one quantum if shedding; True if a pause was taken."""
        if not self._shed_active_fn():
            return False
        _ACQUIRE_PACED.inc(tenant=self._tenant)
        await asyncio.sleep(self._pause)
        return True


# ---------------------------------------------------------------------------
# A minimal HTTP/1.1 client on asyncio streams
# ---------------------------------------------------------------------------


class HttpError(Exception):
    """A response with an error status that the caller did not expect."""

    def __init__(self, status: int, text: str) -> None:
        super().__init__(f"HTTP {status}: {text[:200]}")
        self.status = status


@dataclass
class HttpResponse:
    status: int
    body: bytes

    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.body)

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise HttpError(self.status, self.text())


class _StaleConnection(Exception):
    """A reused connection was closed by the server before it answered."""


Conn = Tuple[asyncio.StreamReader, asyncio.StreamWriter]


class HttpSession:
    """HTTP/1.1 client with fixed headers, a total timeout per request
    and a pool of idle keep-alive connections per (host, port, scheme).
    Concurrent requests each hold a connection of their own."""

    def __init__(self, headers: Dict[str, str], timeout: float) -> None:
        self.headers = headers
        self.timeout = timeout
        self._ssl: Optional[ssl.SSLContext] = None
        self._idle: Dict[tuple, List[Tuple[Conn, float]]] = {}

    async def get(self, url: str) -> HttpResponse:
        return await self.request("GET", url)

    async def post(self, url: str, params: Optional[Dict[str, str]] = None,
                   json_body=None) -> HttpResponse:
        return await self.request("POST", url, params, json_body)

    async def request(self, method: str, url: str,
                      params: Optional[Dict[str, str]] = None,
                      json_body=None) -> HttpResponse:
        return await asyncio.wait_for(
            self._exchange(method, url, params, json_body), self.timeout
        )

    def close(self) -> None:
        """Close every idle connection."""
        for conns in self._idle.values():
            for (_, writer), _ in conns:
                writer.close()
        self._idle.clear()

    def _take_idle(self, key: tuple) -> Optional[Conn]:
        conns = self._idle.get(key, [])
        while conns:
            (reader, writer), since = conns.pop()
            if (time.monotonic() - since < POOL_IDLE_TIMEOUT_SECONDS
                    and not reader.at_eof() and not writer.is_closing()):
                return reader, writer
            writer.close()
        return None

    async def _exchange(self, method, url, params, json_body) -> HttpResponse:
        parts = urlsplit(url)
        https = parts.scheme == "https"
        if https and self._ssl is None:
            self._ssl = ssl.create_default_context()
        host = parts.hostname or "localhost"
        port = parts.port or (443 if https else 80)
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        if params:
            target += ("&" if parts.query else "?") + urlencode(params)
        body = b"" if json_body is None else json.dumps(json_body).encode()
        lines = [f"{method} {target} HTTP/1.1", f"Host: {parts.netloc}"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        lines += ["Accept: application/json"]
        if method != "GET":
            lines += ["Content-Type: application/json",
                      f"Content-Length: {len(body)}"]
        request = ("\r\n".join(lines) + "\r\n\r\n").encode() + body
        key = (host, port, https)
        conn = self._take_idle(key)
        if conn is not None:
            try:
                return await self._send(key, conn, method, request, True)
            except _StaleConnection:
                pass  # the server dropped it while idle: send on a new one
        conn = await asyncio.open_connection(
            host, port, ssl=self._ssl if https else None,
            server_hostname=host if https else None,
        )
        return await self._send(key, conn, method, request, False)

    async def _send(self, key: tuple, conn: Conn, method: str, request: bytes,
                    reused: bool) -> HttpResponse:
        """One exchange on ``conn``; the connection goes back to the pool
        after a complete response that leaves it open, and is closed in
        every other case (an error, a timeout's cancellation)."""
        reader, writer = conn
        pooled = False
        try:
            try:
                writer.write(request)
                await writer.drain()
                status_line = (await reader.readline()).decode("latin-1")
            except (ConnectionResetError, BrokenPipeError):
                if reused:
                    raise _StaleConnection() from None
                raise
            if not status_line and reused:
                raise _StaleConnection()
            fields = status_line.split(None, 2)
            if len(fields) < 2 or not fields[0].startswith("HTTP/"):
                raise ConnectionError(f"malformed status line {status_line!r}")
            status = int(fields[1])
            headers: Dict[str, str] = {}
            while True:
                line = (await reader.readline()).decode("latin-1")
                if line in ("\r\n", "\n", ""):
                    break
                name, _, value = line.partition(":")
                headers[name.strip().lower()] = value.strip()
            keep = (fields[0] == "HTTP/1.1"
                    and "close" not in headers.get("connection", "").lower())
            if status in (204, 304) or 100 <= status < 200 or method == "HEAD":
                data = b""
            elif "chunked" in headers.get("transfer-encoding", "").lower():
                data = await _read_chunked(reader)
            elif "content-length" in headers:
                data = await reader.readexactly(int(headers["content-length"]))
            else:
                keep = False
                data = await reader.read()  # the server's close ends it
            if keep:
                self._idle.setdefault(key, []).append(
                    (conn, time.monotonic()))
                pooled = True
            return HttpResponse(status, data)
        finally:
            if not pooled:
                writer.close()


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    out = bytearray()
    while True:
        size_line = (await reader.readline()).decode("latin-1")
        size = int(size_line.split(";")[0].strip() or "0", 16)
        if size == 0:
            # Trailer headers, up to the blank line.
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            return bytes(out)
        out += await reader.readexactly(size)
        await reader.readexactly(2)  # the CRLF after each chunk


# ---------------------------------------------------------------------------
# Stub + actor
# ---------------------------------------------------------------------------


class KeyError_(Exception):
    """Key rejected by the server (access denied)."""


class RateLimited(Exception):
    """HTTP 429: suspend all requests (api.rs:550-556)."""


@dataclass
class _Message:
    kind: str
    future: Optional[asyncio.Future] = None
    batch_id: Optional[str] = None
    flavor: Optional[EvalFlavor] = None
    analysis: Optional[List[Optional[AnalysisPartJson]]] = None
    best_move: Optional[str] = None
    slow: bool = False
    #: True for a COMPLETED analysis (vs a progress report): final
    #: submissions are retried on transport failure; progress reports
    #: are fire-and-forget.
    final: bool = False
    attempts: int = 0


@dataclass
class ApiStub:
    """Cheap cloneable handle enqueueing messages to the actor."""

    _queue: "asyncio.Queue[_Message]"
    endpoint: str
    #: Tenant name in multi-tenant mode ("" = single-stream client).
    tenant: str = ""
    #: Optional ShedAwarePacer consulted by acquire loops before each
    #: acquire (sched/frontend.py installs one per tenant).
    pacer: Optional[ShedAwarePacer] = None

    async def pace_acquire(self) -> bool:
        """Shed-aware pacing hook; True if a pause was taken."""
        if self.pacer is None:
            return False
        return await self.pacer.pace()

    async def check_key(self) -> Optional[Exception]:
        """None if the key is accepted; the error otherwise."""
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(_Message("check_key", future=fut))
        try:
            await fut
            return None
        except Exception as err:  # noqa: BLE001 - propagate to caller as value
            return err

    async def status(self) -> Optional[AnalysisStatus]:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(_Message("status", future=fut))
        try:
            return await fut
        except Exception:  # noqa: BLE001
            _STUB_ERRORS.inc(endpoint="status")
            return None

    def abort(self, batch_id: str) -> None:
        self._queue.put_nowait(_Message("abort", batch_id=batch_id))

    async def acquire(self, slow: bool) -> Optional[Acquired]:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(_Message("acquire", future=fut, slow=slow))
        try:
            return await fut
        except asyncio.CancelledError:
            self._give_back(fut)
            raise
        except Exception:  # noqa: BLE001
            _STUB_ERRORS.inc(endpoint="acquire")
            return None

    def _give_back(self, fut: asyncio.Future) -> None:
        """The caller was cancelled after the actor had handed it a job
        (its future holds the answer, so the actor aborted nothing): the
        job goes back to the server, abandoned through the ledger, or
        the server would hold it until its timeout. The JAX package's
        stub drops it."""
        if fut.cancelled() or not fut.done() or fut.exception() is not None:
            return
        acquired = fut.result()
        if acquired is None or acquired.kind is not AcquiredKind.ACCEPTED:
            return
        led = _accounting.get()
        if led is not None:
            led.record_abandoned(acquired.body.work.id, "shutdown_cancelled")
        self.abort(acquired.body.work.id)

    def submit_analysis(
        self,
        batch_id: str,
        flavor: EvalFlavor,
        analysis: List[Optional[AnalysisPartJson]],
        final: bool = False,
    ) -> None:
        """``final``: a completed analysis (not a progress report) —
        retried on transport failure."""
        self._queue.put_nowait(
            _Message(
                "submit_analysis", batch_id=batch_id, flavor=flavor,
                analysis=analysis, final=final,
            )
        )

    async def submit_move_and_acquire(
        self, batch_id: str, best_move: Optional[str]
    ) -> Optional[Acquired]:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(
            _Message("submit_move", future=fut, batch_id=batch_id, best_move=best_move)
        )
        try:
            return await fut
        except asyncio.CancelledError:
            self._give_back(fut)
            raise
        except Exception:  # noqa: BLE001
            _STUB_ERRORS.inc(endpoint="submit_move")
            return None


class ApiActor:
    def __init__(
        self,
        queue: "asyncio.Queue[_Message]",
        endpoint: str,
        key: Optional[str],
        logger: Logger,
        tenant: str = "",
    ) -> None:
        self.queue = queue
        self.endpoint = endpoint.rstrip("/")
        self.key = key
        self.logger = logger
        self.tenant = tenant
        self.error_backoff = RandomizedBackoff()
        self._session: Optional[HttpSession] = None
        self._stopped = False
        #: Loop time before which no new request starts: the error (and
        #: 429) backoff, global over every request as in the reference.
        self._resume_at = 0.0
        self._acquires: Set[asyncio.Task] = set()
        # Submit-endpoint circuit breaker: repeated analysis-submission
        # failures open it and park further submissions instead of
        # burning a 30 s timeout + error backoff on each; a cooldown
        # later, one probe goes through and a success drains the parked
        # work. Move submissions are exempt: they are latency-critical
        # and carry a chained acquire.
        self.breaker = CircuitBreaker(
            failure_threshold=BREAKER_THRESHOLD,
            cooldown_seconds=BREAKER_COOLDOWN_SECONDS,
            name=f"submit:{tenant}" if tenant else "submit",
        )
        self._parked: List[_Message] = []
        self._breaker_wake: Optional[asyncio.TimerHandle] = None

    def _make_session(self) -> HttpSession:
        headers = {"User-Agent": user_agent()}
        if self.key:
            headers["Authorization"] = f"Bearer {self.key}"
        return HttpSession(headers, REQUEST_TIMEOUT_SECONDS)

    def stop(self) -> None:
        self._stopped = True
        self.queue.put_nowait(_Message("stop"))

    async def run(self) -> None:
        self.logger.debug("Api actor started")
        self._session = self._make_session()
        try:
            while True:
                msg = await self.queue.get()
                if msg.kind == "stop":
                    break
                await self._hold_off()
                if msg.kind == "acquire":
                    # Possibly a long poll: in a task of its own, so the
                    # submissions behind it go out meanwhile.
                    task = asyncio.create_task(self._handle(msg))
                    self._acquires.add(task)
                    task.add_done_callback(self._acquires.discard)
                else:
                    await self._handle(msg)
                if self._stopped and self.queue.empty():
                    break
            # An acquire still in flight at a stop is finished, as it
            # would have been had it been handled in turn.
            if self._acquires:
                await asyncio.gather(*self._acquires)
        except asyncio.CancelledError:
            for task in list(self._acquires):
                task.cancel()
            raise
        finally:
            self._session.close()
            if self._breaker_wake is not None:
                self._breaker_wake.cancel()
                self._breaker_wake = None
            if self._parked:
                # Submissions still parked behind an open breaker at
                # shutdown: abandoned (the server reassigns by timeout)
                # rather than risking a hung exit on a dead endpoint.
                _SUBMIT_DROPPED.inc(len(self._parked))
                led = _accounting.get()
                if led is not None:
                    for parked in self._parked:
                        if parked.final and parked.batch_id:
                            led.record_abandoned(parked.batch_id,
                                                 "breaker_open")
                self.logger.error(
                    f"Dropped {len(self._parked)} parked submission(s) at "
                    "shutdown (circuit breaker open)."
                )
                self._parked.clear()
                _PARKED.set(0)
            self.logger.debug("Api actor exited")

    async def _hold_off(self) -> None:
        delay = self._resume_at - asyncio.get_running_loop().time()
        if delay > 0:
            await asyncio.sleep(delay)

    def _back_off(self, seconds: float) -> None:
        now = asyncio.get_running_loop().time()
        self._resume_at = max(self._resume_at, now + seconds)

    # -- circuit breaker plumbing -----------------------------------------

    def _park(self, msg: _Message) -> None:
        self._parked.append(msg)
        _PARKED.set(len(self._parked))
        self._schedule_breaker_wake()

    def _drain_parked(self) -> None:
        for parked in self._parked:
            self.queue.put_nowait(parked)
        self._parked.clear()
        _PARKED.set(0)

    def _schedule_breaker_wake(self) -> None:
        """Arm a one-shot wake that re-enqueues one parked submission
        once the cooldown elapses — the probe that can close the
        breaker even when no fresh traffic arrives."""
        if self._breaker_wake is not None or not self._parked:
            return
        delay = max(0.05, self.breaker.remaining_cooldown())
        loop = asyncio.get_running_loop()
        self._breaker_wake = loop.call_later(delay, self._wake_parked)

    def _wake_parked(self) -> None:
        self._breaker_wake = None
        if self._stopped or not self._parked:
            return
        probe = self._parked.pop(0)
        _PARKED.set(len(self._parked))
        self.queue.put_nowait(probe)

    def _submit_retryable(self, msg: _Message) -> bool:
        """Messages whose loss would lose work: completed analyses and
        move submissions. Progress reports are never retried."""
        return (msg.kind == "submit_analysis" and msg.final) or (
            msg.kind == "submit_move"
        )

    def _retry_or_drop(self, msg: _Message, err: Optional[Exception]) -> bool:
        """Requeue a failed retryable submission (True) or drop it
        (False). Caller resolves the future only on drop."""
        if msg.attempts + 1 < MAX_SUBMIT_ATTEMPTS:
            msg.attempts += 1
            _SUBMIT_RETRIES.inc()
            self.queue.put_nowait(msg)
            return True
        _SUBMIT_DROPPED.inc()
        led = _accounting.get()
        if led is not None and msg.batch_id:
            led.record_abandoned(msg.batch_id, "submit_failed")
        self.logger.error(
            f"Dropping {msg.kind} for {msg.batch_id} after "
            f"{MAX_SUBMIT_ATTEMPTS} attempts ({err!r})."
        )
        return False

    async def _handle(self, msg: _Message) -> None:
        if msg.kind == "submit_analysis" and not self.breaker.allow():
            # Breaker open: park instead of burning a request timeout
            # plus error backoff against a server that is refusing
            # submissions. The cooldown wake re-enqueues a probe.
            self._park(msg)
            return
        started = time.monotonic()
        try:
            await self._handle_inner(msg)
            _REQUEST_SECONDS.observe(time.monotonic() - started, endpoint=msg.kind)
            _REQUESTS.inc(endpoint=msg.kind, outcome="ok")
            if msg.kind == "acquire" and _telemetry.enabled():
                # Batch-trace ROOT: _parse_acquired stashed the batch id
                # on the message, and batch_root derives deterministic
                # ids from it — so schedule (sched/queue.py) and the
                # final submit below parent into the same tree with no
                # shared registry. An empty acquire stays traceless.
                if msg.batch_id:
                    _SPANS.record(
                        "acquire", started,
                        trace=_tracing.batch_root(msg.batch_id),
                        batch=msg.batch_id,
                    )
                else:
                    _SPANS.record("acquire", started)
            if (
                msg.kind == "submit_analysis"
                and msg.final
                and msg.batch_id
                and _telemetry.enabled()
            ):
                # The batch trace's terminal span: the completed
                # analysis' submission round-trip, child of the
                # deterministic acquire root.
                _SPANS.record(
                    "submit", started,
                    trace=_tracing.batch_child(msg.batch_id),
                    batch=msg.batch_id,
                )
            if msg.kind == "submit_analysis" and self.breaker.record_success():
                self.logger.info("Submit circuit breaker closed; draining.")
                self._drain_parked()
            self.error_backoff.reset()
        except asyncio.CancelledError:
            # Cancelled with the actor: the caller hears of it as a
            # transport error, not as its own cancellation.
            if msg.future and not msg.future.done():
                msg.future.set_exception(ConnectionError("api actor stopped"))
            raise
        except RateLimited:
            _REQUEST_SECONDS.observe(time.monotonic() - started, endpoint=msg.kind)
            _REQUESTS.inc(endpoint=msg.kind, outcome="rate_limited")
            backoff = 60.0 + self.error_backoff.next()
            _SUSPENSIONS.inc()
            _SUSPENDED_SECONDS.inc(backoff)
            self.logger.error(
                f"Too many requests. Suspending requests for {backoff:.1f}s."
            )
            # A rate-limited FINAL submission is requeued (not counted
            # as a breaker failure: 429 is load shedding, not an
            # outage) so the batch is not lost to the suspension.
            retried = self._submit_retryable(msg) and self._retry_or_drop(
                msg, None
            )
            if not retried and msg.future and not msg.future.done():
                msg.future.set_exception(RateLimited())
            self._back_off(backoff)
        except Exception as err:  # noqa: BLE001 - any transport/protocol error
            _REQUEST_SECONDS.observe(time.monotonic() - started, endpoint=msg.kind)
            _REQUESTS.inc(endpoint=msg.kind, outcome="error")
            if isinstance(err, _CONN_ERRORS):
                _CONN_RESETS.inc(endpoint=msg.kind)
            if msg.kind == "submit_analysis" and self.breaker.record_failure():
                self.logger.error(
                    "Submit circuit breaker OPEN: parking submissions for "
                    f"{self.breaker.cooldown_seconds:.0f}s."
                )
            backoff = self.error_backoff.next()
            self.logger.error(f"{err!r}. Backing off {backoff:.1f}s.")
            retried = self._submit_retryable(msg) and self._retry_or_drop(
                msg, err
            )
            if not retried and msg.future and not msg.future.done():
                msg.future.set_exception(err)
            self._back_off(backoff)

    async def _abort(self, batch_id: str) -> None:
        self.logger.warn(f"Aborting batch {batch_id}.")
        res = await self._session.post(
            f"{self.endpoint}/abort/{batch_id}",
            json_body=void_request_body(PROTOCOL_VERSION, self.key),
        )
        if res.status == 404:
            self.logger.warn(
                f"Fishnet server does not support abort (404 for {batch_id})."
            )
            return
        res.raise_for_status()

    async def _parse_acquired(self, res: HttpResponse, msg: _Message) -> None:
        """Shared 202/204/reject handling for acquire and move-submit."""
        if res.status == 204:
            self._fulfil(msg, Acquired.no_content())
        elif res.status in (400, 401, 403, 406):
            _REJECTS.inc(endpoint=msg.kind, status=str(res.status))
            self.logger.error(f"Server rejected request: {res.text()}")
            self._fulfil(msg, Acquired.rejected())
        elif res.status in (200, 202):
            try:
                body = AcquireResponseBody.from_json(res.json())
            except (ProtocolError, ValueError) as err:
                self.logger.error(f"Invalid acquire response: {err}")
                self._fulfil(msg, Acquired.no_content())
                return
            led = _accounting.get()
            if led is not None:
                led.record_acquired(body.work.id)
            if msg.kind == "acquire":
                # Feed the acquire span's batch trace root (_handle):
                # move submissions keep THEIR batch id — the chained
                # acquire's new batch must not clobber retry accounting.
                msg.batch_id = body.work.id
            if not self._fulfil(msg, Acquired.accepted(body)):
                # Nobody is waiting for this job anymore: abort so the
                # server can reassign immediately (api.rs:678-684).
                self.logger.error("Acquired a batch, but callback dropped. Aborting.")
                if led is not None:
                    led.record_abandoned(body.work.id, "callback_dropped")
                await self._abort(body.work.id)
        else:
            self.logger.warn(f"Unexpected status for acquire: {res.status}")
            res.raise_for_status()

    def _fulfil(self, msg: _Message, value: object) -> bool:
        if msg.future is not None and not msg.future.done():
            msg.future.set_result(value)
            return True
        return False

    async def _handle_inner(self, msg: _Message) -> None:
        assert self._session is not None
        if _faults.enabled():
            # Named injection sites: faults raised here flow through
            # _handle's real error/backoff machinery, exactly like a
            # transport failure would.
            if msg.kind == "acquire":
                await _faults.fire_async("net.acquire")
            elif msg.kind in ("submit_analysis", "submit_move"):
                await _faults.fire_async("net.submit")
        if msg.kind == "check_key":
            res = await self._session.get(f"{self.endpoint}/key")
            if res.status in (200, 204):
                self._fulfil(msg, None)
            elif res.status in (401, 403):
                if msg.future and not msg.future.done():
                    msg.future.set_exception(KeyError_("access denied"))
            elif res.status == 404:
                await self._check_key_legacy(msg)
            elif res.status == 429:
                raise RateLimited()
            else:
                self.logger.warn(f"Unexpected status while checking key: {res.status}")
                res.raise_for_status()
        elif msg.kind == "status":
            res = await self._session.get(f"{self.endpoint}/status")
            if res.status == 200:
                self._fulfil(msg, AnalysisStatus.from_json(res.json()))
            elif res.status == 404:
                # Queue monitoring not supported (e.g. lila-fishnet).
                self._fulfil(msg, None)
            elif res.status == 429:
                raise RateLimited()
            else:
                self.logger.warn(f"Unexpected status for queue status: {res.status}")
                res.raise_for_status()
        elif msg.kind == "abort":
            await self._abort(msg.batch_id)
        elif msg.kind == "acquire":
            res = await self._session.post(
                f"{self.endpoint}/acquire",
                params={"slow": "true" if msg.slow else "false"},
                json_body=void_request_body(PROTOCOL_VERSION, self.key),
            )
            if res.status == 429:
                raise RateLimited()
            await self._parse_acquired(res, msg)
        elif msg.kind == "submit_analysis":
            res = await self._session.post(
                f"{self.endpoint}/analysis/{msg.batch_id}",
                params={"stop": "true", "slow": "false"},
                json_body=analysis_request_body(
                    PROTOCOL_VERSION, self.key, msg.flavor, msg.analysis
                ),
            )
            if res.status == 429:
                raise RateLimited()
            if res.status == 404:
                # Fenced: the server no longer recognizes this work — it
                # was reassigned while we were slow, or another process
                # completed it. Retrying can only duplicate work.
                _REJECTS.inc(endpoint="submit_analysis", status="404")
                self.logger.warn(
                    f"Work {msg.batch_id} no longer ours (404); "
                    "dropping submission."
                )
                if msg.final:
                    led = _accounting.get()
                    if led is not None:
                        led.record_abandoned(msg.batch_id, "fenced")
                return
            res.raise_for_status()
            if res.status != 204:
                self.logger.warn(
                    f"Unexpected status for submitting analysis: {res.status}"
                )
            if msg.final:
                led = _accounting.get()
                if led is not None:
                    led.record_submitted(msg.batch_id)
        elif msg.kind == "submit_move":
            res = await self._session.post(
                f"{self.endpoint}/move/{msg.batch_id}",
                json_body=move_request_body(
                    PROTOCOL_VERSION, self.key, msg.best_move
                ),
            )
            if res.status == 429:
                raise RateLimited()
            if res.status == 404:
                # Fenced move (see submit_analysis): drop it and let the
                # normal acquire loop fetch fresh work.
                _REJECTS.inc(endpoint="submit_move", status="404")
                self.logger.warn(
                    f"Work {msg.batch_id} no longer ours (404); dropping move."
                )
                led = _accounting.get()
                if led is not None:
                    led.record_abandoned(msg.batch_id, "fenced")
                self._fulfil(msg, Acquired.no_content())
                return
            rejected = res.status in (400, 401, 403, 406)
            await self._parse_acquired(res, msg)
            led = _accounting.get()
            if led is not None:
                if rejected:
                    led.record_abandoned(msg.batch_id, "rejected")
                else:
                    led.record_submitted(msg.batch_id)
        else:
            raise AssertionError(f"unknown message kind {msg.kind}")

    async def _check_key_legacy(self, msg: _Message) -> None:
        self.logger.debug("Falling back to legacy key validation")
        res = await self._session.get(f"{self.endpoint}/key/{self.key or ''}")
        if res.status == 200:
            self._fulfil(msg, None)
        elif res.status == 404:
            if msg.future and not msg.future.done():
                msg.future.set_exception(KeyError_("access denied"))
        else:
            self.logger.warn(
                f"Unexpected status while checking legacy key: {res.status}"
            )
            res.raise_for_status()


def channel(
    endpoint: str, key: Optional[str], logger: Logger, tenant: str = ""
) -> tuple:
    """Create a connected (ApiStub, ApiActor) pair. ``tenant`` names
    the owning acquire stream in multi-tenant mode (sched/frontend.py);
    each tenant gets its own actor so error backoff, the submit
    breaker, and 429 suspensions stay per-stream."""
    queue: "asyncio.Queue[_Message]" = asyncio.Queue()
    stub = ApiStub(_queue=queue, endpoint=endpoint.rstrip("/"), tenant=tenant)
    actor = ApiActor(queue, endpoint, key, logger, tenant=tenant)
    return stub, actor
