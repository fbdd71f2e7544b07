"""Chaos proxy: an HTTP forwarder between one client process and the
server that injects network faults from a fault plan.

The port of ``fishnet_tpu/cluster/proxy.py`` on ``asyncio`` streams (the
JAX one is aiohttp). One :class:`ChaosProxy` fronts one client process
(the fleet supervisor gives every process its own proxy and its own
plan), so partitions are per link, the way real networks fail. The
proxy polls three sites once per forwarded request, in this order:

* ``proxy.partition``: action ``latency=S`` opens an S-second window
  during which EVERY request is dropped with a connection reset (no
  HTTP response; the client takes its transport-error backoff path);
  action ``error`` drops just the matched request. Window opens
  increment ``fishnet_fleet_partitions_total{proxy}``.
* ``proxy.error5xx``: answer 502 without reaching the server (an LB or
  gateway failing, as opposed to the link dying).
* ``proxy.latency``: action ``latency=S`` delays the matched request S
  seconds, then forwards it.

The proxy is pure HTTP/1.1 plumbing: it never parses or rewrites a
body, so client/server protocol behaviour through a quiet proxy is the
direct behaviour. A client connection is kept alive across requests
(the port's client pools its connections, net/api.py), and each client
connection forwards over one upstream connection of its own, reopened
when the server has closed it.
"""

from __future__ import annotations

import asyncio
import time
from http import HTTPStatus
from typing import Dict, Optional, Tuple
from urllib.parse import urlsplit

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.resilience.faults import FaultPlan

_PARTITIONS = _telemetry.REGISTRY.counter(
    "fishnet_fleet_partitions_total",
    "Network partition windows opened by the chaos proxy, per proxy.",
    labelnames=("proxy",),
)

#: Request headers the proxy must not blindly copy: Host names the
#: proxy, and the framing headers are recomputed for the new request.
_HOP_HEADERS = ("host", "content-length", "transfer-encoding", "connection")

#: Longest request or status line, and most header lines, accepted.
_MAX_LINE = 1 << 16
_MAX_HEADERS = 100

Conn = Tuple[asyncio.StreamReader, asyncio.StreamWriter]


class _Upstream(Exception):
    """The server could not be reached or broke off its answer."""


async def _read_head(reader: asyncio.StreamReader):
    """``(start line, [(name, value)])`` of one message, or None at a
    clean end of stream before its first byte."""
    line = await reader.readline()
    if not line:
        return None
    if len(line) > _MAX_LINE or not line.endswith(b"\n"):
        raise ValueError("malformed start line")
    headers = []
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n"):
            break
        if not raw or len(headers) >= _MAX_HEADERS:
            raise ValueError("malformed header block")
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep:
            raise ValueError("malformed header line")
        headers.append((name.strip(), value.strip()))
    return line.decode("latin-1").rstrip("\r\n"), headers


async def _read_body(reader: asyncio.StreamReader, headers,
                     to_eof: bool) -> bytes:
    """The message body by its framing: chunked, Content-Length, or (a
    response without either, ``to_eof``) up to the peer's close."""
    fields = {k.lower(): v for k, v in headers}
    if "chunked" in fields.get("transfer-encoding", "").lower():
        out = bytearray()
        while True:
            size = int((await reader.readline()).split(b";")[0].strip()
                       or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass
                return bytes(out)
            out += await reader.readexactly(size)
            await reader.readexactly(2)
    if "content-length" in fields:
        return await reader.readexactly(int(fields["content-length"]))
    return await reader.read() if to_eof else b""


def _response(status: int, body: bytes, content_type: Optional[str],
              keep: bool) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}".rstrip()]
    if content_type is not None:
        lines.append(f"Content-Type: {content_type}")
    lines.append(f"Content-Length: {len(body)}")
    lines.append("Connection: " + ("keep-alive" if keep else "close"))
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


class ChaosProxy:
    """Forward ``http://127.0.0.1:<port><path>`` to ``upstream``,
    injecting faults per ``plan`` (None = a quiet, faithful proxy).

    ``upstream`` is the full endpoint the client would otherwise use
    (e.g. ``http://127.0.0.1:43210/fishnet``); :attr:`endpoint` is the
    same path on the proxy's own ephemeral port, ready to hand to the
    client's ``--endpoint``.
    """

    def __init__(
        self,
        upstream: str,
        plan: Optional[FaultPlan] = None,
        name: str = "proxy",
    ) -> None:
        parts = urlsplit(upstream)
        if parts.scheme not in ("http",) or not parts.netloc:
            raise ValueError(f"chaos proxy needs an http upstream: {upstream!r}")
        self._netloc = parts.netloc
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self._path = parts.path.rstrip("/")
        self.name = name
        self.plan = plan
        self.port = 0
        self._partition_until = 0.0
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: Dict[asyncio.StreamWriter, None] = {}
        # Per-proxy tallies for reports (the counter above is fleet-wide).
        self.forwarded = 0
        self.dropped = 0
        self.injected_5xx = 0
        self.delayed = 0
        self.partitions = 0

    @property
    def endpoint(self) -> str:
        """The endpoint to hand to the client (proxy port, same path)."""
        return f"http://127.0.0.1:{self.port}{self._path}"

    async def start(self) -> "ChaosProxy":
        self._server = await asyncio.start_server(
            self._serve_connection, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # Kept-alive client connections would hold wait_closed().
            for writer in list(self._writers):
                writer.transport.abort()
            await self._server.wait_closed()
            self._server = None

    def stats(self):
        return {
            "forwarded": self.forwarded,
            "dropped": self.dropped,
            "injected_5xx": self.injected_5xx,
            "delayed": self.delayed,
            "partitions": self.partitions,
        }

    async def _decide(self) -> str:
        """Poll the plan for one request: ``drop``, ``502`` or
        ``forward`` (after any injected delay)."""
        now = time.monotonic()
        if now < self._partition_until:
            return "drop"
        plan = self.plan
        if plan is None:
            return "forward"
        rule = plan.poll("proxy.partition")
        if rule is not None:
            if rule.action == "latency" and rule.arg > 0:
                self._partition_until = now + rule.arg
            self.partitions += 1
            _PARTITIONS.inc(proxy=self.name)
            return "drop"
        if plan.poll("proxy.error5xx") is not None:
            self.injected_5xx += 1
            return "502"
        rule = plan.poll("proxy.latency")
        if rule is not None and rule.arg > 0:
            self.delayed += 1
            await asyncio.sleep(rule.arg)
        return "forward"

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        self._writers[writer] = None
        upstream: Optional[Conn] = None
        try:
            while True:
                try:
                    head = await _read_head(reader)
                    if head is None:
                        return
                    request_line, headers = head
                    body = await _read_body(reader, headers, to_eof=False)
                except (ValueError, asyncio.IncompleteReadError,
                        ConnectionError):
                    return
                method, _, rest = request_line.partition(" ")
                target = rest.rsplit(" ", 1)[0]
                version = rest.rsplit(" ", 1)[-1]
                keep = version == "HTTP/1.1" and not any(
                    k.lower() == "connection" and "close" in v.lower()
                    for k, v in headers)
                decision = await self._decide()
                if decision == "drop":
                    # Connection reset under the in-flight request: the
                    # client sees the link die, not an HTTP status.
                    self.dropped += 1
                    writer.transport.abort()
                    return
                if decision == "502":
                    writer.write(_response(
                        502, b"chaos proxy: injected 502\n",
                        "text/plain; charset=utf-8", keep))
                else:
                    try:
                        status, ctype, payload, upstream = await self._forward(
                            upstream, method, target, headers, body)
                        self.forwarded += 1
                    except _Upstream:
                        # The server itself is down or unreachable: a 502,
                        # so the client backs off as it would behind a
                        # real gateway.
                        upstream = None
                        status, ctype, payload = (
                            502, "text/plain; charset=utf-8",
                            b"chaos proxy: upstream error\n")
                    writer.write(_response(status, payload, ctype, keep))
                await writer.drain()
                if not keep:
                    return
        except ConnectionError:
            return
        finally:
            self._writers.pop(writer, None)
            if upstream is not None:
                upstream[1].close()
            if not writer.is_closing():
                writer.close()

    async def _forward(self, upstream: Optional[Conn], method: str,
                       target: str, headers, body: bytes):
        """One exchange with the server, on ``upstream`` when it is
        still open (once more on a fresh connection if the server had
        closed it). Returns ``(status, content type, body, connection
        to keep or None)``."""
        lines = [f"{method} {target} HTTP/1.1", f"Host: {self._netloc}"]
        lines += [f"{k}: {v}" for k, v in headers
                  if k.lower() not in _HOP_HEADERS]
        if body or method not in ("GET", "HEAD"):
            lines.append(f"Content-Length: {len(body)}")
        lines.append("Connection: keep-alive")
        request = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
        for attempt in (0, 1):
            reused = upstream is not None
            try:
                if upstream is None:
                    upstream = await asyncio.open_connection(
                        self._host, self._port)
                up_reader, up_writer = upstream
                up_writer.write(request)
                await up_writer.drain()
                head = await _read_head(up_reader)
                if head is None:
                    raise ConnectionResetError("server closed the connection")
                status_line, out_headers = head
                status = int(status_line.split(None, 2)[1])
                keep_up = not any(
                    k.lower() == "connection" and "close" in v.lower()
                    for k, v in out_headers)
                if status in (204, 304) or method == "HEAD":
                    payload = b""
                else:
                    payload = await _read_body(up_reader, out_headers,
                                               to_eof=True)
                    keep_up = keep_up and any(
                        k.lower() in ("content-length", "transfer-encoding")
                        for k, _ in out_headers)
                ctype = next((v for k, v in out_headers
                              if k.lower() == "content-type"), None)
                if not keep_up:
                    up_writer.close()
                    upstream = None
                return status, ctype, payload, upstream
            except (OSError, ValueError, IndexError,
                    asyncio.IncompleteReadError) as err:
                if upstream is not None:
                    upstream[1].close()
                upstream = None
                if not (reused and attempt == 0):
                    raise _Upstream(str(err)) from err
        raise _Upstream("unreachable")  # pragma: no cover
