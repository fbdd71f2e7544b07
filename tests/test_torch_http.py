"""The port's HTTP/1.1 client (``fishnet_tpu_torch.net.api.HttpSession``)
against small ``asyncio`` servers: chunked bodies, keep-alive reuse, a
server that closes after each answer, and the request timeout."""

import asyncio

import pytest

from fishnet_tpu_torch.net.api import HttpSession

pytestmark = pytest.mark.anyio


async def _serve(answer, hold=0.0):
    """A localhost server that reads one request at a time per
    connection and writes ``answer(n)`` for the n-th request of the
    whole server, after ``hold`` seconds; ``answer`` may return None to
    close the connection instead. Returns (server, url, accepted), where
    ``accepted`` counts connections."""
    accepted = [0]
    count = [0]

    async def handle(reader, writer):
        accepted[0] += 1
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                length = 0
                for line in head.decode("latin-1").split("\r\n"):
                    name, _, value = line.partition(":")
                    if name.lower() == "content-length":
                        length = int(value)
                await reader.readexactly(length)
                await asyncio.sleep(hold)
                data = answer(count[0])
                count[0] += 1
                if data is None:
                    break
                writer.write(data)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    return server, f"http://127.0.0.1:{port}/fishnet", accepted


def _ok(body: bytes, extra: str = "") -> bytes:
    return (f"HTTP/1.1 200 OK\r\nContent-Length: {len(body)}\r\n{extra}"
            "\r\n").encode() + body


async def test_chunked_body_is_joined_and_the_connection_kept():
    chunked = (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
               b"7\r\n{\"a\": 1\r\n3;ext=1\r\n, \"\r\n5\r\nb\": 2\r\n1\r\n}\r\n"
               b"0\r\nX-Trailer: t\r\n\r\n")
    server, url, accepted = await _serve(lambda n: chunked)
    session = HttpSession({}, timeout=5)
    async with server:
        first = await session.post(f"{url}/acquire", params={"slow": "false"},
                                   json_body={"x": 1})
        second = await session.get(f"{url}/status")
        session.close()
    assert first.status == 200 and first.json() == {"a": 1, "b": 2}
    assert second.json() == {"a": 1, "b": 2}
    assert accepted[0] == 1


@pytest.mark.parametrize("how", ["connection-close", "drops-idle"])
async def test_a_closed_connection_is_not_reused(how):
    """A server that says ``Connection: close``, or one that drops the
    connection after each answer without saying so: every request still
    succeeds, on a connection of its own."""
    if how == "connection-close":
        answer = lambda n: _ok(b'{"n": %d}' % n, "Connection: close\r\n")
    else:
        answer = lambda n: _ok(b'{"n": %d}' % n) if n % 2 == 0 else None
    server, url, accepted = await _serve(answer)
    session = HttpSession({}, timeout=5)
    got = []
    async with server:
        for _ in range(3):
            got.append((await session.get(f"{url}/status")).json()["n"])
        session.close()
    # A dropped connection costs its unanswered request (the odd n) and
    # one fresh connection.
    assert got == ([0, 1, 2] if how == "connection-close" else [0, 2, 4])
    assert accepted[0] == 3


async def test_the_request_timeout_cancels_and_closes():
    server, url, accepted = await _serve(lambda n: _ok(b"{}"), hold=2.0)
    session = HttpSession({}, timeout=0.2)
    async with server:
        with pytest.raises(asyncio.TimeoutError):
            await session.get(f"{url}/status")
        assert session._idle == {}
        session.close()
