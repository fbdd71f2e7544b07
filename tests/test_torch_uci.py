"""The port's UCI front end (python -m fishnet_tpu_torch uci --device cpu),
driven as a real subprocess over pipes: the handshake and mate-in-1
cases of tests/test_uci_server.py."""

import asyncio
import os
import sys

import pytest

pytestmark = pytest.mark.anyio


async def drive(commands, patterns, timeout=120):
    """Send commands; collect output until all patterns appear (in order)."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "fishnet_tpu_torch", "uci", "--device", "cpu",
        "--no-conf", "--no-stats-file", "--microbatch", "64",
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdin=asyncio.subprocess.PIPE,
        stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.DEVNULL,
    )
    try:
        proc.stdin.write(("\n".join(commands) + "\n").encode())
        await proc.stdin.drain()
        lines = []
        remaining = list(patterns)

        async def read():
            while remaining:
                raw = await proc.stdout.readline()
                if not raw:
                    break
                line = raw.decode().strip()
                lines.append(line)
                if remaining and remaining[0] in line:
                    remaining.pop(0)

        await asyncio.wait_for(read(), timeout)
        assert not remaining, f"missing {remaining!r} in output:\n" + "\n".join(lines)
        return lines
    finally:
        try:
            proc.stdin.write(b"quit\n")
            await proc.stdin.drain()
            await asyncio.wait_for(proc.wait(), 15)
        except Exception:  # noqa: BLE001
            try:
                proc.kill()
            except ProcessLookupError:
                pass


async def test_uci_handshake_and_mate():
    lines = await drive(
        [
            "uci",
            "isready",
            "position fen 6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1",
            "go depth 4",
        ],
        ["uciok", "readyok", "bestmove d1d8"],
    )
    assert any("id name fishnet-tpu-torch" in l for l in lines)
    assert any("score mate 1" in l for l in lines)


async def test_uci_position_moves_and_nodes():
    lines = await drive(
        [
            "uci",
            "position startpos moves e2e4 e7e5",
            "go nodes 300",
        ],
        ["uciok", "bestmove"],
    )
    infos = [l for l in lines if l.startswith("info depth")]
    assert infos and all("pv" in l for l in infos)
