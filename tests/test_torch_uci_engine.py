"""The port's UCI subprocess engine driver (``fishnet_tpu_torch/engine/
uci.py``) against the scripted fake engine (``tests/fake_uci_engine.py``):
the ten tests of ``tests/test_uci_engine.py`` on the port, with the
client end to end on the standard-library fake lichess of
``chip_smoke.py``; the info-line parser and the submitted analyses held
to the JAX package's; ``run --engine uci`` without ``--engine-exe``;
the child's process group gone after a stop; and the port's own ``uci``
command driven as the engine through a wrapper script, on the CPU."""

import asyncio
import os
import signal
import sys
from pathlib import Path

import pytest

from chip_smoke import VALID_KEY, FakeServer
from fishnet_tpu.client import Client as JaxClient
from fishnet_tpu.engine import uci as jax_uci
from fishnet_tpu.utils.logger import Logger as JaxLogger
from fishnet_tpu_torch.chess import Board
from fishnet_tpu_torch.chess.core import load as load_core
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.engine.base import EngineError
from fishnet_tpu_torch.engine.uci import (
    UciEngine,
    UciEngineFactory,
    _parse_info_line,
)
from fishnet_tpu_torch.ipc import Position
from fishnet_tpu_torch.protocol.types import (
    STARTPOS,
    Clock,
    EngineFlavor,
    NodeLimit,
    Score,
    SkillLevel,
    Variant,
    Work,
)
from fishnet_tpu_torch.utils.logger import Logger

pytestmark = pytest.mark.anyio

ROOT = Path(__file__).resolve().parent.parent
FAKE = os.path.join(os.path.dirname(__file__), "fake_uci_engine.py")


@pytest.fixture(autouse=True, scope="module")
def native_core():
    """The queue's legality replay runs on the native core, compiled at
    its first use: build it before any timed wait starts."""
    load_core()


def fake_engine(flavor=EngineFlavor.OFFICIAL):
    return UciEngine(sys.executable, flavor, args=[FAKE])


def analysis_work(multipv=None, depth=None, nodes=1_500_000):
    return Work(
        kind="analysis",
        id="testbatch01",
        nodes=NodeLimit(classical=4_050_000, sf15=nodes),
        depth=depth,
        multipv=multipv,
        timeout_ms=7000,
    )


def analysis_position(work=None, moves=()):
    return Position(
        work=work or analysis_work(),
        position_id=0,
        flavor=EngineFlavor.OFFICIAL,
        variant=Variant.STANDARD,
        root_fen=STARTPOS,
        moves=list(moves),
    )


async def wait_for(predicate, timeout=10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if predicate():
            return True
        await asyncio.sleep(0.02)
    return False


# -- the ten tests of tests/test_uci_engine.py, on the port ------------------


async def test_analysis_search(monkeypatch):
    monkeypatch.delenv("FAKE_UCI_DIE_ON_GO", raising=False)
    engine = fake_engine()
    try:
        response = await engine.go(analysis_position(moves=["e2e4", "e7e5"]))
    finally:
        await engine.close()
    assert response.best_move == "e2e4"
    assert response.depth == 3
    # The final (upperbound) info line still updates node/time counters,
    # even though its score is not recorded.
    assert response.nodes == 4000
    assert response.nps == 500000
    assert response.scores.best() == Score.cp(30)
    assert response.pvs.best() == ["e2e4", "e7e5"]
    assert response.scores.best() != Score.cp(99)


async def test_multipv_matrix():
    engine = fake_engine()
    try:
        response = await engine.go(analysis_position(work=analysis_work(multipv=3)))
    finally:
        await engine.close()
    rows = response.scores.to_json()
    assert len(rows) == 3  # one row per pv
    assert rows[0][3] == Score.cp(30)
    assert rows[2][3] == Score.cp(20)


async def test_move_job():
    work = Work(
        kind="move",
        id="testmove01",
        level=SkillLevel.EIGHT,
        clock=Clock(wtime_centis=3000, btime_centis=3000, inc_seconds=2),
    )
    engine = fake_engine(flavor=EngineFlavor.MULTI_VARIANT)
    try:
        response = await engine.go(Position(
            work=work, position_id=0, flavor=EngineFlavor.MULTI_VARIANT,
            variant=Variant.STANDARD, root_fen=STARTPOS, moves=[]))
    finally:
        await engine.close()
    assert response.best_move == "e2e4"


async def test_engine_crash_raises(monkeypatch):
    monkeypatch.setenv("FAKE_UCI_DIE_ON_GO", "1")
    engine = fake_engine()
    try:
        with pytest.raises(EngineError):
            await engine.go(analysis_position())
    finally:
        await engine.close()


async def test_bestmove_without_score_raises(monkeypatch):
    monkeypatch.setenv("FAKE_UCI_NO_SCORE", "1")
    engine = fake_engine()
    try:
        with pytest.raises(EngineError):
            await engine.go(analysis_position())
    finally:
        await engine.close()


async def test_terminal_position_mate_score(monkeypatch):
    """Checkmate/stalemate: `score mate 0` arrives with no pv and
    `bestmove (none)`: a response, not an engine error."""
    monkeypatch.setenv("FAKE_UCI_MATE", "1")
    engine = fake_engine()
    try:
        response = await engine.go(analysis_position())
    finally:
        await engine.close()
    assert response.best_move is None
    assert response.scores.best() == Score.mate(0)
    assert response.pvs.best() == []


async def test_missing_binary_raises():
    engine = UciEngine("/nonexistent/engine-binary", EngineFlavor.OFFICIAL)
    with pytest.raises(EngineError):
        await engine.go(analysis_position())
    await engine.close()


async def test_factory_routes_flavors():
    factory = UciEngineFactory(sys.executable, args=[FAKE])
    official = await factory.create(EngineFlavor.OFFICIAL)
    variant = await factory.create(EngineFlavor.MULTI_VARIANT)
    assert isinstance(official, UciEngine)
    assert official.flavor is EngineFlavor.OFFICIAL
    assert variant.flavor is EngineFlavor.MULTI_VARIANT
    await official.close()
    await variant.close()


async def test_uci_end_to_end_with_client():
    """A real analysis batch from the fake lichess server through a
    (scripted) UCI engine subprocess and back."""
    with FakeServer() as server:
        work_id = server.lichess.add_analysis_job(moves="e2e4 e7e5 g1f3")
        client = Client(
            endpoint=server.endpoint, key=VALID_KEY, cores=2,
            engine_factory=UciEngineFactory(sys.executable, args=[FAKE]),
            logger=Logger(verbose=0), max_backoff=0.2,
        )
        await client.start()
        assert await wait_for(lambda: work_id in server.lichess.analyses)
        await client.stop()
    parts = server.lichess.analyses[work_id]["analysis"]
    assert len(parts) == 4
    for part in parts:
        assert part["depth"] == 3
        assert part["score"] == {"cp": 30}
        assert part["pv"] == "e2e4 e7e5"


def test_parse_info_line():
    fields = _parse_info_line(
        "info depth 20 seldepth 30 multipv 2 score mate -3 nodes 12345 "
        "nps 1000 time 44 pv a2a4 b7b5".split())
    assert fields["depth"] == 20
    assert fields["multipv"] == 2
    assert fields["score"] == Score.mate(-3)
    assert fields["pv"] == ["a2a4", "b7b5"]
    assert fields["nodes"] == 12345
    # `string` payloads terminate parsing
    assert "pv" not in _parse_info_line("info string hello pv world".split())


# -- against the JAX package -------------------------------------------------

INFO_LINES = [
    "info depth 20 seldepth 30 multipv 2 score mate -3 nodes 12345 nps 1000 time 44 pv a2a4 b7b5",
    "info depth 4 multipv 1 score cp 99 upperbound nodes 4000 nps 500000 time 9 pv e2e4",
    "info depth 7 score cp -12 lowerbound upperbound pv",
    "info depth 0 score mate 0",
    "info string variant=chess go=[go nodes 5]",
    "info depth x seldepth 3 nodes 9x score cp y pv e2e4",
    "info score",
    "info depth",
    "info hashfull 512 tbhits 3 currmove e2e4 currmovenumber 1",
    "info",
]


@pytest.mark.parametrize("line", INFO_LINES)
def test_parse_info_line_as_in_the_jax_package(line):
    got = _parse_info_line(line.split())
    want = jax_uci._parse_info_line(line.split())
    as_plain = lambda d: {k: (v.to_json() if hasattr(v, "to_json") else v)
                          for k, v in d.items()}
    assert as_plain(got) == as_plain(want)


def _comparable(body: dict) -> dict:
    """A submitted body without what depends on the clock or the client's
    version: ``time`` and ``nps`` of each part, ``fishnet.version``."""
    out = dict(body)
    out["fishnet"] = {k: v for k, v in body["fishnet"].items()
                      if k != "version"}
    out["analysis"] = [{k: v for k, v in part.items()
                        if k not in ("time", "nps")}
                       for part in body["analysis"]]
    return out


async def test_submitted_analysis_equals_the_jax_client():
    """The port's Client and the JAX Client, each over its package's
    UciEngineFactory on the scripted engine, submit the same body for the
    same job (multipv 2, a skipped ply)."""
    bodies = []
    for client_cls, factory_cls, logger_cls in (
            (Client, UciEngineFactory, Logger),
            (JaxClient, jax_uci.UciEngineFactory, JaxLogger)):
        with FakeServer() as server:
            work_id = server.lichess.add_analysis_job(
                moves="e2e4 e7e5 g1f3 b8c6", multipv=2, skip_positions=[2])
            client = client_cls(
                endpoint=server.endpoint, key=VALID_KEY, cores=1,
                engine_factory=factory_cls(sys.executable, args=[FAKE]),
                logger=logger_cls(verbose=0), max_backoff=0.2)
            await client.start()
            assert await wait_for(lambda: work_id in server.lichess.analyses)
            await client.stop()
            bodies.append(server.lichess.analyses[work_id])
    port, jax = bodies
    assert _comparable(port) == _comparable(jax)
    assert port["analysis"][2] == {"skipped": True}
    assert len(port["analysis"]) == 5


def test_engine_uci_needs_engine_exe(capsys):
    from fishnet_tpu_torch.__main__ import main

    assert main(["run", "--no-conf", "--no-stats-file", "--engine", "uci",
                 "--endpoint", "http://127.0.0.1:9/fishnet"]) == 2
    assert "--engine uci requires --engine-exe" in capsys.readouterr().err


async def test_child_process_group_gone_after_stop(monkeypatch):
    """Each engine child runs in a session of its own; the client's stop
    kills its process group and reaps it."""
    pids = []
    spawn = UciEngine._spawn

    async def recording_spawn(self):
        await spawn(self)
        pids.append(self._proc.pid)

    monkeypatch.setattr(UciEngine, "_spawn", recording_spawn)
    with FakeServer() as server:
        work_id = server.lichess.add_analysis_job(moves="e2e4")
        client = Client(
            endpoint=server.endpoint, key=VALID_KEY, cores=2,
            engine_factory=UciEngineFactory(sys.executable, args=[FAKE]),
            logger=Logger(verbose=0), max_backoff=0.2)
        await client.start()
        assert await wait_for(lambda: work_id in server.lichess.analyses)
        assert pids and all(os.getpgid(pid) == pid for pid in pids)
        await client.stop()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.killpg(pid, 0)


async def test_the_port_uci_command_as_the_engine(tmp_path):
    """``python -m fishnet_tpu_torch uci --device cpu`` behind a wrapper
    script, driven by the port's UciEngine: a one-position analysis with
    a legal principal variation."""
    wrapper = tmp_path / "engine.sh"
    log = tmp_path / "child.log"
    wrapper.write_text(
        "#!/bin/sh\n"
        f"PYTHONPATH={ROOT} OMP_NUM_THREADS=1 exec {sys.executable} -m "
        f"fishnet_tpu_torch uci --no-conf --device cpu --microbatch 64 -v "
        f"2>>{log}\n")
    wrapper.chmod(0o755)
    engine = UciEngine(str(wrapper), EngineFlavor.OFFICIAL)
    moves = ["e2e4", "e7e5", "g1f3"]
    try:
        response = await engine.go(analysis_position(
            work=analysis_work(nodes=300), moves=moves))
        pid = engine._proc.pid
    finally:
        await engine.close()
    with pytest.raises(ProcessLookupError):
        os.killpg(pid, 0)
    pv = response.pvs.best()
    assert pv and response.best_move == pv[0] and response.depth >= 1
    board = Board()
    for move in moves + pv:
        assert move in board.legal_moves(), (move, pv)
        board.push_uci(move)
    assert "UCI service warmed up on cpu, rung xla" in log.read_text()


def test_run_engine_uci_drains_without_a_device(tmp_path):
    """``run --engine uci --engine-exe W -v`` as a user starts it (W a
    wrapper around the scripted engine), against the stdlib fake lichess:
    the job is submitted, SIGINT drains it to exit 0, its engine child is
    gone, and the teardown line reports no kernel launch and no CUDA
    context: this process builds no service."""
    import re
    import subprocess
    import time

    wrapper = tmp_path / "engine.sh"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {FAKE}\n")
    wrapper.chmod(0o755)
    with FakeServer() as server:
        work_id = server.lichess.add_analysis_job(moves="e2e4 e7e5")
        proc = subprocess.Popen(
            [sys.executable, "-m", "fishnet_tpu_torch", "run", "--no-conf",
             "--no-stats-file", "--engine", "uci", "--engine-exe",
             str(wrapper), "--cores", "1", "--max-backoff", "1", "-v",
             "--endpoint", server.endpoint, "--key", VALID_KEY],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"))
        try:
            deadline = time.monotonic() + 120
            while work_id not in server.lichess.analyses:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.05)
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    pids = [int(p) for p in re.findall(r"Spawned engine process (\d+):", out)]
    assert pids
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.killpg(pid, 0)
    assert ("since warm-up: eval_steps 0, dispatches 0, ft_gather launches: "
            "packed 0, dense 0; rung None\n") in out
    assert "D: cuda_context False\n" in out
    assert len(server.lichess.analyses[work_id]["analysis"]) == 3
