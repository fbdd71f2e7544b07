"""The port's client end to end against the standard-library fake lichess
server of ``chip_smoke.py`` (the one the card runs): acquire -> validate
-> expand -> analyse (the port's mock engine) -> reassemble -> submit.
The port's counterparts of ``tests/test_client_e2e.py``."""

import asyncio
import time

import pytest

from chip_smoke import VALID_KEY, FakeServer
from fishnet_tpu_torch.chess.core import load as load_core
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.engine.mock import MockEngineFactory
from fishnet_tpu_torch.net.api import channel
from fishnet_tpu_torch.protocol.types import AcquiredKind, EvalFlavor
from fishnet_tpu_torch.utils.logger import Logger

pytestmark = pytest.mark.anyio


@pytest.fixture(autouse=True, scope="module")
def native_core():
    """The queue's legality replay runs on the native core, which is
    compiled at its first use: build it before any timed wait starts."""
    load_core()


async def wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval)
    return False


def make_client(endpoint, cores=2, **kwargs) -> Client:
    return Client(
        endpoint=endpoint,
        key=VALID_KEY,
        cores=cores,
        engine_factory=kwargs.pop("engine_factory", MockEngineFactory()),
        logger=Logger(verbose=0),
        max_backoff=kwargs.pop("max_backoff", 0.2),
        **kwargs,
    )


async def test_analysis_batch_end_to_end():
    with FakeServer() as server:
        moves = "e2e4 c7c5 c2c4 b8c6 g1e2 g8f6 b1c3 c6b4 g2g3 b4d3"
        work_id = server.lichess.add_analysis_job(moves=moves, skip_positions=[1, 4])
        client = make_client(server.endpoint)
        await client.start()
        assert await wait_for(lambda: work_id in server.lichess.analyses)
        await client.stop()

    body = server.lichess.analyses[work_id]
    assert body["fishnet"] == {"version": "2.6.8", "apikey": VALID_KEY}
    assert body["stockfish"]["flavor"] == "nnue"
    parts = body["analysis"]
    assert len(parts) == 11  # root + 10 plies
    assert parts[1] == {"skipped": True} and parts[4] == {"skipped": True}
    for i, part in enumerate(parts):
        if i not in (1, 4):
            assert "score" in part and "depth" in part and "nodes" in part


async def test_move_job_end_to_end():
    with FakeServer() as server:
        work_id = server.lichess.add_move_job(
            moves="e2e4", level=5, clock={"wtime": 18000, "btime": 18000, "inc": 2}
        )
        client = make_client(server.endpoint, cores=1)
        await client.start()
        assert await wait_for(lambda: work_id in server.lichess.moves)
        await client.stop()
    best = server.lichess.moves[work_id]["move"]["bestmove"]
    assert isinstance(best, str) and len(best) >= 4


async def test_all_skipped_batch_completes_immediately():
    with FakeServer() as server:
        work_id = server.lichess.add_analysis_job(moves="e2e4", skip_positions=[0, 1])
        client = make_client(server.endpoint, cores=1)
        await client.start()
        assert await wait_for(lambda: work_id in server.lichess.analyses)
        await client.stop()
    parts = server.lichess.analyses[work_id]["analysis"]
    assert parts == [{"skipped": True}, {"skipped": True}]


async def test_invalid_batch_ignored():
    with FakeServer() as server:
        bad = server.lichess.add_analysis_job(moves="e2e4 e2e4")  # illegal replay
        good = server.lichess.add_analysis_job(moves="d2d4")
        client = make_client(server.endpoint, cores=1)
        await client.start()
        assert await wait_for(lambda: good in server.lichess.analyses)
        await client.stop()
    assert bad not in server.lichess.analyses


async def test_rejected_acquire_stops_queue():
    with FakeServer() as server:
        server.lichess.reject_with = 406
        client = make_client(server.endpoint, cores=1)
        await client.start()
        assert await wait_for(lambda: server.lichess.acquire_count >= 1)
        # The queue stops on its own; the acquire count must not grow.
        await asyncio.sleep(0.3)
        count = server.lichess.acquire_count
        await asyncio.sleep(0.3)
        assert server.lichess.acquire_count == count
        await client.stop()


async def test_shutdown_aborts_pending_batches():
    with FakeServer() as server:
        work_id = server.lichess.add_analysis_job(
            moves="e2e4 e7e5 g1f3 b8c6 f1b5 a7a6 b5a4 g8f6"
        )
        # Slow engine so the batch is still pending at shutdown.
        factory = MockEngineFactory(delay_seconds=0.5)
        client = make_client(server.endpoint, cores=1, engine_factory=factory)
        await client.start()
        assert await wait_for(lambda: server.lichess.acquire_count >= 1)
        await asyncio.sleep(0.1)  # let the batch enter pending
        await client.stop(abort_pending=True)
    assert work_id in server.lichess.aborted
    assert work_id not in server.lichess.analyses


async def test_progress_reports_sent_with_null_first_part():
    with FakeServer() as server:
        moves = ("e2e4 e7e5 g1f3 b8c6 f1b5 a7a6 b5a4 g8f6 e1h1 f8e7 f1e1 b7b5 "
                 "a4b3 d7d6")
        work_id = server.lichess.add_analysis_job(moves=moves)
        factory = MockEngineFactory(delay_seconds=0.01)
        client = make_client(server.endpoint, cores=1, engine_factory=factory)
        await client.start()
        assert await wait_for(lambda: work_id in server.lichess.analyses)
        await client.stop()
    reports = server.lichess.progress_reports.get(work_id, [])
    assert reports, "expected at least one progress report"
    for report in reports:
        assert report["analysis"][0] is None


async def test_multipv_matrix_submission():
    with FakeServer() as server:
        work_id = server.lichess.add_analysis_job(moves="e2e4", multipv=3, depth=14)
        client = make_client(server.endpoint, cores=1)
        await client.start()
        assert await wait_for(lambda: work_id in server.lichess.analyses)
        await client.stop()
    part = server.lichess.analyses[work_id]["analysis"][0]
    assert isinstance(part["pv"], list)  # matrix form: multipv x depth
    assert isinstance(part["score"], list) and len(part["score"]) == 3
    # No progress reports for matrix batches (queue.rs:286-288).
    assert work_id not in server.lichess.progress_reports


async def test_key_check():
    with FakeServer() as server:
        logger = Logger()
        for key, accepted in ((VALID_KEY, True), ("WRONGKEY", False)):
            stub, actor = channel(server.endpoint, key, logger)
            task = asyncio.create_task(actor.run())
            err = await stub.check_key()
            assert (err is None) is accepted, err
            actor.stop()
            await asyncio.wait_for(task, 5)


async def test_variant_batch_analyzed_with_hce_flavor():
    # Variant batches route to the MULTI_VARIANT flavor (HCE eval) and
    # complete alongside standard work.
    with FakeServer() as server:
        variant_job = server.lichess.add_analysis_job(moves="e2e4", variant="atomic")
        standard_job = server.lichess.add_analysis_job(moves="e2e4")
        client = make_client(server.endpoint, cores=2)
        await client.start()
        assert await wait_for(
            lambda: variant_job in server.lichess.analyses
            and standard_job in server.lichess.analyses
        )
        await client.stop()
    analyses = server.lichess.analyses
    assert analyses[variant_job]["stockfish"]["flavor"] == "classical"
    assert analyses[standard_job]["stockfish"]["flavor"] == "nnue"
    assert all("pv" in p for p in analyses[variant_job]["analysis"])


async def test_workers_analyze_batch_concurrently():
    """``workers`` pull loops over one engine factory analyze a batch's
    positions concurrently: a 10-position batch with a 0.3 s engine
    completes in about two waves of 8, not 10 serial delays."""
    moves = "e2e4 e7e5 g1f3 b8c6 f1b5 a7a6 b5a4 g8f6 e1g1"
    with FakeServer() as server:
        work_id = server.lichess.add_analysis_job(moves=moves)
        client = make_client(
            server.endpoint, cores=1, workers=8,
            engine_factory=MockEngineFactory(delay_seconds=0.3),
        )
        await client.start()
        t0 = time.monotonic()
        assert await wait_for(lambda: work_id in server.lichess.analyses, timeout=15)
        elapsed = time.monotonic() - t0
        await client.stop()
    parts = server.lichess.analyses[work_id]["analysis"]
    assert len([p for p in parts if p]) == 10
    # Serial would be >= 3.0 s of engine delay alone.
    assert elapsed < 2.4, f"batch took {elapsed:.1f}s — workers serialized?"


async def test_submission_is_not_held_behind_a_long_poll_acquire():
    """An acquire that the server holds (a long poll) does not hold back
    a final submission sent after it."""
    with FakeServer() as server:
        server.lichess.acquire_delay = 2.0
        stub, actor = channel(server.endpoint, VALID_KEY, Logger())
        task = asyncio.create_task(actor.run())
        acquire = asyncio.create_task(stub.acquire(slow=False))
        await asyncio.sleep(0.3)  # the acquire is now held by the server
        assert not acquire.done()
        t0 = time.monotonic()
        stub.submit_analysis("wk1", EvalFlavor.NNUE, [{"skipped": True}],
                             final=True)
        assert await wait_for(lambda: "wk1" in server.lichess.analyses)
        landed = time.monotonic() - t0
        acquired = await acquire
        actor.stop()
        await asyncio.wait_for(task, 5)
    assert landed < 1.0, f"the submission took {landed:.2f} s"
    assert acquired.kind is AcquiredKind.NO_CONTENT
    assert server.lichess.acquire_count == 1


async def test_requests_in_turn_share_one_connection():
    """Requests in turn reuse one kept-alive connection, and an answer
    with a body does not stall on it (the fake server sets TCP_NODELAY:
    without it each of these 30 acquires waits ~40 ms)."""
    with FakeServer() as server:
        for _ in range(30):
            server.lichess.add_analysis_job()
        stub, actor = channel(server.endpoint, VALID_KEY, Logger())
        task = asyncio.create_task(actor.run())
        for _ in range(5):
            assert (await stub.status()) is not None
        t0 = time.monotonic()
        for _ in range(30):
            got = await stub.acquire(slow=False)
            assert got.kind is AcquiredKind.ACCEPTED
        elapsed = time.monotonic() - t0
        assert (await stub.acquire(slow=False)).kind is AcquiredKind.NO_CONTENT
        actor.stop()
        await asyncio.wait_for(task, 5)
    assert server.lichess.connections == 1
    assert elapsed < 0.8, f"30 acquires took {elapsed:.2f} s"
