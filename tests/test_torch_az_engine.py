"""The port's az-mcts engine (fishnet_tpu_torch.engine.az_engine) and its
CLI on the CPU: the service's searches, multipv and cancellation, the
per-ply timeout with a slow net, variant work routed to the native
scalar tier, ``python -m fishnet_tpu_torch run --engine az-mcts --device
cpu`` against the stdlib fake lichess of chip_smoke.py, and eval-cache
snapshots with an AZ section read by the other package (ROADMAP C12).

The nets are seeded TINY nets (``channels=16, blocks=2,
value_hidden=16``, the JAX tests' size) saved as ``.npz``."""

import asyncio
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import VALID_KEY, FakeServer
from fishnet_tpu.search import eval_cache as jax_cache
from fishnet_tpu_torch.__main__ import build_engine_factory, main
from fishnet_tpu_torch.chess.board import Board
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.configure import ConfigError, parse_and_configure
from fishnet_tpu_torch.engine.az_engine import (
    NODES_PER_VISIT,
    AzMctsEngine,
    AzMctsEngineFactory,
    AzMctsService,
)
from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
from fishnet_tpu_torch.ipc import Position
from fishnet_tpu_torch.models.az import AzConfig, init_az_params
from fishnet_tpu_torch.models.az_encoding import POLICY_SIZE
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.protocol.types import EngineFlavor, NodeLimit, Variant, Work
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.mcts import MctsConfig
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.utils.logger import Logger

ROOT = Path(__file__).resolve().parent.parent
STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
MATE_FEN = "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1"
TINY = AzConfig(channels=16, blocks=2, value_hidden=16)


@pytest.fixture(autouse=True)
def fresh_port_cache():
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_service(seed: int) -> AzMctsService:
    return AzMctsService(init_az_params(seed, TINY),
                         MctsConfig(batch_capacity=64, az=TINY), device="cpu")


# -- the service ----------------------------------------------------------------


def test_service_search():
    service = tiny_service(2)

    async def go():
        return await asyncio.gather(service.search(MATE_FEN, [], 300),
                                    service.search(STARTPOS, [], 48))

    try:
        mate, start = asyncio.run(go())
        assert mate.best_move == "d1d8"
        assert start.best_move
        assert service.visits_per_second() > 0
        c = service.pool_counters()
        assert c["visits"] >= 348 and c["dispatch"]["dispatches"] > 0
    finally:
        service.close()


def test_service_multipv_and_cancellation():
    service = tiny_service(4)

    async def go():
        res = await service.search(STARTPOS, [], 64, multipv=3)
        assert [line.multipv for line in res.lines] == [1, 2, 3]
        assert len({line.move for line in res.lines}) == 3
        assert res.lines[0].move == res.best_move
        # Cancellation (the worker's budget) must stop the search.
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(service.search(STARTPOS, [], visits=10_000_000),
                                   timeout=0.3)
        for _ in range(100):
            if service.pool.active() == 0:
                break
            await asyncio.sleep(0.05)
        assert service.pool.active() == 0, "the cancelled search kept running"

    try:
        asyncio.run(go())
    finally:
        service.close()
    with pytest.raises(Exception, match="shut down"):
        asyncio.run(service.search(STARTPOS, [], 8))


def test_analysis_respects_the_per_ply_timeout_with_a_slow_net():
    """The protocol's per-ply timeout holds with a slow net: the first
    search stops at the hard movetime; completed searches feed the
    visits/s EWMA, which then clamps the planned budget."""
    service = tiny_service(7)
    real_step = service.pool.step

    def slow_step():
        time.sleep(0.05)
        return real_step()

    service.pool.step = slow_step
    timeout_ms = 800
    work = Work(kind="analysis", id="azdl1",
                nodes=NodeLimit(classical=4_050_000, sf15=1_500_000),
                timeout_ms=timeout_ms)
    pos = Position(work=work, position_id=0, flavor=EngineFlavor.OFFICIAL,
                   variant=Variant.STANDARD, root_fen=STARTPOS)
    engine = AzMctsEngine(service, EngineFlavor.OFFICIAL)
    planned = {}

    async def go():
        t0 = time.monotonic()
        resp = await engine.go(pos)
        assert time.monotonic() - t0 < timeout_ms / 1000.0 + 2.0
        assert resp.best_move is not None and resp.nodes <= 1_500_000
        assert service.visits_per_second() > 0
        real_search = service.search

        async def capturing(fen, mvs, visits, movetime=None, multipv=1):
            planned.update(visits=visits, movetime=movetime)
            return await real_search(fen, mvs, visits, movetime, multipv=multipv)

        service.search = capturing
        t0 = time.monotonic()
        resp2 = await engine.go(pos)
        assert time.monotonic() - t0 < timeout_ms / 1000.0 + 2.0
        assert resp2.best_move is not None

    try:
        asyncio.run(go())
    finally:
        service.close()
    assert planned["visits"] < 1_500_000 // NODES_PER_VISIT
    assert planned["movetime"] == timeout_ms / 1000.0


def test_variant_work_goes_to_the_scalar_fallback():
    az_service = tiny_service(5)
    hce = SearchService(weights=NnueWeights.random(seed=0), backend="scalar",
                        pool_slots=16, batch_capacity=64, tt_bytes=8 << 20)
    factory = AzMctsEngineFactory(az_service, variant_fallback=TpuNnueEngineFactory(hce))
    try:
        with FakeServer() as server:
            lichess = server.lichess
            variant = lichess.add_analysis_job(moves="e2e4", variant="kingofthehill",
                                               nodes=3000)
            standard = lichess.add_analysis_job(moves="e2e4", nodes=70_000)
            client = Client(endpoint=server.endpoint, key=VALID_KEY, cores=2,
                            engine_factory=factory, logger=Logger(verbose=0),
                            max_backoff=0.2)

            async def go():
                await client.start()
                deadline = time.monotonic() + 60
                while not (variant in lichess.analyses and standard in lichess.analyses):
                    assert time.monotonic() < deadline
                    await asyncio.sleep(0.05)
                await client.stop()

            asyncio.run(go())
            assert lichess.analyses[variant]["stockfish"]["flavor"] == "classical"
            parts = lichess.analyses[standard]["analysis"]
            assert len(parts) == 2 and all("pv" in p for p in parts)
            assert az_service.pool_counters()["visits"] > 0
            assert hce.counters()["eval_steps"] == 0  # the scalar tier: no device
    finally:
        factory.close()


# -- the CLI -----------------------------------------------------------------


def test_cli_options_and_the_engine_factory(tmp_path, capsys):
    opt = parse_and_configure(["run", "--no-conf", "--engine", "az-mcts",
                               "--az-net-file", "n.npz", "--cores", "2"])
    assert (opt.resolved_engine(), opt.az_net_file) == ("az-mcts", "n.npz")
    assert opt.resolved_workers() == 64  # the shared batched engine
    ini = tmp_path / "fishnet.ini"
    ini.write_text("[Fishnet]\nEngine = az-mcts\nAzNetFile = w.npz\n")
    opt = parse_and_configure(["run", "--conf", str(ini)])
    assert (opt.engine, opt.az_net_file) == ("az-mcts", "w.npz")
    # A bad --az-net-file is a configuration error, not a traceback.
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    not_az = tmp_path / "nnue.npz"
    np.savez(not_az, ft_w=np.zeros(3, np.float32))
    for path in (bad, not_az, tmp_path / "missing.npz"):
        opt = parse_and_configure(["run", "--no-conf", "--engine", "az-mcts",
                                   "--device", "cpu", "--az-net-file", str(path)])
        with pytest.raises(ConfigError, match="--az-net-file"):
            build_engine_factory(opt, Logger(verbose=0))
        assert main(["run", "--no-conf", "--no-stats-file", "--engine", "az-mcts",
                     "--device", "cpu", "--az-net-file", str(path), "--endpoint",
                     "http://127.0.0.1:9/fishnet"]) == 2
        assert "--az-net-file" in capsys.readouterr().err
    # Dev mode: the default AzConfig from the port's own seed, with a warning.
    opt = parse_and_configure(["run", "--no-conf", "--engine", "az-mcts",
                               "--device", "cpu", "--microbatch", "64"])
    factory = build_engine_factory(opt, Logger(verbose=0))
    try:
        assert factory.service.pool.cfg.az == AzConfig()
        assert factory.service.pool.cfg.batch_capacity == 64
        assert factory.variant_fallback.service.backend == "scalar"
    finally:
        factory.close()
    assert "dev mode" in capsys.readouterr().out


def test_run_engine_az_mcts_on_the_cpu(tmp_path):
    """``python -m fishnet_tpu_torch run --engine az-mcts --device cpu``
    against the stdlib fake lichess: complete analyses, a legal move, a
    variant job on the scalar tier, an exit 0 on SIGINT, and the AZ
    section of the eval-cache snapshot under the net's fingerprint."""
    net = tmp_path / "tiny.npz"
    np.savez(net, **init_az_params(6, TINY))
    snap = tmp_path / "snap.npz"
    with FakeServer() as server:
        lichess = server.lichess
        analysis = lichess.add_analysis_job(moves="e2e4 e7e5", nodes=70_000)
        variant = lichess.add_analysis_job(moves="e2e4", variant="kingofthehill",
                                           nodes=2000)
        move = lichess.add_move_job(moves="e2e4 e7e5 g1f3", level=1)
        env = dict(os.environ, OMP_NUM_THREADS="1", FISHNET_EVAL_CACHE_SNAPSHOT=str(snap))
        proc = subprocess.Popen(
            [sys.executable, "-m", "fishnet_tpu_torch", "run", "--engine", "az-mcts",
             "--device", "cpu", "--az-net-file", str(net), "--no-conf",
             "--no-stats-file", "--endpoint", server.endpoint, "--key", VALID_KEY,
             "--cores", "1", "--microbatch", "64", "--max-backoff", "1", "-v"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            deadline = time.monotonic() + 120
            while not (analysis in lichess.analyses and variant in lichess.analyses
                       and move in lichess.moves):
                assert proc.poll() is None, proc.stdout.read()[-3000:]
                assert time.monotonic() < deadline, "the client did not finish"
                time.sleep(0.1)
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert "az-mcts pool counters" in out
    parts = lichess.analyses[analysis]["analysis"]
    assert len(parts) == 3
    assert all("pv" in p and "score" in p for p in parts)
    assert lichess.analyses[variant]["stockfish"]["flavor"] == "classical"
    best = lichess.moves[move]["move"]["bestmove"]
    board = Board(STARTPOS)
    for m in ("e2e4", "e7e5", "g1f3"):
        board.push_uci(m)
    assert best in board.legal_moves()
    with np.load(snap) as data:
        assert int(data["az_fingerprint"]) == eval_cache.az_net_fingerprint(
            {k: v for k, v in np.load(net).items()})
        assert len(data["az_hashes"]) > 0
        assert data["az_logits"].shape[1:] == (POLICY_SIZE,)


# -- snapshots with an AZ section, across the packages (C12) --------------------


def _fill(module, seed: int, n: int):
    """``n`` AZ entries (and a few NNUE ones) in ``module``'s caches."""
    rng = np.random.default_rng(seed)
    hashes = rng.integers(1, 2 ** 63, n, dtype=np.int64).astype(np.uint64)
    az = module.get_az_cache()
    for h in hashes:
        az.insert(int(h), (rng.standard_normal(POLICY_SIZE).astype(np.float16),
                           np.float32(rng.uniform(-1, 1))))
    az.advance_generation()
    module.get_cache().insert_block(hashes[:4], np.arange(4, dtype=np.int32))


def _az_entries(module):
    h, lg, v, g = module.get_az_cache().dump_az_entries()
    order = np.argsort(h)
    return h[order], lg[order], v[order], g[order]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_az_section_loads_in_the_other_package(writer, tmp_path):
    packages = {"port": eval_cache, "jax": jax_cache}
    src = packages[writer]
    dst = packages["jax" if writer == "port" else "port"]
    path = str(tmp_path / "snap.npz")
    fp, az_fp = 0x1234, 0xFEDCBA9876543210
    _fill(src, seed=3, n=40)
    assert src.save_snapshot(path, fingerprint=fp, az_fingerprint=az_fp) == path
    want = _az_entries(src)
    assert dst.load_snapshot(path, fingerprint=fp, az_fingerprint=az_fp)
    got = _az_entries(dst)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(dst.get_cache()) == 4
    # Another AZ net: the NNUE entries load, the AZ section is skipped.
    dst.reset_cache()
    assert dst.load_snapshot(path, fingerprint=fp, az_fingerprint=az_fp ^ 1)
    assert len(dst.get_az_cache()) == 0 and len(dst.get_cache()) == 4
    # Another NNUE: the file is discarded.
    dst.reset_cache()
    assert not dst.load_snapshot(path, fingerprint=fp ^ 1, az_fingerprint=az_fp)
    assert not os.path.exists(path)


def test_snapshot_written_with_only_az_entries(tmp_path):
    """An az-mcts run fills only the AZ cache: its snapshot still writes
    (as the JAX package's does) and reloads."""
    path = str(tmp_path / "snap.npz")
    az = eval_cache.get_az_cache()
    az.insert(7, (np.ones(POLICY_SIZE, np.float16), np.float32(0.25)))
    assert eval_cache.save_snapshot(path, az_fingerprint=9) == path
    eval_cache.reset_cache()
    assert eval_cache.load_snapshot(path, az_fingerprint=9)
    lg, val = eval_cache.get_az_cache().probe_many([7])[0]
    assert lg.dtype == np.float16 and lg.sum() == POLICY_SIZE and val == np.float32(0.25)
    jax_cache.reset_cache()
    assert jax_cache.load_snapshot(path, az_fingerprint=9)
    assert len(jax_cache.get_az_cache()) == 1
