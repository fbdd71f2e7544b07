"""The port's ``run`` path against the JAX package's, end to end on the
CPU: the same jobs on ``tests/fake_server.py``, acquired, analysed by
the ``tpu-nnue`` engine over the same net (``NnueWeights.random(seed=31)``
in both packages) and submitted back.

One run goes through ``fishnet_tpu.client.Client`` over the JAX
SearchService, the other through ``fishnet_tpu_torch.client.Client``
over the port's ``device="cpu"`` service. One worker, a pinned prefetch
budget and the JAX service's single-device path (coalescer, eval cache
and bounds tier off) make the searches a deterministic function of the
job sequence, so the submitted ``analysis`` bodies must be equal. The
NNUE is integer arithmetic: no tolerance. Only ``time`` and ``nps``
(wall-clock) and the ``fishnet.version`` field are left out of the
comparison."""

import ast
import asyncio
import copy
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from fishnet_tpu.client import Client as JaxClient
from fishnet_tpu.engine.tpu_engine import TpuNnueEngineFactory as JaxFactory
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.search.service import SearchService as JaxService
from fishnet_tpu.utils.logger import Logger as JaxLogger
import chip_smoke
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.utils.logger import Logger
from tests.fake_server import VALID_KEY, FakeServer

KW = dict(pool_slots=16, batch_capacity=64, tt_bytes=16 << 20)

#: (add_analysis_job kwargs): a game with a skipped ply, a multipv game
#: (matrix submissions) and the fool's-mate game of
#: tests/test_tpu_engine_e2e.py (a mated final position).
JOBS = [
    dict(moves="e2e4 c7c5 g1f3 d7d6 d2d4 c5d4", skip_positions=[2], nodes=150),
    dict(moves="d2d4 g8f6 c2c4", multipv=3, nodes=100),
    dict(moves="f2f3 e7e5 g2g4 d8h4", nodes=150),
]


def _comparable(body):
    """The submitted body without its wall-clock and version fields."""
    body = copy.deepcopy(body)
    body["fishnet"].pop("version")
    for part in body["analysis"]:
        if isinstance(part, dict):
            part.pop("time", None)
            part.pop("nps", None)
    return body


async def _run(client_cls, factory, logger):
    async with FakeServer() as server:
        ids = [server.lichess.add_analysis_job(**job) for job in JOBS]
        client = client_cls(
            endpoint=server.endpoint, key=VALID_KEY, cores=1, workers=1,
            engine_factory=factory, logger=logger, max_backoff=0.2,
        )
        await client.start()
        deadline = asyncio.get_running_loop().time() + 600
        while not all(i in server.lichess.analyses for i in ids):
            assert asyncio.get_running_loop().time() < deadline, "timed out"
            await asyncio.sleep(0.05)
        await client.stop()
        return [server.lichess.analyses[i] for i in ids]


@pytest.fixture
def one_torch_thread():
    """The port's CPU evaluator runs small gathers for which torch's
    intra-op threads cost more than they give, most of all when other
    test processes share the cores: one thread for this test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_run_path_submits_the_same_analysis_as_the_jax_client(
        monkeypatch, one_torch_thread):
    for hatch in ("FISHNET_NO_COALESCE", "FISHNET_NO_EVAL_CACHE",
                  "FISHNET_NO_BOUNDS"):
        monkeypatch.setenv(hatch, "1")
    # On a loaded CPU one search can outlast the worker's 60 s engine
    # budget; the timed-out search is requeued and searched again over
    # a TT it already filled, so the two runs would diverge. The budget
    # is not what this test compares: lift it in both clients.
    for module in ("fishnet_tpu.client", "fishnet_tpu_torch.client"):
        monkeypatch.setattr(f"{module}.DEFAULT_BUDGET_SECONDS", 3600.0)
    ref_svc = JaxService(weights=JaxWeights.random(seed=31), **KW)
    port_svc = SearchService(weights=NnueWeights.random(seed=31),
                             device="cpu", **KW)
    try:
        for svc in (ref_svc, port_svc):
            svc.set_prefetch(8, adaptive=False)
        ref = asyncio.run(_run(JaxClient, JaxFactory(ref_svc), JaxLogger()))
        port = asyncio.run(_run(Client, TpuNnueEngineFactory(port_svc),
                                Logger()))
    finally:
        ref_svc.close()
        port_svc.close()

    assert [_comparable(b) for b in port] == [_comparable(b) for b in ref]
    # The bodies are the ones asked for: a skipped ply, matrix parts,
    # and the mated final position.
    skip, matrix, mate = port
    assert skip["analysis"][2] == {"skipped": True}
    assert skip["stockfish"] == {"flavor": "nnue"}
    assert all(isinstance(p["score"], list) and len(p["score"]) == 3
               for p in matrix["analysis"])
    assert mate["analysis"][-1]["score"] == {"mate": 0}
    assert mate["analysis"][-2]["score"] == {"mate": 1}
    assert sum(p["nodes"] for p in skip["analysis"] if "nodes" in p) > 500


def test_client_parity_check_of_the_chip_run_holds_on_the_cpu(
        one_torch_thread):
    """``chip_smoke.client_parity``, the run phase's check against the
    native scalar service, on the port's CPU service at a small size:
    the same score, best move and depth per ply, in a run with no engine
    timeout, requeue or abort."""
    chip_smoke.client_parity(NnueWeights.random(seed=0), "cpu", games=1,
                             plies=4, depth=2)


def test_cli_teardown_counts_the_run_after_the_warm_up():
    """``python -m fishnet_tpu_torch run --device cpu -v`` over the
    tpu-nnue engine, drained by SIGINT once its job is submitted: the
    teardown line counts the steps dispatched after the service's
    warm-up (all of the service's: the warm-up evaluates outside the
    pool), and on the CPU no kernel launch (the wrapper runs the plain
    version); the rung is the CPU ladder's first."""
    root = Path(__file__).resolve().parent.parent
    with chip_smoke.FakeServer() as server:
        job = server.lichess.add_analysis_job(moves="e2e4 e7e5", nodes=100)
        proc = subprocess.Popen(
            [sys.executable, "-m", "fishnet_tpu_torch", "run", "--device",
             "cpu", "--no-conf", "--no-stats-file", "--endpoint",
             server.endpoint, "--key", chip_smoke.VALID_KEY, "--cores", "1",
             "--microbatch", "64", "--max-backoff", "1", "-v"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            deadline = time.monotonic() + 240
            while job not in server.lichess.analyses:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    steps, dispatches, packed, dense, rung = chip_smoke.teardown_counts(out)
    total = ast.literal_eval(out.split("Service counters: ")[1].split(
        "; since warm-up")[0])
    assert steps == total["eval_steps"] > 0
    assert dispatches == total["dispatches"] > 0
    assert (packed, dense, rung) == (0, 0, "xla")


def test_teardown_counts_only_what_follows_the_warm_up(monkeypatch):
    """The teardown line subtracts the counts taken after the warm-up,
    whose one launch builds the kernel and is no step of the run."""
    from fishnet_tpu_torch import __main__ as cli
    from fishnet_tpu_torch.ops import ft_gather

    class Service:
        steps = 0

        def counters(self):
            return {"eval_steps": self.steps, "dispatches": self.steps - 2}

    class Factory:
        service = Service()
        supervisor = None

    packed, dense = ft_gather.ft_accumulate_packed_cuda, ft_gather.ft_accumulate_cuda
    monkeypatch.setattr(packed, "launches", 1)  # the warm-up's
    monkeypatch.setattr(dense, "launches", 0)
    factory = Factory()
    warm = cli._run_counts(factory)
    factory.service.steps += 7
    packed.launches += 7
    line = cli._teardown_counters(factory, warm)
    assert chip_smoke.teardown_counts(line) == (7, 7, 7, 0, "None")
    assert chip_smoke.teardown_counts(
        cli._teardown_counters(factory, (0, 0, 0, 0))) == (7, 5, 8, 0,
                                                          "None")
