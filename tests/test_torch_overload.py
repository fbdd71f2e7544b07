"""The port's multi-tenant front end, admission control and load shedding
(fishnet_tpu_torch.sched.frontend, resilience.shedding, the lane
scheduler of sched.queue) against the JAX package's, on the CPU: the
port's counterparts of ``tests/test_overload.py``.

The single-stream queue hands positions out in the JAX package's FIFO
order; the lane scheduler and the shed policy, fed the same seeded
sequences in both packages, give the same pops, served counts, depths,
decisions and watermarks; both clients under the same plans on
``tests/fake_server.py`` (each with its package's mock engine, whose
answers are identical and deterministic) submit the same bodies and
leave the same ledger records; the ``tpu-nnue`` engine at two tenants
submits the JAX client's analyses bit for bit. The saturation run holds
the port to the gates of the JAX package's overload smoke (through
``chip_smoke.saturate``, the harness the card runs). Everything compared
between the packages is exact: no tolerance."""

import asyncio
import copy
import gc
import os
import signal
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from fishnet_tpu import configure as jax_configure
from fishnet_tpu.client import Client as JaxClient
from fishnet_tpu.engine.mock import MockEngineFactory as JaxMock
from fishnet_tpu.engine.tpu_engine import TpuNnueEngineFactory as JaxFactory
from fishnet_tpu.net import api as jax_api
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.protocol.types import AcquireResponseBody as JaxBody
from fishnet_tpu.resilience import accounting as jax_accounting
from fishnet_tpu.resilience import faults as jax_faults
from fishnet_tpu.resilience import shedding as jax_shedding
from fishnet_tpu.sched import frontend as jax_frontend
from fishnet_tpu.sched import queue as jax_queue
from fishnet_tpu.search.service import SearchService as JaxService
from fishnet_tpu.telemetry import exporter as jax_exporter
from fishnet_tpu.utils.logger import Logger as JaxLogger
from fishnet_tpu.utils.stats import StatsRecorder as JaxStats
from fishnet_tpu_torch import configure, telemetry
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.engine.mock import MockEngineFactory
from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
from fishnet_tpu_torch.net import api
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.protocol.types import AcquireResponseBody
from fishnet_tpu_torch.resilience import accounting, faults, shedding
from fishnet_tpu_torch.resilience.shedding import (
    ADMIT,
    LANE_LATENCY,
    LANE_THROUGHPUT,
    SHED,
    ShedPolicy,
)
from fishnet_tpu_torch.sched import frontend
from fishnet_tpu_torch.sched import queue
from fishnet_tpu_torch.sched.queue import LaneScheduler
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.telemetry import exporter
from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.utils.stats import StatsRecorder
from tests.fake_server import VALID_KEY, FakeServer
from tests.test_protocol import ANALYSIS_ACQUIRE, MOVE_ACQUIRE

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.anyio

#: Each package's modules, by name, for the tests that run both.
PKGS = {
    "jax": SimpleNamespace(
        queue=jax_queue, frontend=jax_frontend, shedding=jax_shedding,
        accounting=jax_accounting, faults=jax_faults, Client=JaxClient,
        Mock=JaxMock, Logger=JaxLogger, Stats=JaxStats, Body=JaxBody,
        exporter=jax_exporter),
    "port": SimpleNamespace(
        queue=queue, frontend=frontend, shedding=shedding,
        accounting=accounting, faults=faults, Client=Client,
        Mock=MockEngineFactory, Logger=Logger, Stats=StatsRecorder,
        Body=AcquireResponseBody, exporter=exporter),
}


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    for pkg in PKGS.values():
        pkg.faults.clear()
        pkg.accounting.clear()


@pytest.fixture(autouse=True, scope="module")
def native_core():
    """The queue's legality replay runs on the native core, which is
    compiled at its first use: build it before any timed wait starts."""
    from fishnet_tpu_torch.chess.core import load as load_core

    load_core()


def _pos(batch_id: str, position_id: int = 0, tenant: str = ""):
    """The minimal duck-typed position the scheduler touches."""
    return SimpleNamespace(
        work=SimpleNamespace(id=batch_id), position_id=position_id,
        tenant=tenant,
    )


def _comparable(body):
    """A submitted body without its wall-clock and version fields."""
    body = copy.deepcopy(body)
    body["fishnet"].pop("version")
    for part in body.get("analysis", []):
        if isinstance(part, dict):
            part.pop("time", None)
            part.pop("nps", None)
    return body


class FakeApi:
    """The slice of ApiStub the queue side calls, for one tenant."""

    def __init__(self, tenant: str = "") -> None:
        self.endpoint = "http://fake/fishnet"
        self.tenant = tenant
        self.aborted = []
        self.submitted = []

    def abort(self, batch_id: str) -> None:
        self.aborted.append(batch_id)

    def submit_analysis(self, batch_id, flavor, analysis, final=True) -> None:
        self.submitted.append(batch_id)


# -- the single-stream queue keeps the JAX package's FIFO order ---------------


async def _pull_order(pkg) -> list:
    """An analysis batch, then a move job, through one package's
    single-stream queue (its actor's trust boundary, no front end); the
    positions the workers are handed, in order."""
    p = PKGS[pkg]
    logger = p.Logger(verbose=0)
    fake = FakeApi()
    rx, interrupt = asyncio.Queue(), asyncio.Event()
    state = p.queue.QueueState(2, p.Stats(2, no_stats_file=True), logger)
    actor = p.queue.QueueActor(rx, interrupt, state, fake,
                               p.queue.BacklogOpt(), logger)
    move = dict(MOVE_ACQUIRE, work=dict(MOVE_ACQUIRE["work"], id="move_id"))
    await actor.handle_acquired(p.Body.from_json(ANALYSIS_ACQUIRE))
    await actor.handle_acquired(p.Body.from_json(move))
    order = []
    while state.incoming_len():
        fut = asyncio.get_running_loop().create_future()
        assert state.try_pull(fut)
        order.append((fut.result().work.id, fut.result().position_id))
    return order


async def test_single_stream_queue_hands_out_positions_in_the_jax_fifo_order():
    """The reference's ``VecDeque``: a move job waits behind the analysis
    positions queued before it (on a single stream the lanes belong to
    the multi-tenant scheduler only)."""
    port = await _pull_order("port")
    assert port == await _pull_order("jax")
    # 11 plies, 3 skipped: 8 analysis positions, then the move.
    assert [w for w, _ in port] == ["work_id"] * 8 + ["move_id"]
    assert [i for _, i in port[:8]] == [0, 2, 3, 6, 7, 8, 9, 10]


# -- the lane scheduler ----------------------------------------------------------


def _both_schedulers(**kw):
    return LaneScheduler(**kw), jax_queue.LaneScheduler(**kw)


def _drain(sched) -> list:
    out = []
    while (p := sched.pop()) is not None:
        out.append((p.work.id, p.position_id))
    return out


def test_lane_scheduler_strict_priority_as_jax():
    for sched in _both_schedulers():
        for i in range(5):
            sched.push(_pos("bulk", i), "t0", LANE_THROUGHPUT)
        sched.push(_pos("move", 0), "t1", LANE_LATENCY)
        # The latency lane drains first even though it was pushed last.
        assert sched.pop().work.id == "move"
        assert sched.pop().work.id == "bulk"
        assert sched.depths() == {LANE_LATENCY: 0, LANE_THROUGHPUT: 4}


def test_lane_scheduler_drr_alternates_by_quantum_as_jax():
    orders = []
    for sched in _both_schedulers(quantum=8):
        for i in range(20):
            sched.push(_pos("a", i), "ta", LANE_THROUGHPUT)
            sched.push(_pos("b", i), "tb", LANE_THROUGHPUT)
        orders.append([w for w, _ in _drain(sched)])
        assert len(sched) == 0
    port, ref = orders
    assert port == ref
    # Quantum-sized turns, alternating tenants: a x8, b x8, a x8, ...
    assert port[:24] == ["a"] * 8 + ["b"] * 8 + ["a"] * 8
    assert port.count("a") == port.count("b") == 20


def test_lane_scheduler_drop_batch_and_front_push_as_jax():
    for sched in _both_schedulers():
        for i in range(3):
            sched.push(_pos("keep", i), "t0", LANE_THROUGHPUT)
            sched.push(_pos("drop", i), "t0", LANE_THROUGHPUT)
        assert sched.drop_batch("drop") == 3
        assert len(sched) == 3
        # A requeued position goes to the FRONT of its tenant queue.
        sched.push(_pos("keep", 99), "t0", LANE_THROUGHPUT, front=True)
        assert sched.pop().position_id == 99


def _scheduler_ops(seed: int, n: int = 600) -> list:
    """A seeded sequence of pushes (four tenants, both lanes, some to the
    front), pops, batch drops, weight maps and clears."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        tenant = f"t{rng.integers(4)}"
        if r < 0.5:
            lane = LANE_LATENCY if rng.random() < 0.15 else LANE_THROUGHPUT
            ops.append(("push", tenant, lane, f"b{rng.integers(10)}", i,
                        bool(rng.random() < 0.1)))
        elif r < 0.88:
            ops.append(("pop",))
        elif r < 0.94:
            ops.append(("drop", f"b{rng.integers(10)}"))
        elif r < 0.99:
            weights = {f"t{j}": float(rng.choice([0.1, 0.5, 1.0, 2.0, 3.0]))
                       for j in range(int(rng.integers(0, 4)))}
            ops.append(("weights", weights))
        else:
            ops.append(("clear",))
    return ops


def _replay_scheduler(sched, ops) -> list:
    trace = []
    for op in ops:
        if op[0] == "push":
            _, tenant, lane, batch, i, front = op
            sched.push(_pos(batch, i, tenant), tenant, lane, front=front)
            out = None
        elif op[0] == "pop":
            p = sched.pop()
            if p is not None:
                sched.note_served(p.tenant)
            out = None if p is None else (p.work.id, p.position_id)
        elif op[0] == "drop":
            out = sched.drop_batch(op[1])
        elif op[0] == "weights":
            sched.set_tenant_weights(op[1])
            out = sched.tenant_weights()
        else:
            out = sched.clear()
        trace.append((out, sched.depths(), len(sched), dict(sched.served)))
    return trace


@pytest.mark.parametrize("seed,quantum", [(0, 8), (1, 8), (2, 3), (3, 1)])
def test_lane_scheduler_seeded_sequences_as_jax(seed, quantum):
    ops = _scheduler_ops(seed)
    port, ref = (_replay_scheduler(s, ops)
                 for s in _both_schedulers(quantum=quantum))
    assert port == ref
    assert sum(out is not None for (out, *_), op in zip(port, ops)
               if op[0] == "pop") > 100


# -- the shed policy -------------------------------------------------------------


def _both_policies(**kw):
    return ShedPolicy(**kw), jax_shedding.ShedPolicy(**kw)


def test_shed_policy_watermark_hysteresis_as_jax():
    for policy in _both_policies(high_watermark=10):  # low defaults to 5
        assert policy.note_depth(9) is False
        assert policy.note_depth(10) is True  # crossed high: shedding
        assert policy.note_depth(6) is True  # above low: still shedding
        assert policy.note_depth(5) is False  # at low: recovered
        assert policy.admit(LANE_THROUGHPUT, 4, throughput_depth=3,
                            latency_depth=0) == ADMIT
        assert policy.admit(LANE_THROUGHPUT, 4, throughput_depth=30,
                            latency_depth=0) == SHED
        assert policy.shed_count == 1 and policy.admit_count == 1


def test_shed_policy_latency_lane_only_bounded_as_jax():
    snaps = []
    for policy in _both_policies(high_watermark=10):  # latency_bound = 40
        # The latency lane ignores throughput saturation...
        assert policy.admit(LANE_LATENCY, 1, throughput_depth=10_000,
                            latency_depth=0) == ADMIT
        # ...and sheds only past its own hard bound.
        assert policy.admit(LANE_LATENCY, 1, throughput_depth=0,
                            latency_depth=40) == SHED
        snaps.append(policy.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["latency_bound"] == 40 and snaps[0]["shed_count"] == 1


def test_shed_policy_capacity_scales_with_rung_and_breaker_as_jax():
    state = {"open": False}
    for policy in _both_policies(high_watermark=100, rung_fn=lambda: "xla",
                                 breaker_open_fn=lambda: state["open"]):
        state["open"] = False
        assert policy.effective_high() == 50  # xla rung halves capacity
        state["open"] = True
        assert policy.effective_high() == 25  # open breaker halves it again
        assert policy.effective_low() <= policy.effective_high()
        # A degraded plane sheds at depths a healthy one would admit.
        assert policy.admit(LANE_THROUGHPUT, 1, throughput_depth=30,
                            latency_depth=0) == SHED
    # The map is the JAX package's, by rung name: one step down the
    # card's ladder (fused -> host-material) quarters capacity.
    assert shedding.RUNG_CAPACITY_SCALE == jax_shedding.RUNG_CAPACITY_SCALE
    assert ShedPolicy(high_watermark=100,
                      rung_fn=lambda: "host-material").effective_high() == 25


def _policy_trace(policy, ops, env) -> list:
    trace = []
    for op in ops:
        if op[0] == "admit":
            _, lane, n, tdepth, ldepth, rung, breaker = op
            env.update(rung=rung, open=breaker)
            out = policy.admit(lane, n, tdepth, ldepth)
        elif op[0] == "note":
            out = policy.note_depth(op[1])
        else:
            policy.set_watermarks(*op[1:])
            out = None
        trace.append((out, policy.shed_active, policy.effective_high(),
                      policy.effective_low(), policy.snapshot()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shed_policy_seeded_decisions_as_jax(seed):
    """The same decisions over a seeded sequence of lane depths, ladder
    rungs, breaker states and watermark changes."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(400):
        r = rng.random()
        if r < 0.8:
            ops.append(("admit",
                        LANE_LATENCY if rng.random() < 0.2 else LANE_THROUGHPUT,
                        int(rng.integers(1, 42)), int(rng.integers(0, 400)),
                        int(rng.integers(0, 1100)),
                        str(rng.choice(["fused", "xla", "host-material"])),
                        bool(rng.random() < 0.2)))
        elif r < 0.95:
            ops.append(("note", int(rng.integers(0, 400))))
        elif r < 0.975:
            ops.append(("watermarks", (int(rng.integers(1, 300)),
                                       int(rng.integers(1, 300)))))
        else:
            ops.append(("watermarks", int(rng.integers(1, 300))))
    traces = []
    for cls in (ShedPolicy, jax_shedding.ShedPolicy):
        env = {"rung": "fused", "open": False}
        policy = cls(high_watermark=200, rung_fn=lambda: env["rung"],
                     breaker_open_fn=lambda: env["open"])
        traces.append(_policy_trace(policy, ops, env))
    assert traces[0] == traces[1]
    decisions = [t[0] for t, op in zip(traces[0], ops) if op[0] == "admit"]
    assert decisions.count(SHED) > 10 and decisions.count(ADMIT) > 10


def _admission_ops(seed: int, n: int = 240) -> list:
    """A seeded interleaving of acquired batches (a tenant, a move job or
    an analysis of 1-40 plies) and worker pulls (1-30 positions)."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(n):
        if rng.random() < 0.7:
            tenant = f"t{rng.integers(4)}"
            plies = 0 if rng.random() < 0.25 else int(rng.integers(1, 41))
            ops.append(("acquire", f"w{step}", tenant, plies,
                        int(rng.integers(8))))
        else:
            ops.append(("pull", int(rng.integers(1, 31))))
    return ops


async def _front_end_trace(pkg, ops, high: int, games) -> list:
    """``ops`` through one package's ``FrontEnd._admit`` and its workers'
    ``try_pull``, as the front end runs them: per acquire the decision,
    the tenant's counts and the shed flag; per pull the positions handed
    out; then the served counts, the depths and the policy's snapshot."""
    p = PKGS[pkg]
    fe = p.frontend.FrontEnd(
        "http://127.0.0.1:1/fishnet", "key", p.Logger(verbose=0), cores=1,
        tenants=4, shed_policy=p.shedding.ShedPolicy(high_watermark=high))
    loop = asyncio.get_running_loop()
    trace = []
    for op in ops:
        if op[0] == "acquire":
            _, work_id, tenant, plies, game = op
            src = MOVE_ACQUIRE if plies == 0 else dict(
                ANALYSIS_ACQUIRE, moves=" ".join(games[game][:plies]),
                skipPositions=[])
            body = dict(src, work=dict(src["work"], id=work_id))
            ts = fe.tenants[tenant]
            await fe._admit(ts, p.Body.from_json(body))
            trace.append((ts.acquired, ts.shed, fe.shed_policy.shed_active,
                          fe.state.scheduler.depths()))
        else:
            handed = []
            for _ in range(op[1]):
                fut = loop.create_future()
                if not fe.state.try_pull(fut):
                    break
                handed.append((fut.result().work.id,
                               fut.result().position_id))
            trace.append(handed)
    trace.append((dict(fe.state.scheduler.served),
                  {n: (ts.acquired, ts.shed) for n, ts in fe.tenants.items()},
                  fe.shed_policy.snapshot()))
    return trace


@pytest.mark.parametrize("seed,high", [(0, 64), (1, 128), (2, 256)])
async def test_front_end_admission_over_a_seeded_sequence_as_jax(
        seed, high, clean_health):
    """The admission the port runs (``FrontEnd._admit`` through the shed
    policy and the lane scheduler, workers pulling in between) decides,
    queues and serves as the JAX front end does, batch for batch."""
    ops = _admission_ops(seed)
    games = chip_smoke.random_games(8, 40, seed=seed)
    port = await _front_end_trace("port", ops, high, games)
    assert port == await _front_end_trace("jax", ops, high, games)
    counts = port[-1][1]
    assert sum(a for a, _ in counts.values()) > 10
    assert sum(s for _, s in counts.values()) > 10


def test_admission_metrics_are_the_jax_families():
    policy = ShedPolicy(high_watermark=4)
    before = shedding._ADMISSIONS.value(lane=LANE_THROUGHPUT, decision=SHED)
    assert policy.admit(LANE_THROUGHPUT, 3, 9, 0) == SHED
    assert shedding._ADMISSIONS.value(
        lane=LANE_THROUGHPUT, decision=SHED) == before + 1
    assert shedding._SHED_ACTIVE.labels().value == 1.0
    policy.note_depth(0)
    assert shedding._SHED_ACTIVE.labels().value == 0.0
    text = telemetry.REGISTRY.render_prometheus()
    for family in ("fishnet_admission_total", "fishnet_shed_active",
                   "fishnet_tenant_batches_acquired_total",
                   "fishnet_tenant_batches_shed_total",
                   "fishnet_acquire_paced_total"):
        assert f"# TYPE {family} " in text


async def test_shed_aware_pacer_and_tenant_channels_as_jax():
    results = []
    for mod in (api, jax_api):
        shedding_now = {"on": False}
        pacer = mod.ShedAwarePacer(lambda: shedding_now["on"], tenant="t3",
                                   pause_seconds=0.0)
        stub, actor = mod.channel("http://127.0.0.1:1/fishnet/", "k",
                                  (Logger if mod is api else JaxLogger)(),
                                  tenant="t3")
        stub.pacer = pacer
        first = await stub.pace_acquire()
        shedding_now["on"] = True
        second = await stub.pace_acquire()
        results.append((first, second, stub.tenant, stub.endpoint,
                        actor.tenant, actor.breaker.name))
    assert results[0] == results[1] == (
        False, True, "t3", "http://127.0.0.1:1/fishnet", "t3", "submit:t3")
    assert api._ACQUIRE_PACED.value(tenant="t3") >= 1


# -- the queue.admit site, shutdown, requeue cap, deadline flush ----------------


async def test_queue_admit_fault_site():
    assert "queue.admit" in faults.SITES
    faults.install("queue.admit:nth=1:error")
    with pytest.raises(faults.FaultInjected):
        await faults.fire_async("queue.admit")
    await faults.fire_async("queue.admit")  # nth=1 only: second passes
    assert faults.current().counts()["queue.admit"] == 2  # site visits


async def _client_run(pkg, jobs, plan=None, done=None, **kw):
    """``jobs`` (``add_analysis_job`` kwargs) through one package's client
    (mock engine, ``kw`` to the client and the engine) under ``plan``
    with the ledger on, until the jobs ``done`` names (all by default)
    are submitted and every job's record is terminal; returns the
    server's and the ledger's records."""
    p = PKGS[pkg]
    if plan is not None:
        p.faults.install(plan)
    led = p.accounting.install()
    engine = kw.pop("engine", {})
    async with FakeServer() as server:
        lichess = server.lichess
        ids = [lichess.add_analysis_job(**job) for job in jobs]
        client = p.Client(endpoint=server.endpoint, key=VALID_KEY,
                          engine_factory=p.Mock(**engine),
                          logger=p.Logger(verbose=0), max_backoff=0.2, **kw)
        await client.start()
        assert client._frontend is not None
        must = ids if done is None else [ids[i] for i in done]
        deadline = time.monotonic() + 30
        while not (all(i in lichess.analyses for i in must)
                   and all(led.record(i) is not None
                           and led.record(i).terminal is not None
                           for i in ids)):
            assert time.monotonic() < deadline, led.report()
            await asyncio.sleep(0.02)
        await client.stop(abort_pending=True)
        records = {}
        for i in ids:
            rec = asdict(led.record(i))
            for key in ("acquired_at", "events"):
                rec.pop(key)
            records[i] = rec
        return dict(
            analyses={i: _comparable(b) for i, b in lichess.analyses.items()},
            counts=dict(lichess.analysis_submission_counts),
            aborted=sorted(lichess.aborted), records=records,
            report=led.assert_clean(),
            fired=(p.faults.current().counts()["queue.admit"]
                   if plan is not None else None))


async def test_admit_fault_sheds_through_the_ledger_and_aborts_as_jax():
    """An admission-layer fault degrades to an accounted shed: abandoned
    in the ledger, aborted back to the server, which hands the batch out
    again; the second admission schedules it and it is submitted once."""
    runs = {pkg: await _client_run(pkg, [dict(moves="e2e4 e7e5")],
                                   plan="queue.admit:nth=1:error", cores=1,
                                   tenants=2)
            for pkg in ("jax", "port")}
    assert runs["port"] == runs["jax"]
    (job,) = runs["port"]["records"]
    rec = runs["port"]["records"][job]
    assert runs["port"]["aborted"] == [job] and rec["acquires"] == 2
    assert rec["terminal"] == "submitted" and rec["submits"] == 1
    assert runs["port"]["fired"] == 2


async def test_requeue_generation_cap_under_concurrent_tenants_as_jax():
    """The doomed batch is abandoned after MAX_REQUEUE_GENERATIONS while
    the other tenant's stream keeps flowing (the JAX package's test)."""
    runs = {pkg: await _client_run(
        pkg, [dict(moves="e2e4 e7e5 g1f3"), dict(moves="d2d4")],
        done=[1], cores=1, tenants=2, engine=dict(fail_on="#3"))
        for pkg in ("jax", "port")}
    assert runs["port"] == runs["jax"]
    doomed, survivor = runs["port"]["records"]
    rec = runs["port"]["records"][doomed]
    assert rec["terminal"] == "abandoned" and rec["reason"] == "requeue_cap"
    assert rec["requeues"] == queue.MAX_REQUEUE_GENERATIONS
    assert doomed not in runs["port"]["analyses"]
    assert runs["port"]["records"][survivor]["terminal"] == "submitted"


async def test_deadline_flush_under_concurrent_tenants_as_jax():
    """Workers park in the front end's waiting deque when the queue is
    empty, so the acquire rounds drive ``flush_expired``: a hung
    engine's batch still flushes partially within the budget."""
    runs = {pkg: await _client_run(
        pkg, [dict(moves="e2e4 e7e5")], cores=2, tenants=2,
        batch_deadline=1.0, engine=dict(hang_on="#1"))
        for pkg in ("jax", "port")}
    assert runs["port"] == runs["jax"]
    (job,) = runs["port"]["records"]
    parts = runs["port"]["analyses"][job]["analysis"]
    assert len(parts) == 3 and parts[1] == {"skipped": True}
    assert parts[0] is not None and parts[2] is not None
    assert runs["port"]["counts"][job] == 1
    rec = runs["port"]["records"][job]
    assert rec["flushed"] and rec["terminal"] == "submitted"


async def _tenant_shutdown_case(pkg, after_shutdown: bool):
    """A batch acquired by tenant t1 on a shared lane-scheduled queue
    (the front end's state), then a hard shutdown: the abort goes back
    through t1's api, not the default one."""
    p = PKGS[pkg]
    logger = p.Logger(verbose=0)
    apis = {t: FakeApi(t) for t in ("t0", "t1")}
    led = p.accounting.install()
    rx, interrupt = asyncio.Queue(), asyncio.Event()
    state = p.queue.QueueState(
        2, p.Stats(2, no_stats_file=True), logger,
        scheduler=p.queue.LaneScheduler(), api_router=apis.get)
    stub = p.queue.QueueStub(rx, interrupt, state, apis["t0"])
    helper = p.queue.QueueActor(rx, interrupt, state, apis["t1"],
                                p.queue.BacklogOpt(), logger)
    if after_shutdown:
        state.shutdown_soon = True  # an acquire resolving after shutdown()
    await helper.handle_acquired(p.Body.from_json(ANALYSIS_ACQUIRE))
    depth = stub.depth()
    lanes = state.scheduler.depths()
    if not after_shutdown:
        stub.shutdown()
    rec = asdict(led.record("work_id"))
    rec.pop("acquired_at")
    return (rec, {t: a.aborted for t, a in apis.items()}, led.assert_clean(),
            state.incoming_len(), dict(state.pending), depth, lanes)


@pytest.mark.parametrize("after_shutdown", [False, True])
async def test_tenant_batches_abandon_through_their_tenant_as_jax(
        after_shutdown):
    port = await _tenant_shutdown_case("port", after_shutdown)
    assert port == await _tenant_shutdown_case("jax", after_shutdown)
    rec, aborted, _rep, queued, pending, depth, lanes = port
    assert rec["terminal"] == "abandoned"
    assert rec["reason"] == ("shutdown_incoming" if after_shutdown
                             else "shutdown_abort")
    assert aborted == {"t0": [], "t1": ["work_id"]}
    assert queued == 0 and not pending
    if not after_shutdown:
        assert depth == {"batches": 1, "positions": 8, "queued": 8}
        assert lanes == {LANE_LATENCY: 0, LANE_THROUGHPUT: 8}


async def test_a_job_handed_to_a_cancelled_acquire_goes_back():
    """A port-only repair of a stop-time race the JAX stub has: an acquire
    cancelled after the actor handed it a job (the stop cancels the
    tenant streams) aborts that job and abandons it in the ledger, where
    the JAX stub drops it and the server holds it."""
    led = accounting.install()
    queue_ = asyncio.Queue()
    stub = api.ApiStub(_queue=queue_, endpoint="http://fake/fishnet",
                       tenant="t1")
    task = asyncio.ensure_future(stub.acquire(slow=False))
    msg = await queue_.get()
    assert msg.kind == "acquire"
    body = AcquireResponseBody.from_json(ANALYSIS_ACQUIRE)
    led.record_acquired("work_id")
    msg.future.set_result(api.Acquired.accepted(body))
    task.cancel()  # before the stream resumes with the job
    with pytest.raises(asyncio.CancelledError):
        await task
    back = queue_.get_nowait()
    assert (back.kind, back.batch_id) == ("abort", "work_id")
    rec = led.record("work_id")
    assert rec.terminal == "abandoned" and rec.reason == "shutdown_cancelled"
    # Nothing handed over: nothing to give back.
    task = asyncio.ensure_future(stub.acquire(slow=False))
    msg = await queue_.get()
    msg.future.set_result(api.Acquired.no_content())
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    assert queue_.empty()


async def test_hard_shutdown_gives_back_finished_moves_through_their_tenant():
    """A finished move job still waiting for its submission at a hard
    shutdown is aborted through its tenant's api and abandoned (the JAX
    queue leaves it held; ROADMAP C16 covers the drain's side)."""
    led = accounting.install()
    logger = Logger(verbose=0)
    apis = {t: FakeApi(t) for t in ("t0", "t1")}
    rx, interrupt = asyncio.Queue(), asyncio.Event()
    state = queue.QueueState(2, StatsRecorder(2, no_stats_file=True), logger,
                             scheduler=LaneScheduler(), api_router=apis.get)
    stub = queue.QueueStub(rx, interrupt, state, apis["t0"])
    helper = queue.QueueActor(rx, interrupt, state, apis["t1"],
                              queue.BacklogOpt(), logger)
    await helper.handle_acquired(AcquireResponseBody.from_json(MOVE_ACQUIRE))
    taken = asyncio.get_running_loop().create_future()
    assert state.try_pull(taken)
    factory = MockEngineFactory()
    engine = await factory.create(taken.result().flavor)
    response = await engine.go(taken.result())
    stub.shutdown_soon()  # the queue stops chasing move submissions
    await stub.pull(queue.Pull(response, asyncio.get_running_loop()
                               .create_future()))
    assert len(state.move_submissions) == 1
    stub.shutdown()
    assert not state.move_submissions
    assert apis["t1"].aborted == ["work_id"] and apis["t0"].aborted == []
    rec = led.record("work_id")
    assert rec.terminal == "abandoned" and rec.reason == "shutdown_abort"
    led.assert_clean()


# -- the queue collector and /healthz --------------------------------------------


def _lane_families(pkg, monkeypatch) -> dict:
    """One package's queue collector over a lane-scheduled state, on a
    registry of its own (other tests' states may still be alive)."""
    p = PKGS[pkg]
    state = p.queue.QueueState(2, p.Stats(2, no_stats_file=True),
                               p.Logger(verbose=0),
                               scheduler=p.queue.LaneScheduler())
    for i in range(5):
        state.scheduler.push(_pos("a", i), "t0", LANE_THROUGHPUT)
    state.scheduler.push(_pos("m"), "t1", LANE_LATENCY)
    state.scheduler.note_served("t1")
    state.scheduler.note_served("t0")
    state.scheduler.note_served("t0")
    reg = type(p.queue._telemetry.REGISTRY)()
    monkeypatch.setattr(p.queue._telemetry, "REGISTRY", reg)
    p.queue._register_queue_collector(state)
    return {fam.name: sorted((tuple(sorted(s.labels.items())), s.value)
                             for s in fam.samples)
            for fam in reg.collect()}


def test_queue_collector_exports_the_lane_families_as_jax(monkeypatch):
    port = _lane_families("port", monkeypatch)
    assert port == _lane_families("jax", monkeypatch)
    assert port["fishnet_queue_incoming_positions"] == [((), 6.0)]
    assert port["fishnet_lane_depth"] == [
        ((("lane", "latency"),), 1.0), ((("lane", "throughput"),), 5.0)]
    assert port["fishnet_tenant_positions_served"] == [
        ((("tenant", "t0"),), 2.0), ((("tenant", "t1"),), 1.0)]


@pytest.fixture
def clean_health():
    saved = {}
    for name, mod in (("port", exporter), ("jax", jax_exporter)):
        with mod._HEALTH_LOCK:
            saved[name] = dict(mod._HEALTH_PROVIDERS)
            mod._HEALTH_PROVIDERS.clear()
    yield
    for name, mod in (("port", exporter), ("jax", jax_exporter)):
        with mod._HEALTH_LOCK:
            mod._HEALTH_PROVIDERS.clear()
            mod._HEALTH_PROVIDERS.update(saved[name])


def _provider_states(mod) -> list:
    out = [mod.health_snapshot()]
    mod.register_health_provider("good", lambda: {"healthy": True})
    out.append(mod.health_snapshot())
    mod.register_health_provider(
        "shedder", lambda: {"healthy": False, "shedding": True})
    out.append(mod.health_snapshot())
    mod.unregister_health_provider("shedder")
    out.append(mod.health_snapshot())
    # A provider returning None self-unregisters (collector idiom).
    mod.register_health_provider("stale", lambda: None)
    out.append(mod.health_snapshot())
    out.append("stale" in mod._HEALTH_PROVIDERS)

    def boom():
        raise RuntimeError("probe broke")

    # A raising provider reads as unhealthy, never a 500.
    mod.register_health_provider("boom", boom)
    out.append(mod.health_snapshot())
    return out


def test_healthz_provider_states_as_jax(clean_health):
    port = _provider_states(exporter)
    assert port == _provider_states(jax_exporter)
    assert [s[0] for s in port if isinstance(s, tuple)] == [
        200, 200, 503, 200, 200, 503]
    assert port[-1][1]["providers"]["boom"] == {
        "healthy": False, "error": "provider raised"}


def _frontend_health(pkg):
    p = PKGS[pkg]
    gc.collect()  # earlier tests' front ends: their breakers are live
    fe = p.frontend.FrontEnd("http://127.0.0.1:1/fishnet", "key",
                             p.Logger(verbose=0), cores=1, tenants=2)
    before = p.exporter.health_snapshot()
    fe.shed_policy.note_depth(10_000)  # saturate: hysteresis flips on
    after = p.exporter.health_snapshot()
    fe.shed_policy.note_depth(0)
    return fe, before, after


async def test_frontend_health_flips_with_shedding_as_jax(clean_health):
    fe, before, after = _frontend_health("port")
    _, ref_before, ref_after = _frontend_health("jax")
    assert (before, after) == (ref_before, ref_after)
    code, body = before
    assert code == 200
    serving = body["providers"]["serving"]
    assert serving["healthy"] is True and serving["shedding"] is False
    assert set(serving["tenants"]) == {"t0", "t1"}
    assert serving["lane_depths"] == {LANE_LATENCY: 0, LANE_THROUGHPUT: 0}
    assert after[0] == 503
    assert after[1]["providers"]["serving"]["shedding"] is True
    with pytest.raises(ValueError, match="2 tenants"):
        frontend.FrontEnd("http://127.0.0.1:1/fishnet", "key", Logger(),
                          cores=1, tenants=1)
    assert [name for name, _ in fe.api_actors()] == ["api-t0", "api-t1"]


# -- the escape hatch, the saturation run -------------------------------------


async def test_no_multitenant_env_restores_single_stream(monkeypatch):
    monkeypatch.setenv(frontend.NO_MULTITENANT_ENV, "1")
    assert frontend.multitenant_enabled(4) is False
    monkeypatch.delenv(frontend.NO_MULTITENANT_ENV)
    assert frontend.multitenant_enabled(4) is True
    assert frontend.multitenant_enabled(1) is False
    monkeypatch.setenv(frontend.NO_MULTITENANT_ENV, "1")
    with chip_smoke.FakeServer() as server:
        job = server.lichess.add_analysis_job(moves="e2e4")
        client = Client(endpoint=server.endpoint, key=VALID_KEY, cores=2,
                        engine_factory=MockEngineFactory(),
                        logger=Logger(verbose=0), max_backoff=0.2, tenants=4)
        await client.start()
        assert client._frontend is None  # classic single-stream wiring
        deadline = time.monotonic() + 10
        while job not in server.lichess.analyses:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.02)
        await client.stop()


async def _port_test_traffic(health_url=None):
    """The port's client and front end at the JAX overload smoke's
    traffic (``bench.run_overload_bench`` as ``test_overload_bench_smoke``
    calls it) through the card's harness (``chip_smoke.saturate``):
    returns the summary and the fake lichess."""
    with chip_smoke.FakeServer() as server:
        lichess = server.lichess
        lichess.auto_refill = 4 * 4 * 2
        lichess.refill_move_every = 4
        client = Client(endpoint=server.endpoint, key=VALID_KEY, cores=2,
                        engine_factory=MockEngineFactory(delay_seconds=0.02),
                        logger=Logger(verbose=0), max_backoff=0.2,
                        tenants=4, shed_policy=ShedPolicy(high_watermark=12))
        await client.start()
        summary = await chip_smoke.saturate(client, lichess, 5.0,
                                            overshoot=8,
                                            health_url=health_url)
    return summary, lichess


async def test_overload_saturation_smoke():
    """The JAX package's ``test_overload_bench_smoke`` on the port: 4
    tenants against a saturating server (32 unacquired jobs, every 4th a
    move job), mock engine at 20 ms, high watermark 12, for 5 s, as in
    the JAX test — analysis sheds at the watermark, the queue stays
    bounded, the best-move p99 within 10 s, the ledger exactly-once
    throughout; with the card's gates on top
    (``chip_smoke.overload_gates``): the server holds no job, every move
    job handed out is answered unless the stop cut it, and ``/healthz``
    answers 503 while the policy sheds. The JAX test also gates the
    served counts' max/min at 2.0; both front ends pass 2.0 in some runs
    at this traffic (``_fairness_main``), so the ratio is not gated
    here (ROADMAP C18)."""
    led = accounting.install()
    exp = telemetry.start_exporter(0)
    try:
        summary, lichess = await _port_test_traffic(f"{exp.url}/healthz")
        chip_smoke.overload_gates(summary, lichess, "saturation")
    finally:
        exp.close()
        telemetry.disable()
    assert summary["ledger"]["lost"] == [] == summary["ledger"]["duplicated"]
    assert summary["queue"]["bounded"] is True
    assert summary["queue"]["depth_bound"] == 12 + 4 * 8
    assert summary["latency"]["move_p99_ms"] <= 10_000.0
    assert summary["shedding"]["shed_total"] >= 1
    assert summary["health_while_shedding"][0] == 503
    assert summary["moves"]["answered"] >= 1
    # Every shed is in the ledger (the batch went back to the server).
    sheds = sum(led.record(i).events.count("abandoned:shed")
                for i in lichess.handed_at if led.record(i) is not None)
    assert sheds == summary["shedding"]["shed_total"]


# -- tpu-nnue at two tenants ----------------------------------------------------

KW = dict(pool_slots=16, batch_capacity=64, tt_bytes=16 << 20)
NNUE_JOBS = [
    dict(moves="e2e4 c7c5 g1f3 d7d6 d2d4 c5d4", skip_positions=[2], nodes=150),
    dict(moves="d2d4 g8f6 c2c4", multipv=3, nodes=100),
]


async def _nnue_run(client_cls, factory, logger):
    """NNUE_JOBS through a two-tenant client, each queued on the server
    only once the one before it is submitted."""
    async with FakeServer() as server:
        lichess = server.lichess
        client = client_cls(endpoint=server.endpoint, key=VALID_KEY, cores=1,
                            workers=1, engine_factory=factory, logger=logger,
                            max_backoff=0.2, tenants=2)
        await client.start()
        assert client._frontend is not None
        ids = []
        try:
            for job in NNUE_JOBS:
                ids.append(lichess.add_analysis_job(**job))
                deadline = time.monotonic() + 600
                while ids[-1] not in lichess.analyses:
                    assert time.monotonic() < deadline, "timed out"
                    await asyncio.sleep(0.02)
        finally:
            await client.stop()
        return [lichess.analyses[i] for i in ids]


def test_tpu_nnue_at_two_tenants_submits_the_jax_clients_analyses(
        monkeypatch):
    for hatch in ("FISHNET_NO_COALESCE", "FISHNET_NO_EVAL_CACHE",
                  "FISHNET_NO_BOUNDS"):
        monkeypatch.setenv(hatch, "1")
    for module in ("fishnet_tpu.client", "fishnet_tpu_torch.client"):
        monkeypatch.setattr(f"{module}.DEFAULT_BUDGET_SECONDS", 3600.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    eval_cache.reset_cache()
    ref_svc = JaxService(weights=JaxWeights.random(seed=31), **KW)
    port_svc = SearchService(weights=NnueWeights.random(seed=31),
                             device="cpu", **KW)
    try:
        for svc in (ref_svc, port_svc):
            svc.set_prefetch(8, adaptive=False)
        ref = asyncio.run(_nnue_run(JaxClient, JaxFactory(ref_svc),
                                    JaxLogger()))
        port = asyncio.run(_nnue_run(Client, TpuNnueEngineFactory(port_svc),
                                     Logger()))
    finally:
        ref_svc.close()
        port_svc.close()
        torch.set_num_threads(threads)
        eval_cache.reset_cache()
    assert [_comparable(b) for b in port] == [_comparable(b) for b in ref]
    skip, matrix = port
    assert skip["analysis"][2] == {"skipped": True}
    assert all(isinstance(p["score"], list) and len(p["score"]) == 3
               for p in matrix["analysis"])


# -- the flags and the CLI ------------------------------------------------------

TENANT_ARGVS = {
    "bare": [],
    "tenants": ["--tenants", "4"],
    "both": ["--tenants", "2", "--lane-depth-limit", "64"],
    "one": ["--tenants", "1", "--lane-depth-limit", "1"],
}


def _tenant_flags(opt):
    return opt.tenants, opt.resolved_tenants(), opt.lane_depth_limit


@pytest.mark.parametrize("name", sorted(TENANT_ARGVS))
def test_tenant_flags_resolve_as_in_the_jax_cli(name):
    argv = ["run", "--no-conf", *TENANT_ARGVS[name]]
    port = configure.parse_and_configure(argv)
    ref = jax_configure.parse_and_configure(argv, write=False)
    assert _tenant_flags(port) == _tenant_flags(ref)
    if name == "bare":
        assert _tenant_flags(port) == (None, 1, None)


def test_tenant_ini_keys_merge_under_the_command_line(tmp_path):
    ini = tmp_path / "fishnet.ini"
    ini.write_text("[Fishnet]\nKey = k\nTenants = 3\nLaneDepthLimit = 100\n")
    for argv in (["run", "--conf", str(ini)],
                 ["run", "--conf", str(ini), "--tenants", "5",
                  "--lane-depth-limit", "7"]):
        port = configure.parse_and_configure(argv)
        ref = jax_configure.parse_and_configure(argv, write=False)
        assert _tenant_flags(port) == _tenant_flags(ref)
    assert _tenant_flags(configure.parse_and_configure(
        ["run", "--conf", str(ini)])) == (3, 3, 100)
    assert _tenant_flags(port) == (5, 5, 7)
    ini.write_text("[Fishnet]\nTenants = 0\n")
    with pytest.raises(configure.ConfigError) as err:
        configure.parse_and_configure(["run", "--conf", str(ini)])
    with pytest.raises(jax_configure.ConfigError) as ref_err:
        jax_configure.parse_and_configure(["run", "--conf", str(ini)],
                                          write=False)
    assert str(err.value) == str(ref_err.value) == "Tenants must be >= 1"


@pytest.mark.parametrize("argv", [
    ["--tenants", "0"],
    ["--lane-depth-limit", "0"],
    ["--tenants", "-2"],
    ["--lane-depth-limit", "-1", "--tenants", "3"],
])
def test_bad_tenant_values_are_refused_as_in_the_jax_cli(argv):
    argv = ["run", "--no-conf", *argv]
    with pytest.raises(configure.ConfigError) as port:
        configure.parse_and_configure(argv)
    with pytest.raises(jax_configure.ConfigError) as ref:
        jax_configure.parse_and_configure(argv, write=False)
    assert str(port.value) == str(ref.value)


def test_run_with_two_tenants_submits_and_exits_zero_on_sigint(tmp_path):
    """``python -m fishnet_tpu_torch run --tenants 2 --device cpu`` (the
    tpu-nnue engine on the CPU's plain path) against the stdlib fake
    lichess: it submits its job through the front end, and SIGINT
    drains it to exit 0."""
    with chip_smoke.FakeServer() as server:
        job = server.lichess.add_analysis_job(moves="e2e4 e7e5", nodes=100)
        log_path = tmp_path / "run.log"
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "fishnet_tpu_torch", "run",
                 "--device", "cpu", "--no-conf", "--no-stats-file",
                 "--endpoint", server.endpoint, "--key", VALID_KEY,
                 "--cores", "1", "--microbatch", "64", "--max-backoff", "1",
                 "--tenants", "2", "--lane-depth-limit", "64", "-v"],
                cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT,
                env=dict(os.environ, OMP_NUM_THREADS="1"))
        try:
            deadline = time.monotonic() + 120
            while job not in server.lichess.analyses:
                assert proc.poll() is None, log_path.read_text()[-3000:]
                assert time.monotonic() < deadline, "no submission"
                time.sleep(0.05)
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log = log_path.read_text()
    assert rc == 0, log[-3000:]
    assert "Front end started (2 tenants)." in log
    parts = server.lichess.analyses[job]["analysis"]
    assert len(parts) == 3 and all("score" in p for p in parts)
    assert server.lichess.submissions == {job: 1}


# -- fairness at the card's traffic, both front ends (a script) ---------------

#: The card's saturation leg (chip_smoke.overload_saturation) on the mock
#: engine: 4 tenants, 32 unacquired jobs kept queued, every 4th a move
#: job, the rest games of 40 plies, watermark 256, 30 s; 224 workers at
#: 6 s a position serve ~37 positions/s, the card's rate at 1500 nodes.
CARD_TRAFFIC = dict(tenants=4, refill=32, move_every=4, plies=40, high=256,
                    seconds=30.0, workers=224, delay=6.0)


async def _card_traffic_run(pkg, games, t=CARD_TRAFFIC) -> dict:
    """One package's client and front end under ``CARD_TRAFFIC`` against
    the stdlib fake lichess, through the card's harness
    (``chip_smoke.saturate``); per tenant the positions served, the
    analysis positions admitted and the move jobs admitted."""
    p = PKGS[pkg]
    with chip_smoke.FakeServer() as server:
        lichess = server.lichess
        lichess.auto_refill = t["refill"]
        lichess.refill_move_every = t["move_every"]
        lichess.refill_analysis = lambda n: dict(
            moves=" ".join(games[n % len(games)]), nodes=1500)
        client = p.Client(endpoint=server.endpoint, key=VALID_KEY, cores=7,
                          workers=t["workers"],
                          engine_factory=p.Mock(delay_seconds=t["delay"]),
                          logger=p.Logger(verbose=0), max_backoff=1.0,
                          tenants=t["tenants"],
                          shed_policy=p.shedding.ShedPolicy(
                              high_watermark=t["high"]))
        await client.start()
        fe = client._frontend
        admitted = {name: [0, 0] for name in fe.tenants}
        admit = fe._admit

        async def counted(ts, body):
            before = ts.acquired
            await admit(ts, body)
            if ts.acquired > before:
                moves = body.work.is_move
                admitted[ts.name][moves] += 1 if moves else len(body.moves) + 1

        fe._admit = counted
        summary = await chip_smoke.saturate(client, lichess, t["seconds"],
                                            overshoot=t["plies"] + 1)
    return dict(package=pkg, ratio=summary["fairness"]["ratio"],
                served=summary["fairness"]["served_by_tenant"],
                analysis_positions_admitted={n: a for n, (a, _) in
                                             admitted.items()},
                moves_admitted={n: m for n, (_, m) in admitted.items()},
                shed=summary["shedding"]["shed_total"],
                activations=summary["shedding"]["activations"])


def _test_traffic_run(pkg) -> dict:
    """One package's front end at the JAX overload smoke's traffic: the
    JAX package through its own ``bench.run_overload_bench``, the port
    through ``_port_test_traffic``."""
    if pkg == "jax":
        import bench

        summary = bench.run_overload_bench(
            seconds=5.0, tenants=4, saturation=4, high_watermark=12,
            cores=2, move_p99_budget_ms=10_000.0)
    else:
        summary = asyncio.run(_port_test_traffic())[0]
    return dict(package=pkg, ratio=summary["fairness"]["ratio"],
                served=summary["fairness"]["served_by_tenant"])


def _fairness_main(argv) -> None:
    """``python -m tests.test_torch_overload [--traffic card|test]
    [--runs N]``: N runs of each package's front end, alternating, one
    JSON line a run, then each package's served max/min ratios. ``card``
    is ``CARD_TRAFFIC`` (~1 minute a pair); ``test`` the traffic of the
    JAX overload smoke and ``test_overload_saturation_smoke`` (~12 s a
    pair). The clients' warnings go to stdout too: read the lines that
    start with ``{``."""
    import argparse
    import json

    args = argparse.ArgumentParser(description=_fairness_main.__doc__)
    args.add_argument("--traffic", choices=("card", "test"), default="card")
    args.add_argument("--runs", type=int, default=10)
    opts = args.parse_args(argv)
    from fishnet_tpu_torch.chess.core import load as load_core

    load_core()
    games = chip_smoke.random_games(64, CARD_TRAFFIC["plies"], seed=53)
    ratios = {"jax": [], "port": []}
    for _ in range(opts.runs):
        for pkg in ("jax", "port"):
            out = (asyncio.run(_card_traffic_run(pkg, games))
                   if opts.traffic == "card" else _test_traffic_run(pkg))
            ratios[pkg].append(out["ratio"])
            print(json.dumps(out), flush=True)
    print(json.dumps({"traffic": opts.traffic, "ratios": ratios}))


if __name__ == "__main__":
    _fairness_main(sys.argv[1:])
