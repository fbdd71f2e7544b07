"""The port's fault plane, batch ledger and graceful drain
(fishnet_tpu_torch.resilience) against the JAX package's
(fishnet_tpu.resilience), on the CPU.

The same plan specs parse to the same rules and fail with the same
errors; the same seeded plans fire on the same calls; the same ledger
event sequences give the same reports. The port's client and the JAX
client run the same jobs on ``tests/fake_server.py`` under the same
plan, each with its package's mock engine (identical, deterministic
answers) and its package's ledger installed: the submitted bodies (less
their wall-clock and version fields) and every batch's ledger record
must be equal. The queue's shutdown accounting, the drain's readiness
view and a SIGTERM'd ``python -m fishnet_tpu_torch run`` subprocess
follow the JAX package's tests (tests/test_overload.py,
tests/test_cluster.py). Everything compared here is exact: no
tolerance."""

import asyncio
import copy
import json
import os
import signal
import sys
import time
import urllib.error
import urllib.request
from dataclasses import asdict
from pathlib import Path

import pytest

from fishnet_tpu import configure as jax_configure
from fishnet_tpu.client import Client as JaxClient
from fishnet_tpu.engine.mock import MockEngineFactory as JaxMock
from fishnet_tpu.net import api as jax_api
from fishnet_tpu.protocol.types import AcquireResponseBody as JaxBody
from fishnet_tpu.protocol.types import EngineFlavor as JaxFlavor
from fishnet_tpu.resilience import accounting as jax_accounting
from fishnet_tpu.resilience import faults as jax_faults
from fishnet_tpu.sched import queue as jax_queue
from fishnet_tpu.utils.logger import Logger as JaxLogger
from fishnet_tpu.utils.stats import StatsRecorder as JaxStats
from fishnet_tpu_torch import configure, telemetry
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.engine.mock import MockEngineFactory
from fishnet_tpu_torch.net import api
from fishnet_tpu_torch.protocol.types import AcquireResponseBody, EngineFlavor
from fishnet_tpu_torch.resilience import accounting, drain, faults
from fishnet_tpu_torch.resilience.accounting import (
    BatchLedger,
    LedgerViolation,
)
from fishnet_tpu_torch.resilience.faults import (
    FaultCrash,
    FaultInjected,
    FaultPlan,
    FaultPlanError,
)
from fishnet_tpu_torch.resilience.supervisor import _BREAKER_STATE
from fishnet_tpu_torch.sched import queue
from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.utils.stats import StatsRecorder
from tests.fake_server import VALID_KEY, FakeLichess, FakeServer
from tests.test_protocol import ANALYSIS_ACQUIRE, MOVE_ACQUIRE

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.anyio


@pytest.fixture(autouse=True)
def _clean_resilience_state():
    yield
    for pkg in (faults, accounting, jax_faults, jax_accounting):
        pkg.clear()
    drain.reset()


# -- the fault plane ---------------------------------------------------------


def _rules(plan):
    return plan.seed, {site: [asdict(r) for r in rules]
                       for site, rules in plan.rules.items()}


def test_fault_plan_parses_as_the_jax_plan():
    spec = ("seed=42; net.acquire:nth=2..3:error; net.submit:every=4:latency=0.5;"
            "service.device_step:p=0.25:crash; engine.spawn:nth=1:hang=2;"
            "rpc.detach:nth=3:error; proc.kill:every=2:crash")
    plan = FaultPlan.parse(spec)
    assert _rules(plan) == _rules(jax_faults.FaultPlan.parse(spec))
    assert plan.seed == 42
    assert plan.rules["net.acquire"][0].lo == 2
    assert plan.rules["net.acquire"][0].hi == 3
    assert plan.rules["engine.spawn"][0].action == "hang"
    assert faults.SITES == jax_faults.SITES
    assert faults.ACTIONS == jax_faults.ACTIONS


@pytest.mark.parametrize("bad", [
    "nosuch.site:nth=1:error",
    "net.acquire:nth=0:error",
    "net.acquire:nth=3..2:error",
    "net.acquire:wat=1:error",
    "net.acquire:nth=1:explode",
    "net.acquire:p=1.5:error",
    "net.acquire:nth=1",
    "seed=banana",
    "net.acquire:nth=1:latency=-1",
])
def test_bad_specs_fail_as_in_the_jax_plane(bad):
    with pytest.raises(FaultPlanError) as port:
        FaultPlan.parse(bad)
    with pytest.raises(jax_faults.FaultPlanError) as ref:
        jax_faults.FaultPlan.parse(bad)
    assert str(port.value) == str(ref.value)


#: Plans polled on interleaved sites: nth, ranges, every, and seeded p
#: (one RNG per plan, drawn in poll order across sites).
TRIGGER_PLANS = [
    "net.acquire:nth=3:error",
    "net.acquire:nth=2..5:crash;net.submit:every=3:latency=0",
    "seed=7;queue.schedule:p=0.5:error",
    "seed=8;queue.schedule:p=0.5:error",
    "seed=11;net.acquire:p=0.3:error;net.submit:p=0.6:crash;"
    "service.device_step:every=4:error",
]


@pytest.mark.parametrize("spec", TRIGGER_PLANS)
def test_triggers_fire_on_the_same_calls_as_the_jax_plane(spec):
    sites = ["net.acquire", "net.submit", "queue.schedule",
             "service.device_step"]

    def decisions(mod):
        plan = mod.FaultPlan.parse(spec)
        out = []
        for i in range(64):
            rule = plan.poll(sites[(i * 7) % len(sites)])
            out.append(None if rule is None else (rule.site, rule.action))
        return out, plan.counts()

    port = decisions(faults)
    assert port == decisions(jax_faults)
    assert any(d is not None for d in port[0])


def test_a_seed_chooses_the_calls():
    def fired(seed):
        plan = FaultPlan.parse(f"seed={seed};queue.schedule:p=0.5:error")
        return [plan.poll("queue.schedule") is not None for _ in range(32)]

    assert fired(7) == fired(7) and fired(7) != fired(8)


def test_nth_trigger_actions_and_the_counter():
    before = faults._INJECTED.value(site="net.acquire", action="error")
    faults.install("net.acquire:nth=3:error")
    faults.fire("net.acquire")
    faults.fire("net.acquire")
    with pytest.raises(FaultInjected) as err:
        faults.fire("net.acquire")
    assert err.value.site == "net.acquire" and err.value.action == "error"
    faults.fire("net.acquire")  # past the window: clean again
    assert faults.current().counts()["net.acquire"] == 4
    assert faults._INJECTED.value(site="net.acquire",
                                  action="error") == before + 1
    text = telemetry.REGISTRY.render_prometheus()
    assert ('fishnet_faults_injected_total{action="error",'
            'site="net.acquire"}') in text

    faults.install("net.submit:nth=1:latency=0.05;net.submit:nth=2:hang=0.05;"
                   "net.submit:nth=3:crash")
    t0 = time.monotonic()
    faults.fire("net.submit")  # latency: sleeps, proceeds
    assert time.monotonic() - t0 >= 0.05
    with pytest.raises(FaultInjected):
        faults.fire("net.submit")  # hang: sleeps, then raises
    with pytest.raises(FaultCrash):
        faults.fire("net.submit")
    assert issubclass(FaultCrash, FaultInjected)
    assert not issubclass(FaultInjected, jax_faults.FaultInjected)


async def test_fire_async_and_an_inert_plane(monkeypatch):
    assert not faults.enabled() and faults.current() is None
    faults.fire("net.acquire")  # no plan: a no-op
    await faults.fire_async("net.acquire")
    faults.install("net.acquire:nth=1:error;net.submit:nth=1:latency=0.05")
    with pytest.raises(FaultInjected):
        await faults.fire_async("net.acquire")
    t0 = time.monotonic()
    await faults.fire_async("net.submit")
    assert time.monotonic() - t0 >= 0.05
    faults.clear()
    assert not faults.enabled()
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    assert faults.install_from_env() is None and not faults.enabled()
    plan = faults.install_from_env({faults.PLAN_ENV: "rpc.detach:nth=2:error"})
    assert faults.current() is plan and plan.rules["rpc.detach"][0].lo == 2


# -- the batch ledger ----------------------------------------------------------

#: Ledger event sequences: (method, batch id, *args).
LEDGER_SEQUENCES = {
    "clean-lifecycle": [
        ("acquired", "b1"), ("scheduled", "b1"), ("stepped", "b1"),
        ("stepped", "b1"), ("requeued", "b1", 1), ("submitted", "b1")],
    "lost-and-duplicated": [
        ("acquired", "lost1"), ("acquired", "dup1"), ("submitted", "dup1"),
        ("submitted", "dup1"), ("acquired", "ok"), ("invalid", "ok", "bad"),
        ("acquired", "fl"), ("flushed", "fl"), ("submitted", "fl")],
    "reacquire-after-abandon": [
        ("acquired", "b1"), ("scheduled", "b1"),
        ("abandoned", "b1", "requeue_cap"), ("acquired", "b1"),
        ("submitted", "b1"), ("abandoned", "b1", "late")],
}


def _replay(ledger, events):
    for method, batch, *args in events:
        getattr(ledger, f"record_{method}")(batch, *args)
    rep = ledger.report()
    recs = {}
    for batch in sorted({e[1] for e in events}):
        rec = asdict(ledger.record(batch))
        rec.pop("acquired_at")
        recs[batch] = rec
    return rep, recs


@pytest.mark.parametrize("name", sorted(LEDGER_SEQUENCES))
def test_ledger_reports_as_the_jax_ledger(name):
    events = LEDGER_SEQUENCES[name]
    port = _replay(BatchLedger(), events)
    assert port == _replay(jax_accounting.BatchLedger(), events)


def test_ledger_flags_lost_and_duplicated_batches():
    led = BatchLedger()
    led.record_acquired("lost1")
    with pytest.raises(LedgerViolation):
        led.assert_clean()
    led.record_abandoned("lost1", "test")
    assert led.assert_clean()["abandoned"] == 1
    led.record_acquired("dup1")
    led.record_submitted("dup1")
    led.record_submitted("dup1")
    with pytest.raises(LedgerViolation):
        led.assert_clean()
    assert led.report()["duplicated"] == ["dup1"]
    # A reacquire after abandon is a fresh lifecycle.
    led = BatchLedger()
    led.record_acquired("b1")
    led.record_abandoned("b1", "requeue_cap")
    led.record_acquired("b1")
    led.record_submitted("b1")
    assert led.assert_clean()["submitted"] == 1
    assert not accounting.enabled() and accounting.get() is None
    installed = accounting.install()
    assert accounting.enabled() and accounting.get() is installed
    accounting.clear()
    assert accounting.get() is None


# -- the client under faults, both packages ----------------------------------

#: name -> (plan, jobs, client kwargs, mock engine kwargs, server knobs).
#: Every scenario runs one worker unless it needs two (the deadline
#: flush: one worker hangs; the breaker: two finals in flight).
SCENARIOS = {
    "acquire-faults": dict(
        plan="net.acquire:nth=1..2:error", jobs=[dict(moves="e2e4")]),
    "spawn-fault-requeues-in-acquire-order": dict(
        plan="engine.spawn:nth=1:error",
        jobs=[dict(moves="e2e4"), dict(moves="d2d4")]),
    "requeue-cap-abandons": dict(
        jobs=[dict(moves="e2e4 e7e5 g1f3"), dict(moves="d2d4")],
        engine=dict(fail_on="#3"), done=[1]),
    "deadline-flush": dict(
        jobs=[dict(moves="e2e4 e7e5")], engine=dict(hang_on="#1"),
        client=dict(cores=2, batch_deadline=1.0), abort=True),
    "submit-failures-open-the-breaker": dict(
        jobs=[dict(moves=m) for m in ("e2e4", "d2d4", "g1f3")],
        server=dict(fail_submits=2), client=dict(cores=2), breaker=True),
    "schedule-fault-drops-a-batch-as-invalid": dict(
        plan="queue.schedule:nth=1:error",
        jobs=[dict(moves="e2e4"), dict(moves="d2d4")], done=[1]),
    "submit-fault-is-retried": dict(
        plan="seed=3;net.submit:nth=1:error;net.acquire:p=0.3:error",
        jobs=[dict(moves="e2e4 e7e5"), dict(moves="c2c4")]),
    "move-submit-fault-is-retried": dict(
        plan="net.submit:nth=1:error", jobs=[dict(moves="e2e4")],
        moves=[dict(moves="e2e4", level=5)]),
}


def _comparable(body):
    body = copy.deepcopy(body)
    body["fishnet"].pop("version")
    for part in body.get("analysis", []):
        if isinstance(part, dict):
            part.pop("time", None)
            part.pop("nps", None)
    return body


async def _client_run(name, port, monkeypatch):
    """One scenario through one package's client; returns the server's
    records and the ledger's."""
    sc = SCENARIOS[name]
    fmod, amod = (faults, accounting) if port else (jax_faults, jax_accounting)
    if sc.get("breaker"):
        if port:
            monkeypatch.setattr(api, "BREAKER_THRESHOLD", 2)
            monkeypatch.setattr(api, "BREAKER_COOLDOWN_SECONDS", 0.3)
        else:
            monkeypatch.setenv(jax_api.BREAKER_THRESHOLD_ENV, "2")
            monkeypatch.setenv(jax_api.BREAKER_COOLDOWN_ENV, "0.3")
    plan = fmod.install(sc["plan"]) if "plan" in sc else None
    led = amod.install()
    cls, mock, logger = ((Client, MockEngineFactory, Logger) if port
                         else (JaxClient, JaxMock, JaxLogger))
    kw = {"cores": 1, **sc.get("client", {})}
    try:
        async with FakeServer() as server:
            lichess = server.lichess
            for knob, value in sc.get("server", {}).items():
                setattr(lichess, knob, value)
            ids = [lichess.add_analysis_job(**job) for job in sc["jobs"]]
            move_ids = [lichess.add_move_job(**job)
                        for job in sc.get("moves", [])]
            client = cls(endpoint=server.endpoint, key=VALID_KEY,
                         engine_factory=mock(**sc.get("engine", {})),
                         logger=logger(verbose=0), max_backoff=0.2, **kw)
            await client.start()
            must = [ids[i] for i in sc.get("done", range(len(ids)))]
            deadline = time.monotonic() + 60
            while not (all(i in lichess.analyses for i in must)
                       and all(m in lichess.moves for m in move_ids)
                       and all(led.record(i) is not None
                               and led.record(i).terminal is not None
                               for i in ids + move_ids)):
                assert time.monotonic() < deadline, (name, led.report())
                await asyncio.sleep(0.02)
            await client.stop(abort_pending=sc.get("abort", False))
            records = {}
            for i in ids + move_ids:
                rec = asdict(led.record(i))
                rec.pop("acquired_at")
                records[i] = rec
            return dict(
                analyses={i: _comparable(b)
                          for i, b in lichess.analyses.items()},
                moves={i: _comparable(b) for i, b in lichess.moves.items()},
                order=list(lichess.analyses),
                counts=dict(lichess.analysis_submission_counts),
                aborted=sorted(lichess.aborted),
                report=led.assert_clean(), records=records,
                fired=plan.counts() if plan is not None else None)
    finally:
        fmod.clear()
        amod.clear()


@pytest.mark.parametrize("name", list(SCENARIOS))
async def test_client_under_a_plan_submits_and_accounts_as_the_jax_client(
        name, monkeypatch):
    base_requeued = queue._REQUEUED.value()
    ref = await _client_run(name, False, monkeypatch)
    port = await _client_run(name, True, monkeypatch)
    # Acquires are counted per call: a run may poll the server for more
    # work a different number of times. With two workers the order of
    # the submissions is the scheduler's.
    fired = port.pop("fired")
    ref.pop("fired")
    for run in (ref, port):
        if SCENARIOS[name].get("client", {}).get("cores", 1) > 1:
            run.pop("order")
    assert port == ref
    assert all(n == 1 for n in port["counts"].values())
    ids = list(port["records"])
    if name == "acquire-faults":
        # The two faulted acquires, then the one that got the job; no
        # device site on the mock engine.
        assert fired["net.acquire"] >= 3 and fired["net.submit"] >= 1
        assert fired["service.device_step"] == 0
        assert port["records"][ids[0]]["terminal"] == "submitted"
    elif name == "spawn-fault-requeues-in-acquire-order":
        assert port["order"] == ids  # the failed position went first
        assert queue._REQUEUED.value() > base_requeued
        assert port["report"]["requeues"] >= 1
    elif name == "requeue-cap-abandons":
        doomed = port["records"][ids[0]]
        assert doomed["terminal"] == "abandoned"
        assert doomed["reason"] == "requeue_cap"
        assert doomed["requeues"] == queue.MAX_REQUEUE_GENERATIONS
        assert ids[0] not in port["analyses"] and not port["aborted"]
    elif name == "deadline-flush":
        rec = port["records"][ids[0]]
        assert rec["flushed"] and rec["terminal"] == "submitted"
        parts = port["analyses"][ids[0]]["analysis"]
        assert parts[1] == {"skipped": True} and parts[0] and parts[2]
    elif name == "submit-failures-open-the-breaker":
        assert _BREAKER_STATE.labels(endpoint="submit").value == 0
    elif name == "schedule-fault-drops-a-batch-as-invalid":
        assert port["records"][ids[0]]["terminal"] == "invalid"
        assert ids[0] not in port["analyses"]
    else:
        assert all(r["terminal"] == "submitted"
                   for r in port["records"].values())


# -- the queue's shutdown accounting -------------------------------------------


class FakeApi:
    """The slice of ApiStub the queue side calls."""

    def __init__(self) -> None:
        self.endpoint = "http://fake/fishnet"
        self.tenant = ""
        self.aborted = []
        self.submitted = []

    def abort(self, batch_id: str) -> None:
        self.aborted.append(batch_id)

    def submit_analysis(self, batch_id, flavor, analysis, final=True) -> None:
        self.submitted.append(batch_id)

    async def submit_move_and_acquire(self, batch_id, best_move):
        self.submitted.append(batch_id)


async def _shutdown_case(port: bool, after_shutdown: bool):
    mod, amod, body_cls = ((queue, accounting, AcquireResponseBody) if port
                           else (jax_queue, jax_accounting, JaxBody))
    logger = (Logger if port else JaxLogger)(verbose=0)
    stats = (StatsRecorder if port else JaxStats)(2, no_stats_file=True)
    led = amod.install()
    try:
        fake = FakeApi()
        rx, interrupt = asyncio.Queue(), asyncio.Event()
        state = mod.QueueState(2, stats, logger)
        stub = mod.QueueStub(rx, interrupt, state, fake)
        actor = mod.QueueActor(rx, interrupt, state, fake, mod.BacklogOpt(),
                               logger)
        if after_shutdown:
            # An in-flight acquire that resolves after shutdown().
            state.shutdown_soon = True
        await actor.handle_acquired(body_cls.from_json(ANALYSIS_ACQUIRE))
        depth = stub.depth()
        if not after_shutdown:
            stub.shutdown()
        rec = asdict(led.record("work_id"))
        rec.pop("acquired_at")
        return (rec, fake.aborted, led.assert_clean(), state.incoming_len(),
                dict(state.pending), depth)
    finally:
        amod.clear()


@pytest.mark.parametrize("after_shutdown", [False, True])
async def test_shutdown_abandons_through_the_ledger_as_jax(after_shutdown):
    port = await _shutdown_case(True, after_shutdown)
    assert port == await _shutdown_case(False, after_shutdown)
    rec, aborted, _rep, queued, pending, depth = port
    assert rec["terminal"] == "abandoned" and aborted == ["work_id"]
    assert rec["reason"] == ("shutdown_incoming" if after_shutdown
                             else "shutdown_abort")
    assert queued == 0 and not pending
    if not after_shutdown:
        # 11 plies, 3 skipped: 8 positions queued for the workers.
        assert depth == {"batches": 1, "positions": 8, "queued": 8}


async def _move_during_drain_case(port: bool):
    """A move job taken before ``shutdown_soon`` (SIGTERM) whose search
    ends after it, through the queue as the workers drive it; the state
    after the drain, then after a hard ``shutdown()``."""
    mod, amod, body_cls = ((queue, accounting, AcquireResponseBody) if port
                           else (jax_queue, jax_accounting, JaxBody))
    logger = (Logger if port else JaxLogger)(verbose=0)
    stats = (StatsRecorder if port else JaxStats)(2, no_stats_file=True)
    factory = (MockEngineFactory if port else JaxMock)()
    engine = await factory.create(EngineFlavor.OFFICIAL if port
                                  else JaxFlavor.OFFICIAL)
    led = amod.install()
    try:
        fake = FakeApi()
        rx, interrupt = asyncio.Queue(), asyncio.Event()
        state = mod.QueueState(2, stats, logger)
        stub = mod.QueueStub(rx, interrupt, state, fake)
        actor = mod.QueueActor(rx, interrupt, state, fake, mod.BacklogOpt(),
                               logger)
        await actor.handle_acquired(body_cls.from_json(MOVE_ACQUIRE))
        loop = asyncio.get_running_loop()
        taken = loop.create_future()
        await stub.pull(mod.Pull(None, taken))
        stub.shutdown_soon()
        response = await engine.go(taken.result())
        released = loop.create_future()
        await stub.pull(mod.Pull(response, released))
        await actor.handle_move_submissions()

        def snapshot():
            rec = asdict(led.record("work_id"))
            rec.pop("acquired_at")
            return (rec, led.report(), list(fake.aborted),
                    list(fake.submitted), len(state.move_submissions),
                    released.cancelled())

        drained = snapshot()
        stub.shutdown()
        return drained, snapshot()
    finally:
        amod.clear()
        await engine.close()


async def test_a_move_job_finished_during_a_drain_is_held_as_in_jax():
    """ROADMAP C16, the known gap: once ``shutdown_soon`` runs, the queue
    stops chasing move submissions, so a move job whose search ends
    during the drain is neither submitted nor aborted by the drain; the
    ledger reads it as lost. Both packages do the same. Fixing C16 flips
    this test: it must then be brought up to the fix (submitted, or
    aborted), in both packages or with the divergence stated."""
    port_drained, _ = await _move_during_drain_case(True)
    ref_drained, _ = await _move_during_drain_case(False)
    assert port_drained == ref_drained
    rec, report, aborted, submitted, held, released = port_drained
    assert rec["terminal"] is None and rec["scheduled"] and rec["stepped"]
    assert report["lost"] == ["work_id"] and report["submitted"] == 0
    assert aborted == [] and submitted == []
    assert held == 1 and released


async def test_a_hard_shutdown_after_a_drain_gives_back_the_finished_move():
    """The hard ``shutdown()`` after the drain above, where the packages
    differ (ROADMAP C19): the JAX package's queue leaves the finished
    move held and lost until the server's timeout; the port aborts it
    back to the server (abandoned, ``shutdown_abort``)."""
    _, port_shut = await _move_during_drain_case(True)
    _, ref_shut = await _move_during_drain_case(False)
    rec, report, aborted, submitted, held, _ = ref_shut
    assert rec["terminal"] is None and report["lost"] == ["work_id"]
    assert aborted == [] and held == 1
    rec, report, aborted, submitted, held, _ = port_shut
    assert rec["terminal"] == "abandoned" and rec["reason"] == "shutdown_abort"
    assert report["lost"] == [] and aborted == ["work_id"]
    assert submitted == [] and held == 0


# -- drain: readiness, not liveness --------------------------------------------


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_drain_flips_readiness_not_liveness():
    exporter = telemetry.start_exporter(0)
    try:
        base = f"http://127.0.0.1:{exporter.port}"
        assert _get(f"{base}/healthz") == (200, b"ok\n")
        assert _get(f"{base}/healthz/ready") == (200, b"ok\n")
        assert _get(f"{base}/healthz/live") == (200, b"ok\n")
        assert "fishnet_drain_state 0" in _get(f"{base}/metrics")[1].decode()
        assert not drain.draining()

        assert drain.begin("sigterm", deadline=25.0,
                           depth_fn=lambda: {"batches": 2}) is True
        assert drain.begin("sigterm") is False  # idempotent
        assert drain.draining()

        status, body = _get(f"{base}/healthz")
        assert status == 503
        payload = json.loads(body)["providers"]["drain"]
        assert payload["draining"] is True and payload["healthy"] is False
        assert payload["reason"] == "sigterm"
        assert payload["deadline_s"] == 25.0
        assert payload["pending"] == {"batches": 2}
        assert payload["draining_for_s"] >= 0
        assert _get(f"{base}/healthz/ready")[0] == 503
        assert _get(f"{base}/healthz/live") == (200, b"ok\n")
        assert "fishnet_drain_state 1" in _get(f"{base}/metrics")[1].decode()

        drain.reset()
        assert _get(f"{base}/healthz") == (200, b"ok\n")
        assert "fishnet_drain_state 0" in _get(f"{base}/metrics")[1].decode()
        # A broken depth probe must not 500 the readiness view.
        drain.begin("sigint", depth_fn=lambda: 1 / 0)
        status, body = _get(f"{base}/healthz")
        payload = json.loads(body)["providers"]["drain"]
        assert status == 503 and "pending" not in payload
        assert payload["reason"] == "sigint" and "deadline_s" not in payload
    finally:
        drain.reset()
        exporter.close()
        telemetry.disable()


async def test_sigterm_drains_a_real_run_process_to_exit_zero(tmp_path):
    """``python -m fishnet_tpu_torch run`` under SIGTERM, as
    tests/test_cluster.py drives the JAX CLI: readiness goes 503 while
    liveness stays 200 and ``fishnet_drain_state`` reads 1, in-flight
    work flushes within --drain-deadline, the process exits 0, and the
    server holds no batch the process took and never gave back. A
    submit latency fault stretches the flush window."""
    lichess = FakeLichess(require_key=False)
    lichess.auto_refill = 4
    lichess.refill_move_every = 4
    port_file = tmp_path / "metrics.port"
    async with FakeServer(lichess) as server:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        env.pop(faults.PLAN_ENV, None)
        log_path = tmp_path / "client.log"
        with open(log_path, "ab") as logf:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "fishnet_tpu_torch", "run",
                "--device", "cpu", "--no-conf", "--no-stats-file",
                "--engine", "mock", "--endpoint", server.endpoint,
                "--key", "DRAINPROC", "--cores", "1", "--max-backoff", "1s",
                "--drain-deadline", "10s", "--metrics-port", "0",
                "--metrics-port-file", str(port_file),
                "--fault-plan", "net.submit:every=1:latency=0.5",
                stdout=logf, stderr=asyncio.subprocess.STDOUT,
                cwd=str(tmp_path), env=env)
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if lichess.fleet.units and port_file.exists():
                    break
                await asyncio.sleep(0.05)
            assert lichess.fleet.units, log_path.read_text()
            base = f"http://127.0.0.1:{int(port_file.read_text())}"

            proc.send_signal(signal.SIGTERM)
            t0 = time.monotonic()
            unready = alive = None
            state = None
            while time.monotonic() < t0 + 10 and unready is None:
                try:
                    status, body = await asyncio.to_thread(
                        _get, f"{base}/healthz")
                    if status == 503 and b"draining" in body:
                        unready = json.loads(body)["providers"]["drain"]
                        alive = await asyncio.to_thread(
                            _get, f"{base}/healthz/live")
                        state = (await asyncio.to_thread(
                            _get, f"{base}/metrics"))[1].decode()
                except OSError:
                    pass  # the exporter may be gone already: checked below
                await asyncio.sleep(0.05)
            rc = await asyncio.wait_for(proc.wait(), 60)
            took = time.monotonic() - t0
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
    log = log_path.read_text()
    assert rc == 0, f"drain exited {rc}: {log[-3000:]}"
    assert unready is not None, "readiness never went 503 during the drain"
    assert unready["reason"] == "sigterm" and unready["deadline_s"] == 10.0
    assert set(unready["pending"]) == {"batches", "positions", "queued"}
    assert alive == (200, b"ok\n"), "liveness failed during the drain"
    assert "fishnet_drain_state 1" in state
    assert "FAULT INJECTION ACTIVE" in log
    assert took < 10 + 30
    report = lichess.fleet_report()
    assert report["clean"] and report["completed"] >= 1, report
    assert all(n == 1 for n in lichess.analysis_submission_counts.values())


# -- the flags -------------------------------------------------------------------

FLAG_ARGVS = {
    "bare": [],
    "plan-and-deadline": ["--fault-plan", "seed=1;net.acquire:nth=2:error",
                          "--drain-deadline", "10s"],
    "ms-deadline": ["--drain-deadline", "1500ms", "--fault-plan",
                    "net.submit:p=0.1:latency=0.01"],
}


def _flags(opt):
    return (opt.fault_plan, opt.resolved_fault_plan(), opt.drain_deadline,
            opt.resolved_drain_deadline())


@pytest.mark.parametrize("name", sorted(FLAG_ARGVS))
def test_fault_plan_and_drain_deadline_resolve_as_in_the_jax_cli(
        name, monkeypatch):
    monkeypatch.delenv("FISHNET_FAULT_PLAN", raising=False)
    argv = ["run", "--no-conf", *FLAG_ARGVS[name]]
    port = configure.parse_and_configure(argv)
    ref = jax_configure.parse_and_configure(argv, write=False)
    assert _flags(port) == _flags(ref)
    if name == "bare":
        assert _flags(port) == (None, None, None, 25.0)
        monkeypatch.setenv("FISHNET_FAULT_PLAN", "queue.schedule:nth=1:error")
        assert port.resolved_fault_plan() == ref.resolved_fault_plan() \
            == "queue.schedule:nth=1:error"


def test_ini_keys_merge_under_the_command_line(tmp_path, monkeypatch):
    monkeypatch.delenv("FISHNET_FAULT_PLAN", raising=False)
    ini = tmp_path / "fishnet.ini"
    ini.write_text("[Fishnet]\nKey = k\n"
                   "FaultPlan = seed=1;net.acquire:nth=2:error\n"
                   "DrainDeadline = 2m\n")
    for argv in (["run", "--conf", str(ini)],
                 ["run", "--conf", str(ini), "--fault-plan",
                  "net.submit:p=0.1:latency=0.01", "--drain-deadline", "5s"]):
        port = configure.parse_and_configure(argv)
        ref = jax_configure.parse_and_configure(argv, write=False)
        assert _flags(port) == _flags(ref)
    assert _flags(port)[0] == "net.submit:p=0.1:latency=0.01"
    assert _flags(configure.parse_and_configure(
        ["run", "--conf", str(ini)]))[2] == 120.0


@pytest.mark.parametrize("argv", [
    ["--fault-plan", "nosuch.site:nth=1:error"],
    ["--fault-plan", "net.acquire:nth=1"],
    ["--drain-deadline", "0"],
    ["--drain-deadline", "soon"],
])
def test_bad_plans_and_deadlines_are_refused_as_in_the_jax_cli(argv):
    argv = ["run", "--no-conf", *argv]
    with pytest.raises(configure.ConfigError) as port:
        configure.parse_and_configure(argv)
    with pytest.raises(jax_configure.ConfigError) as ref:
        jax_configure.parse_and_configure(argv, write=False)
    assert str(port.value) == str(ref.value)
