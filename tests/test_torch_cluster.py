"""The port's cluster package (fishnet_tpu_torch.cluster: the chaos proxy,
the fleet supervisor and the chaos harness) against the JAX package's,
on the CPU.

The counterparts of tests/test_cluster.py's nine tests, against the
standard-library fake lichess of chip_smoke.py with its fleet ledger:
the fleet fault sites, the chaos proxy (quiet, 502 and latency on
schedule, a partition window) behind the port's keep-alive HTTP client,
readiness against liveness under a drain, a real ``run`` process
SIGTERM-drained to exit 0, a SIGKILL reassigned across a two-process
fleet, and the canned chaos scenario end to end. Then: the same plan
through the JAX proxy and the port's gives the same decision per
request; both supervisors draw the same restart backoff schedule; a
role-aware fleet (one evaluator host, one frontend) under
``rpc.detach`` is audited exactly once; and the counterpart of
tests/test_fleet_obs.py's SIGKILL restart churn under the port's fleet
aggregator.

Every child is a mock-engine client, which holds no device, or gets
``--device cpu``; every subprocess and wait has a time limit."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from chip_smoke import FakeLichess, FakeServer
from fishnet_tpu.cluster import supervisor as jax_supervisor
from fishnet_tpu.cluster.proxy import ChaosProxy as JaxChaosProxy
from fishnet_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from fishnet_tpu_torch import telemetry
from fishnet_tpu_torch.cluster import supervisor
from fishnet_tpu_torch.cluster.proxy import ChaosProxy
from fishnet_tpu_torch.cluster.supervisor import FleetSupervisor, ProcSpec
from fishnet_tpu_torch.net.api import HttpSession
from fishnet_tpu_torch.resilience import drain
from fishnet_tpu_torch.resilience.faults import FaultPlan, FaultPlanError
from fishnet_tpu_torch.telemetry.fleet import FleetAggregator, port_dir_targets

ROOT = Path(__file__).resolve().parents[1]


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


# -- fleet fault sites -----------------------------------------------------------


def test_fleet_sites_parse_and_poll_deterministically():
    spec = ("seed=5;proxy.partition:nth=2:latency=1.5;"
            "proxy.error5xx:every=3:error;proc.kill:nth=4:crash;"
            "proc.sigterm:nth=6:error")
    plans = {"port": FaultPlan.parse(spec), "jax": JaxFaultPlan.parse(spec)}
    seen = {}
    for name, plan in plans.items():
        assert plan.poll("proxy.partition") is None
        rule = plan.poll("proxy.partition")
        assert rule is not None and rule.action == "latency" and rule.arg == 1.5
        assert plan.poll("proxy.partition") is None
        assert [plan.poll("proxy.error5xx") is not None
                for _ in range(3)] == [False, False, True]
        assert [plan.poll("proc.kill") for _ in range(3)] == [None] * 3
        assert plan.poll("proc.kill").action == "crash"
        assert [plan.poll("proc.sigterm") is not None
                for _ in range(6)] == [False] * 5 + [True]
        counts = plan.counts()
        assert counts["proc.kill"] == 4 and counts["proxy.partition"] == 3
        seen[name] = counts
    assert seen["port"] == seen["jax"]


def test_unknown_fleet_site_rejected():
    with pytest.raises(FaultPlanError):
        FaultPlan.parse("proxy.meteor:nth=1:error")


# -- the chaos proxy ------------------------------------------------------------


def _session():
    return HttpSession({"User-Agent": "test"}, timeout=10.0)


def test_chaos_proxy_quiet_is_faithful():
    """With no plan the proxy is plumbing: the same statuses and bodies
    as the server's, over one kept-alive client connection, nothing
    counted but forwards."""

    async def go(server):
        proxy = await ChaosProxy(server.endpoint).start()
        session = _session()
        try:
            via = await session.get(f"{proxy.endpoint}/status")
            direct = await session.get(f"{server.endpoint}/status")
            assert (via.status, via.json()) == (direct.status, direct.json())
            assert (await session.get(f"{proxy.endpoint}/nope")).status == 404
            body = {"fishnet": {"version": "x", "apikey": "TESTKEY"}}
            res = await session.post(f"{proxy.endpoint}/acquire",
                                     json_body=body)
            assert res.status == 202 and res.json()["work"]["id"] == job
            return proxy.stats(), server.lichess.connections
        finally:
            session.close()
            await proxy.close()

    with FakeServer() as server:
        job = server.lichess.add_analysis_job()
        stats, connections = asyncio.run(go(server))
    assert stats["forwarded"] == 3
    assert stats["dropped"] == stats["injected_5xx"] == stats["delayed"] == 0
    # The proxy forwards one client connection over one of its own.
    assert connections == 2


def test_chaos_proxy_injects_502_and_latency_on_schedule():
    """Sites are polled in order (partition, error5xx, latency) and a
    firing site short-circuits the rest: the latency site first sees
    the SECOND request, and nth=1 delays exactly that one."""
    plan = FaultPlan.parse(
        "proxy.error5xx:nth=1:error;proxy.latency:nth=1:latency=0.3")

    async def go(server):
        proxy = await ChaosProxy(server.endpoint, plan=plan).start()
        session = _session()
        try:
            url = f"{proxy.endpoint}/status"
            first = await session.get(url)
            assert first.status == 502 and b"injected" in first.body
            t0 = time.monotonic()
            assert (await session.get(url)).status == 200
            assert time.monotonic() - t0 >= 0.3
            assert (await session.get(url)).status == 200
            return proxy.stats()
        finally:
            session.close()
            await proxy.close()

    with FakeServer() as server:
        stats = asyncio.run(go(server))
    assert stats["injected_5xx"] == 1
    assert stats["delayed"] == 1
    assert stats["forwarded"] == 2


def test_chaos_proxy_partition_window_drops_every_request():
    """``proxy.partition:...:latency=S``: connection resets (no HTTP
    response) for the whole S-second window, then traffic resumes."""
    plan = FaultPlan.parse("proxy.partition:nth=2:latency=0.6")
    before = telemetry.REGISTRY.counter(
        "fishnet_fleet_partitions_total", "",
        labelnames=("proxy",)).value(proxy="linkA")

    async def go(server):
        proxy = await ChaosProxy(server.endpoint, plan=plan,
                                 name="linkA").start()
        session = _session()
        try:
            url = f"{proxy.endpoint}/status"
            assert (await session.get(url)).status == 200  # poll 1: no rule
            t0 = time.monotonic()
            for _ in range(3):  # window open: every request dies raw
                with pytest.raises(ConnectionError):
                    await session.get(url)
            await asyncio.sleep(max(0.0, 0.7 - (time.monotonic() - t0)))
            assert (await session.get(url)).status == 200  # window passed
            return proxy.stats()
        finally:
            session.close()
            await proxy.close()

    with FakeServer() as server:
        stats = asyncio.run(go(server))
    assert stats["partitions"] == 1
    # Connection-level: the client retries once on a reused connection
    # that died, so each request is dropped at least once.
    assert stats["dropped"] >= 3
    assert stats["forwarded"] == 2
    after = telemetry.REGISTRY.counter(
        "fishnet_fleet_partitions_total", "",
        labelnames=("proxy",)).value(proxy="linkA")
    assert after - before == 1


def test_same_plan_same_decisions_as_the_jax_proxy():
    """One plan string through the JAX proxy and the port's, over the
    same request sequence (one fresh connection each): the same
    forward / 502 / drop / delay decision per request."""
    spec = ("seed=3;proxy.partition:every=5:error;"
            "proxy.error5xx:every=3:error;proxy.latency:p=0.5:latency=0.01")

    def one(url):
        try:
            with urllib.request.urlopen(url, timeout=5) as res:
                return res.status
        except urllib.error.HTTPError as err:
            return err.code
        except (urllib.error.URLError, ConnectionError):
            return "reset"

    async def run(make, server):
        proxy = await make(server.endpoint).start()
        try:
            out = []
            for _ in range(24):
                before = proxy.stats()
                got = await asyncio.to_thread(one, f"{proxy.endpoint}/status")
                after = proxy.stats()
                moved = sorted(k for k in after if after[k] != before[k])
                out.append((got, moved))
            return out
        finally:
            await proxy.close()

    with FakeServer() as server:
        got = {
            "port": asyncio.run(run(
                lambda up: ChaosProxy(up, plan=FaultPlan.parse(spec)),
                server)),
            "jax": asyncio.run(run(
                lambda up: JaxChaosProxy(up, plan=JaxFaultPlan.parse(spec)),
                server)),
        }
    assert got["port"] == got["jax"]
    kinds = {tuple(m) for _, m in got["port"]}
    assert kinds == {("forwarded",), ("injected_5xx",),
                     ("dropped", "partitions"), ("delayed", "forwarded")}


# -- the supervisor ---------------------------------------------------------------


class _Exited:
    """A child that has already exited with rc 1."""

    returncode = 1
    pid = 0

    async def wait(self):
        return 1


def _backoff_schedule(mod, monkeypatch, name: str, budget: int) -> list:
    """The restart delays ``mod``'s supervisor sleeps for a child that
    exits at once, every time, until its budget is spent: its own
    ``_monitor`` with the spawn stubbed and ``asyncio.sleep`` recorded."""
    tick = 0.123456
    delays = []

    async def sleep(seconds):
        if seconds != tick:
            delays.append(seconds)

    async def spawn(self, handle):
        handle.process = _Exited()
        handle.spawns += 1

    monkeypatch.setattr(asyncio, "sleep", sleep)
    monkeypatch.setattr(mod.FleetSupervisor, "_spawn", spawn)
    spec = mod.ProcSpec(name=name, restart_budget=budget)
    sup = mod.FleetSupervisor("http://127.0.0.1:1/fishnet", [spec],
                              tick_seconds=tick, workdir="/nonexistent")
    handle = mod.ProcHandle(spec=spec, plan=None, proxy=None,
                            log_path=Path("/dev/null"),
                            rng=__import__("random").Random(name),
                            process=_Exited())
    asyncio.run(sup._monitor(handle))
    monkeypatch.undo()
    assert handle.restarts == budget
    return delays


def test_both_supervisors_draw_the_same_backoff_schedule(monkeypatch):
    for name in ("PROC0", "PROC1", "KA", "evaluator-7"):
        port = _backoff_schedule(supervisor, monkeypatch, name, 4)
        jax = _backoff_schedule(jax_supervisor, monkeypatch, name, 4)
        assert len(port) == 4 and port == jax, (name, port, jax)
        assert all(0.4 * (1 + i) * 0.75 <= d < 0.4 * (1 + i) * 1.25
                   for i, d in enumerate(port))


def test_proc_spec_roles_and_commands(tmp_path):
    with pytest.raises(ValueError, match="role"):
        ProcSpec(name="x", role="sidecar")
    sup = FleetSupervisor("http://127.0.0.1:1/fishnet", [],
                          workdir=str(tmp_path))
    handle = supervisor.ProcHandle(
        spec=ProcSpec(name="EV", role="evaluator", fault_spec="rpc.detach:nth=3:error",
                      extra_args=("--nnue-file", "w.nnue", "--device", "cpu")),
        plan=None, proxy=None, log_path=tmp_path / "x.log",
        rng=__import__("random").Random("EV"))
    cmd = sup.command(handle)
    assert cmd[1:3] == ["-m", "fishnet_tpu_torch.rpc.host"]
    assert cmd[cmd.index("--dir") + 1] == sup.rpc_dir
    assert "--device" in cmd and "JAX_PLATFORMS" not in " ".join(cmd)
    env = sup.child_env(handle.spec)
    assert env["FISHNET_RPC_DIR"] == sup.rpc_dir
    assert env["FISHNET_FAULT_PLAN"] == "rpc.detach:nth=3:error"
    assert "FISHNET_RPC" not in env
    front = ProcSpec(name="FE", role="frontend", fault_spec="proc.kill:nth=1:crash")
    env = sup.child_env(front)
    assert env["FISHNET_RPC"] == "1" and "FISHNET_FAULT_PLAN" not in env


# -- readiness and liveness under a drain (in process) ---------------------------


def test_drain_flips_readiness_not_liveness():
    exporter = telemetry.start_exporter(0)
    try:
        base = f"http://127.0.0.1:{exporter.port}"
        assert _get(f"{base}/healthz") == (200, b"ok\n")
        assert _get(f"{base}/healthz/ready") == (200, b"ok\n")
        assert _get(f"{base}/healthz/live") == (200, b"ok\n")
        assert drain.begin("sigterm", deadline=25.0,
                           depth_fn=lambda: {"batches": 2}) is True
        assert drain.begin("sigterm") is False  # idempotent
        status, body = _get(f"{base}/healthz")
        assert status == 503
        payload = json.loads(body)["providers"]["drain"]
        assert payload["draining"] is True and payload["reason"] == "sigterm"
        assert payload["pending"] == {"batches": 2}
        assert _get(f"{base}/healthz/ready")[0] == 503
        # Liveness never couples to a drain: the process is flushing.
        assert _get(f"{base}/healthz/live") == (200, b"ok\n")
        assert "fishnet_drain_state 1" in _get(f"{base}/metrics")[1].decode()
        drain.reset()
        assert _get(f"{base}/healthz") == (200, b"ok\n")
        assert "fishnet_drain_state 0" in _get(f"{base}/metrics")[1].decode()
    finally:
        drain.reset()
        exporter.close()
        telemetry.disable()


# -- real processes -----------------------------------------------------------------


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env.pop("FISHNET_FAULT_PLAN", None)
    return env


def test_sigterm_drains_real_process_to_exit_zero(tmp_path):
    """The drain contract against a real ``python -m fishnet_tpu_torch
    run``: on SIGTERM readiness goes 503 while liveness stays 200,
    in-flight work flushes within the deadline, the process exits 0, and
    the server's fleet ledger is clean. A submit latency fault stretches
    the flush window."""
    lichess = FakeLichess(require_key=False)
    lichess.auto_refill = 4
    lichess.refill_move_every = 4
    port_file = tmp_path / "metrics.port"
    log_path = tmp_path / "client.log"
    with FakeServer(lichess) as server, open(log_path, "ab") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fishnet_tpu_torch", "run", "--no-conf",
             "--no-stats-file", "--engine", "mock", "--endpoint",
             server.endpoint, "--key", "DRAINPROC", "--cores", "1",
             "--max-backoff", "1s", "--drain-deadline", "10s",
             "--metrics-port", "0", "--metrics-port-file", str(port_file),
             "--fault-plan", "net.submit:every=1:latency=0.5"],
            stdout=logf, stderr=subprocess.STDOUT, cwd=str(tmp_path),
            env=_child_env())
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not (
                    lichess.fleet.units and port_file.exists()):
                time.sleep(0.05)
            assert lichess.fleet.units, log_path.read_text()
            base = f"http://127.0.0.1:{int(port_file.read_text())}"
            proc.send_signal(signal.SIGTERM)
            unready = alive = False
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not unready:
                try:
                    status, body = _get(f"{base}/healthz")
                    if status == 503 and b"draining" in body:
                        unready = True
                        alive = _get(f"{base}/healthz/live") == (200, b"ok\n")
                except OSError:
                    pass  # the exporter may be gone already: checked below
                time.sleep(0.05)
            rc = proc.wait(timeout=30)
            assert rc == 0, log_path.read_text()
            assert unready, "readiness never went 503 during the drain"
            assert alive, "liveness failed during the drain"
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    report = lichess.fleet_report()
    assert report["clean"], report
    assert report["handed"] >= 1


def test_sigkill_reassignment_fleet_smoke(tmp_path):
    """kill -9 on one process of a two-process fleet: the server's sweep
    hands its work out again, the supervisor restarts it under budget,
    and the fleet ledger ends exactly-once: 0 lost, 0 duplicated. The
    killed process submits each job 2 s after taking it (a ``net.submit``
    latency fault), so the kill always finds it holding work and the
    1.5 s sweep takes its jobs back even before: the port's mock client
    holds a job for milliseconds, and a kill between two jobs left
    nothing to reassign."""
    lichess = FakeLichess(require_key=False)
    lichess.auto_refill = 4
    lichess.refill_move_every = 4
    lichess.reassign_after = 1.5

    async def go(server):
        sup = FleetSupervisor(
            server.endpoint,
            [ProcSpec(name="KA", fault_spec="proc.kill:nth=10:crash",
                      extra_args=("--fault-plan",
                                  "net.submit:every=1:latency=2")),
             ProcSpec(name="KB")],
            workdir=str(tmp_path), tick_seconds=0.2, drain_deadline=5.0)
        await sup.start()
        try:
            await asyncio.sleep(9.0)
            return sup, await sup.drain()
        except BaseException:
            await sup.kill_all()
            raise

    with FakeServer(lichess) as server:
        sup, exit_codes = asyncio.run(asyncio.wait_for(go(server), 90))
    kinds = [k for _, _, k in sup.events]
    assert "kill" in kinds and "restart" in kinds, kinds
    assert sup.procs["KA"].exit_codes[0] == -signal.SIGKILL
    assert exit_codes == {"KA": 0, "KB": 0}
    report = lichess.fleet_report()
    assert report["clean"], report
    assert report["completed"] > 0
    assert report["reassigned"] >= 1, report


@pytest.mark.parametrize("hand_back", [True, False])
def test_fake_server_hand_back_option(hand_back):
    """The stdlib fake's sweep puts a stale job back; by default (the
    JAX fake's behaviour) its old holder may take it again, and with
    ``hand_back=False`` only another process may, while its old holder
    gets the next job."""
    lichess = FakeLichess(require_key=False)
    lichess.hand_back = hand_back
    lichess.reassign_after = 0.0
    first = lichess.add_analysis_job()
    second = lichess.add_analysis_job()

    def acquire(proc):
        status, body = lichess.handle("POST", "/fishnet/acquire", {}, {},
                                      {"fishnet": {"apikey": proc}})
        return status, body and body["work"]["id"]

    assert acquire("P") == (202, first)
    time.sleep(0.01)
    # The sweep has put ``first`` back (and ``second`` is unacquired).
    assert acquire("P") == (202, first if hand_back else second)
    time.sleep(0.01)
    status, got = acquire("Q")
    assert (status, got) == (202, first)
    assert len(lichess.fleet.units[first].requeues) >= 1


def test_cluster_chaos_smoke_end_to_end():
    """The canned scenario (SIGKILL, SIGTERM drain and a partition across
    three real processes) through the chaos harness: the ledger clean, a
    restart under budget, every drained process exiting 0, and the fleet
    metric families on /metrics."""
    from fishnet_tpu_torch.cluster.chaos import run_chaos

    report = asyncio.run(asyncio.wait_for(
        run_chaos(procs=3, seconds=8.0, drain_deadline=5.0), 120))
    assert report["ok"] is True
    kinds = [k for _, _, k in report["events"]]
    assert "kill" in kinds and "sigterm" in kinds
    assert sum(p["partitions"] for p in report["proxies"].values()) >= 1
    assert report["fleet"]["clean"]
    assert report["fleet"]["lost"] == [] and report["fleet"]["duplicated"] == []
    assert all(rc == 0 for rc in report["exit_codes"].values())
    assert report["metric_families"] == sorted([
        "fishnet_proc_restarts_total",
        "fishnet_fleet_partitions_total",
        "fishnet_faults_injected_total",
    ])


def test_chaos_module_entry_point_passes_its_audit():
    """``python -m fishnet_tpu_torch.cluster.chaos`` exits 0 and prints
    its report, the aggregator's view of the fleet included."""
    proc = subprocess.run(
        [sys.executable, "-m", "fishnet_tpu_torch.cluster.chaos",
         "--seconds", "6", "--fleet-port", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env=_child_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["ok"] and report["fleet"]["clean"]
    assert set(report["fleet_observability"]["procs"]) == {
        "PROC0", "PROC1", "PROC2"}


def _injected(metrics: bytes) -> float:
    """``fishnet_faults_injected_total`` of the ``rpc.detach`` site in an
    exposition, 0 when absent."""
    for line in metrics.decode().splitlines():
        if (line.startswith("fishnet_faults_injected_total")
                and 'site="rpc.detach"' in line):
            return float(line.split()[-1])
    return 0.0


def test_role_aware_fleet_under_rpc_detach_is_exactly_once(tmp_path):
    """One evaluator host and one frontend, supervised: the host drops
    the frontend's link mid-flight (``rpc.detach:nth=N:error`` in its
    plan), the frontend re-attaches and resubmits and completes work
    after it, and the fleet ledger is clean."""
    from fishnet_tpu_torch.nnue.weights import NnueWeights

    net = tmp_path / "net.nnue"
    NnueWeights.random(seed=0).save(str(net))
    lichess = FakeLichess(require_key=False)
    lichess.auto_refill = 2
    lichess.refill_limit = 16
    lichess.reassign_after = 30.0
    lichess.refill_analysis = lambda n: {"moves": "e2e4", "nodes": 120}
    specs = [
        ProcSpec(name="EVAL", role="evaluator",
                 fault_spec="rpc.detach:nth=100:error",
                 extra_args=("--nnue-file", str(net), "--device", "cpu")),
        ProcSpec(name="FRONT", role="frontend",
                 extra_args=("--engine", "tpu-nnue", "--nnue-file", str(net),
                             "--microbatch", "64")),
    ]

    async def go(server):
        sup = FleetSupervisor(server.endpoint, specs, workdir=str(tmp_path),
                              tick_seconds=0.2, drain_deadline=10.0)
        await sup.start()
        try:
            deadline = time.monotonic() + 150
            detaches = 0.0
            while time.monotonic() < deadline and not detaches:
                await asyncio.sleep(0.25)
                url = sup.metrics_targets().get("EVAL")
                if url:
                    detaches = _injected(
                        (await asyncio.to_thread(_get, url + "/metrics"))[1])
            before = len(lichess.analyses)
            while time.monotonic() < deadline and (
                    len(lichess.analyses) < max(3, before + 2)):
                await asyncio.sleep(0.2)
            return sup, await sup.drain(), detaches, before
        except BaseException:
            await sup.kill_all()
            raise

    with FakeServer(lichess) as server:
        sup, exit_codes, detaches, before = asyncio.run(asyncio.wait_for(
            go(server), 240))
    logs = {n: h.log_path.read_text(errors="replace")[-2000:]
            for n, h in sup.procs.items()}
    assert detaches >= 1, logs
    assert len(lichess.analyses) >= max(3, before + 2), logs
    assert exit_codes == {"EVAL": 0, "FRONT": 0}, logs
    assert sup.restarts_total() == 0, sup.events
    # The host drains after the frontend whose batches it serves.
    order = [p for _, p, kind in sup.events if kind == "drain-sigterm"]
    assert order == ["FRONT", "EVAL"], sup.events
    report = lichess.fleet_report()
    assert report["clean"] and report["completed"] >= 3, report


# -- the fleet aggregator through restart churn (tests/test_fleet_obs.py) -------------

_CHILD = """
import os, sys, time
from fishnet_tpu_torch import telemetry
exporter = telemetry.start_exporter(0)
with open(sys.argv[1] + ".tmp", "w") as fp:
    fp.write(str(exporter.port))
os.replace(sys.argv[1] + ".tmp", sys.argv[1])
time.sleep(120)
"""


def test_scrape_loop_survives_sigkill_restart_churn(tmp_path):
    """The port's aggregator polls in a tight loop while a real exporter
    process is SIGKILLed and restarted ten times: it never crashes,
    reads each death as down, and keys a fresh incarnation per pid."""
    port_file = tmp_path / "CHURN.port"
    agg = FleetAggregator(targets_fn=port_dir_targets(str(tmp_path)),
                          poll_interval=0.05).start()
    pids = []
    try:
        for _ in range(10):
            child = subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(port_file)],
                env=_child_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            pids.append(child.pid)
            try:
                deadline = time.monotonic() + 20
                while not port_file.exists() and time.monotonic() < deadline:
                    time.sleep(0.05)
                assert port_file.exists(), "the child never wrote its port"
                time.sleep(0.3)  # let a few scrapes land
            finally:
                os.kill(child.pid, signal.SIGKILL)
                child.wait(timeout=10)
            port_file.unlink(missing_ok=True)
            time.sleep(0.15)
        doc = agg.fleet_doc()
        st = doc["procs"]["CHURN"]
        assert st["up"] is False
        assert st["scrapes"] >= 5
        assert len(st["pids"]) >= 5
        assert set(st["pids"]) <= set(pids)
    finally:
        agg.close()
