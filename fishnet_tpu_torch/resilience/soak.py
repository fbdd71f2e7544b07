"""Soak harness: drive the fake server + mock engine + real search
service under a canned fault plan and assert the resilience contract.

The port's copy of ``fishnet_tpu/resilience/soak.py``. Run it from a
repo checkout::

    python -m fishnet_tpu_torch.resilience.soak                 # canned plan, cuda
    python -m fishnet_tpu_torch.resilience.soak --device cpu
    python -m fishnet_tpu_torch.resilience.soak --plan 'seed=1;net.acquire:p=0.2:error'

Three phases, one process, one metrics registry, against the
standard-library fake lichess of ``chip_smoke.py`` at the repo root
(the JAX harness loads ``tests/fake_server.py``, which needs aiohttp):

* **Phase A (client)** — a full Client (API actor, queue actor, worker
  pool, mock engine) against the in-process fake lichess, under
  acquire flaps, submit failures (opening the circuit breaker), and an
  engine-spawn fault (exercising position requeue). The batch ledger
  must end clean: every acquired batch submitted exactly once, nothing
  lost, nothing duplicated — client-side (ledger) AND server-side
  (per-batch submission counts).
* **Phase B (service)** — the supervised TpuNnueEngineFactory on
  ``device``: the first device dispatch crashes the driver
  (``service.device_step`` fault), the supervisor respawns the pool one
  rung down the device's degradation ladder (``ladder_for``: fused ->
  host-material on CUDA, xla -> host-material on the CPU; the JAX
  package's TPU ladder steps fused -> xla), and the retried search
  succeeds.
* **Phase C (overload)** — the multi-tenant front end under a
  saturating load (the fake server refills faster than the client
  drains) with ``queue.admit`` and ``net.submit`` faults layered on:
  admission control must shed analysis work (accounted — abandoned
  through the ledger and aborted back to the server), the throughput
  lane's depth must stay bounded, and the ledger must still end clean.

The run ends with a ``/metrics`` scrape asserting the four resilience
metric families are exported: ``fishnet_faults_injected_total``,
``fishnet_degradations_total``, ``fishnet_batches_requeued_total``,
``fishnet_breaker_state``. The degradation is reported by its ``from``
and ``to`` labels (``counters.degradation``).
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import sys
import time
import urllib.request
from pathlib import Path
from typing import Dict, Optional

#: The canned plan: acquire flaps, submit failures (breaker), one
#: engine crash, one device_step failure.
CANNED_PLAN = (
    "seed=7;"
    "net.acquire:nth=2:error;net.acquire:nth=3:error;"
    "net.submit:nth=1..2:error;"
    "engine.spawn:nth=1:error;"
    "service.device_step:nth=1:crash"
)

#: Phase C fault plan, installed after A/B complete: admission-layer
#: failures (degraded to accounted sheds) plus a submit failure mid-
#: saturation. Deterministic seed; probabilities keep the overload loop
#: exercised without starving it.
PHASE_C_PLAN = "seed=9;queue.admit:p=0.05:error;net.submit:nth=3:error"

#: The resilience metric-family contract the final scrape must include.
REQUIRED_FAMILIES = (
    "fishnet_faults_injected_total",
    "fishnet_degradations_total",
    "fishnet_batches_requeued_total",
    "fishnet_breaker_state",
)

#: The submit breaker of phase A: opened by the plan's two submit
#: failures, probed again after a short cooldown.
BREAKER_THRESHOLD = 2
BREAKER_COOLDOWN_SECONDS = 0.75

_START_FEN = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"


def _load_fake_server():
    """Import ``chip_smoke.py`` from the repo checkout for its stdlib
    fake lichess (the soak is a development harness; it has no meaning
    against a real server)."""
    root = Path(__file__).resolve().parents[2]
    path = root / "chip_smoke.py"
    if not path.exists():
        raise SystemExit(
            f"soak needs a repo checkout: chip_smoke.py not found under {root}"
        )
    spec = importlib.util.spec_from_file_location("_fishnet_soak_fake", path)
    mod = importlib.util.module_from_spec(spec)
    # Register before exec: dataclass processing looks the module up in
    # sys.modules while the class bodies execute.
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


async def _phase_a_client(fake_server_mod, logger, report: Dict) -> None:
    """Full client loop under acquire/submit/spawn faults."""
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.engine.mock import MockEngineFactory

    t0 = time.monotonic()
    with fake_server_mod.FakeServer() as server:
        li = server.lichess
        moves = ("e2e4 e7e5", "d2d4 d7d5", "g1f3 g8f6", "c2c4 c7c5")
        job_ids = [li.add_analysis_job(moves=m, nodes=2000) for m in moves]
        client = Client(
            endpoint=server.endpoint,
            key=fake_server_mod.VALID_KEY,
            cores=2,
            engine_factory=MockEngineFactory(),
            logger=logger,
            max_backoff=0.2,
            batch_deadline=30.0,
        )
        await client.start()
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline:
            if all(j in li.analyses for j in job_ids):
                break
            await asyncio.sleep(0.05)
        await client.stop(abort_pending=False)
        counts = dict(li.submissions)
        report["phase_a"] = {
            "jobs": len(job_ids),
            "analyses": sum(1 for j in job_ids if j in li.analyses),
            "server_submission_counts": counts,
            "seconds": round(time.monotonic() - t0, 2),
        }
        if not all(j in li.analyses for j in job_ids):
            raise AssertionError(f"phase A incomplete: {report['phase_a']}")
        dupes = {j: c for j, c in counts.items() if c != 1}
        if dupes:
            raise AssertionError(
                f"server saw non-exactly-once submissions: {dupes}"
            )


async def _phase_b_service(logger, dev, report: Dict) -> None:
    """Supervised service on ``dev`` (a torch device): device_step
    crash -> respawn one rung down."""
    from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.protocol.types import EngineFlavor
    from fishnet_tpu_torch.resilience.supervisor import (
        ServiceSupervisor,
        ladder_for,
    )
    from fishnet_tpu_torch.search.service import SearchService

    t0 = time.monotonic()
    ladder = ladder_for(dev.type)
    weights = NnueWeights.random(seed=0)

    def builder(rung: Optional[str]):
        return SearchService(
            weights=weights, pool_slots=16, batch_capacity=64,
            tt_bytes=8 << 20, device=dev, psqt_path=rung,
        )

    supervisor = ServiceSupervisor(
        builder, rungs=ladder, degrade_after=1, logger=logger
    )
    factory = TpuNnueEngineFactory(service_builder=supervisor.build)
    try:
        engine = await factory.create(EngineFlavor.OFFICIAL)
        if engine.service.psqt_path != ladder[0]:
            raise AssertionError(
                f"phase B started on {engine.service.psqt_path}"
            )
        crashed = False
        try:
            await engine.service.search(_START_FEN, [], depth=2)
        except Exception:  # noqa: BLE001 - the injected crash, by design
            crashed = True
        if not crashed:
            raise AssertionError("device_step crash fault did not fire")
        # The worker-restart path: create() sees the dead service and
        # rebuilds through the supervisor (respawn + ladder step).
        engine = await factory.create(EngineFlavor.OFFICIAL)
        if engine.service.psqt_path != ladder[1]:
            raise AssertionError(
                f"phase B respawned on {engine.service.psqt_path}, "
                f"not {ladder[1]}"
            )
        res = await engine.service.search(_START_FEN, [], depth=2)
        if not res.best_move:
            raise AssertionError("degraded service produced no move")
    finally:
        factory.close()
    report["phase_b"] = {
        "device": str(dev),
        "ladder": list(ladder),
        "rung": supervisor.rung,
        "respawns": supervisor.respawns,
        "seconds": round(time.monotonic() - t0, 2),
    }


async def _phase_c_overload(fake_server_mod, logger, report: Dict) -> None:
    """Multi-tenant front end under saturating load + admission faults."""
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.engine.mock import MockEngineFactory
    from fishnet_tpu_torch.resilience import faults
    from fishnet_tpu_torch.resilience.shedding import (
        LANE_THROUGHPUT,
        ShedPolicy,
    )

    t0 = time.monotonic()
    high = 16
    tenants = 4
    with fake_server_mod.FakeServer() as server:
        li = server.lichess
        li.work_id_prefix = "oc"  # distinct from phase A's ids in the ledger
        li.auto_refill = 16  # never drains: 4x what two workers clear
        li.refill_move_every = 4
        client = Client(
            endpoint=server.endpoint,
            key=fake_server_mod.VALID_KEY,
            cores=2,
            engine_factory=MockEngineFactory(delay_seconds=0.02),
            logger=logger,
            max_backoff=0.2,
            tenants=tenants,
            shed_policy=ShedPolicy(high_watermark=high),
        )
        await client.start()
        frontend = client._frontend
        if frontend is None:
            raise AssertionError("phase C needs the multi-tenant path")
        sched = frontend.state.scheduler
        max_depth = 0
        deadline = time.monotonic() + 6
        while time.monotonic() < deadline:
            max_depth = max(max_depth, sched.depth(LANE_THROUGHPUT))
            await asyncio.sleep(0.02)
        await client.stop(abort_pending=True)
        shed_total = sum(ts.shed for ts in frontend.tenants.values())
        admitted = sum(ts.acquired for ts in frontend.tenants.values())
        depth_bound = high + tenants * 8
        report["phase_c"] = {
            "tenants": tenants,
            "shed": shed_total,
            "admitted": admitted,
            "max_throughput_depth": max_depth,
            "depth_bound": depth_bound,
            "served_by_tenant": dict(sched.served),
            "faults": faults.current().counts() if faults.current() else {},
            "moves_completed": len(li.moves),
            "analyses_completed": len(li.analyses),
            "seconds": round(time.monotonic() - t0, 2),
        }
        if shed_total < 1:
            raise AssertionError(
                f"phase C: saturation never shed: {report['phase_c']}"
            )
        if admitted < 1:
            raise AssertionError(
                f"phase C: nothing admitted: {report['phase_c']}"
            )
        if max_depth > depth_bound:
            raise AssertionError(
                f"phase C: throughput lane unbounded "
                f"({max_depth} > {depth_bound}): {report['phase_c']}"
            )


def _scrape(port: int) -> str:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=5
    ) as res:
        return res.read().decode()


async def run_soak(
    plan_spec: str = CANNED_PLAN,
    metrics_port: int = 0,
    device: str = "cuda",
) -> Dict:
    """Run the three phases under ``plan_spec`` (phase B's service on
    ``device``); returns the report dict (key ``ok``). Raises
    AssertionError on a contract violation, RuntimeError without the
    GPU ``device`` names."""
    from fishnet_tpu_torch import telemetry
    from fishnet_tpu_torch.device import resolve_device
    from fishnet_tpu_torch.net import api as api_mod
    from fishnet_tpu_torch.resilience import accounting, faults
    from fishnet_tpu_torch.resilience import supervisor as supervisor_mod
    from fishnet_tpu_torch.sched import queue as queue_mod
    from fishnet_tpu_torch.utils.logger import Logger

    dev = resolve_device(device)
    fake_server_mod = _load_fake_server()
    # Logs go to stderr: standard output carries the JSON report alone.
    logger = Logger(verbose=0, stderr=True)
    report: Dict = {"plan": plan_spec, "ok": False}

    # Counter baselines: the registry is process-wide and cumulative, so
    # the soak asserts DELTAS (it may run after other traffic in-process).
    base = {
        "requeued": queue_mod._REQUEUED.value(),
        "respawns": supervisor_mod._RESPAWNS.value(),
    }

    exporter = telemetry.start_exporter(metrics_port)
    saved_breaker = (api_mod.BREAKER_THRESHOLD,
                     api_mod.BREAKER_COOLDOWN_SECONDS)
    api_mod.BREAKER_THRESHOLD = BREAKER_THRESHOLD
    api_mod.BREAKER_COOLDOWN_SECONDS = BREAKER_COOLDOWN_SECONDS
    try:
        faults.install(plan_spec)
        ledger = accounting.install()
        await _phase_a_client(fake_server_mod, logger, report)
        await _phase_b_service(logger, dev, report)
        ab_fault_counts = faults.current().counts()
        # Snapshot the ledger BEFORE phase C: its saturation traffic
        # shares the process-wide ledger, so "submitted == phase A
        # jobs" only holds on this pre-C view.
        report["ledger"] = ledger.assert_clean()
        # Phase C runs under its own plan (admission + submit faults);
        # the A/B counts are captured above so the report keeps both.
        faults.install(PHASE_C_PLAN)
        await _phase_c_overload(fake_server_mod, logger, report)

        # Whole-run exactly-once, phase C's overload traffic included.
        report["ledger_final"] = ledger.assert_clean()
        frm, to = report["phase_b"]["ladder"][:2]
        report["counters"] = {
            "faults_injected": ab_fault_counts,
            "requeued": queue_mod._REQUEUED.value() - base["requeued"],
            "respawns": supervisor_mod._RESPAWNS.value() - base["respawns"],
            "degradation": {
                "from": frm, "to": to,
                "count": supervisor_mod._DEGRADATIONS.value(
                    **{"from": frm, "to": to}
                ),
            },
        }
        if report["counters"]["requeued"] < 1:
            raise AssertionError("no batch requeue observed")
        if report["counters"]["respawns"] < 1:
            raise AssertionError("no pool respawn observed")
        if report["counters"]["degradation"]["count"] < 1:
            raise AssertionError(f"no {frm}->{to} degradation observed")

        text = _scrape(exporter.port)
        missing = [f for f in REQUIRED_FAMILIES if f"# TYPE {f} " not in text]
        report["metric_families"] = sorted(REQUIRED_FAMILIES)
        if missing:
            raise AssertionError(f"/metrics missing families: {missing}")
        report["ok"] = True
        return report
    finally:
        faults.clear()
        accounting.clear()
        exporter.close()
        telemetry.disable()
        (api_mod.BREAKER_THRESHOLD,
         api_mod.BREAKER_COOLDOWN_SECONDS) = saved_breaker


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch.resilience.soak",
        description="Resilience soak: fake server + client + supervised "
        "service under a deterministic fault plan.",
    )
    parser.add_argument(
        "--plan", default=CANNED_PLAN,
        help="fault plan (resilience/faults.py grammar); default: the "
        "canned acceptance plan",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="telemetry port for the run (0 = ephemeral)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where phase B's supervised service runs (default cuda; no "
        "GPU is an error)",
    )
    args = parser.parse_args(argv)
    from fishnet_tpu_torch.resilience.faults import FaultPlanError

    try:
        report = asyncio.run(run_soak(
            plan_spec=args.plan, metrics_port=args.metrics_port,
            device=args.device,
        ))
    except (AssertionError, FaultPlanError) as err:
        print(f"SOAK FAILED: {err}", file=sys.stderr)
        return 1
    except RuntimeError as err:  # no GPU behind --device cuda
        print(f"E: {err}", file=sys.stderr)
        return 2
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
