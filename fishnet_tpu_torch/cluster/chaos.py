"""Fleet chaos soak: real client processes, a chaos proxy per link,
SIGKILL/SIGTERM/partitions from a seeded plan, exactly-once audited.

The port of ``fishnet_tpu/cluster/chaos.py``. Run it from a repo
checkout::

    python -m fishnet_tpu_torch.cluster.chaos                 # canned scenario
    python -m fishnet_tpu_torch.cluster.chaos --procs 4 --seconds 20

The canned scenario (3 processes, ~12 s):

* **PROC0** is SIGKILLed mid-run (``proc.kill``): no goodbye, no flush;
  its in-flight work must come back through the server's reassignment
  sweep and complete on another (or the restarted) process.
* **PROC1** runs behind a flapping link: a partition window
  (``proxy.partition``) plus background 502s and latency.
* **PROC2** is SIGTERMed (``proc.sigterm``): it must drain: stop
  acquiring, flush in-flight batches within the deadline, exit 0.

The supervisor restarts every exited process under its budget; the run
ends with a fleet-wide drain, the fleet-ledger audit (0 lost, 0
duplicated, kills reassigned across processes) and a ``/metrics``
scrape asserting the fleet metric families. Everything chaotic comes
from the fault-plan grammar, so a failing run replays exactly.

The server is the standard-library fake lichess of ``chip_smoke.py``
(loaded from the checkout, as the port's soak loads it), with its fleet
ledger, reassignment sweep and key-less process identity turned on. The
children are ``--engine mock`` clients, which hold no device. The pieces
(:func:`fleet_specs`, :func:`chaos_lichess`, :data:`CANNED_SPECS`,
:func:`scenario_report`, :func:`check_report`, :func:`observed`) compose
other fleets: ``tpu-nnue`` clients on a GPU, or a split fleet with
``ProcSpec(role="frontend"|"evaluator")``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
import urllib.request
from typing import Dict, List, Optional

from fishnet_tpu_torch.cluster.supervisor import FleetSupervisor, ProcSpec
from fishnet_tpu_torch.resilience.soak import _load_fake_server

#: Fleet metric families the final scrape must include (the JAX
#: package's doc/observability.md contract).
REQUIRED_FAMILIES = (
    "fishnet_proc_restarts_total",
    "fishnet_fleet_partitions_total",
    "fishnet_faults_injected_total",
)

#: Per-process canned plans (supervisor tick = 0.2 s, so nth=10 fires
#: ~2 s in, after the child has started and begun acquiring).
CANNED_SPECS = (
    "seed=11;proc.kill:nth=10:crash;proxy.latency:every=13:latency=0.05",
    "seed=12;proxy.partition:nth=8:latency=1.5;proxy.error5xx:every=19:error",
    "seed=13;proc.sigterm:nth=16:error",
)


def fleet_specs(procs: int) -> List[ProcSpec]:
    """The canned scenario, extended with quiet processes past 3."""
    specs = []
    for i in range(procs):
        fault_spec = CANNED_SPECS[i] if i < len(CANNED_SPECS) else ""
        specs.append(ProcSpec(name=f"PROC{i}", fault_spec=fault_spec))
    return specs


def chaos_lichess(fake_server_mod, procs: int):
    """The scenario's fake server: no key check (a process is its
    ``fishnet.apikey``), a queue kept ``procs * 2`` jobs deep with every
    4th a move job, and stale handouts (a SIGKILLed process's work)
    reassigned after 2 s, well inside the run, so kills are recovered,
    not just excused as "still open"."""
    lichess = fake_server_mod.FakeLichess(require_key=False)
    lichess.auto_refill = procs * 2
    lichess.refill_move_every = 4
    lichess.reassign_after = 2.0
    return lichess


def _scrape(port: int) -> str:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=5
    ) as res:
        return res.read().decode()


def recovery_seconds(supervisor: FleetSupervisor, lichess) -> Dict[str, float]:
    """Seconds from each kill/sigterm event to that process's first
    post-event acquire: the fleet's recovery time, measured at the
    server (the only place it matters)."""
    out: Dict[str, float] = {}
    for t_rel, name, kind in supervisor.events:
        if kind not in ("kill", "sigterm"):
            continue
        key = supervisor.procs[name].spec.key or name
        t_abs = supervisor._t0 + t_rel
        acquires = lichess.fleet.acquires_by_proc.get(key, ())
        after = [t for t in acquires if t > t_abs]
        if after:
            out[f"{name}:{kind}"] = round(after[0] - t_abs, 3)
    return out


def federated_by_proc(families, name: str) -> Dict[str, Dict[str, float]]:
    """``{proc: {scope: value}}`` of a federated family with a ``scope``
    label (``FleetAggregator.federated_families()``), summed over its
    other labels."""
    out: Dict[str, Dict[str, float]] = {}
    fam = families.get(name)
    for sample in (fam.samples if fam is not None else ()):
        row = out.setdefault(sample.labels.get("proc", "?"), {})
        scope = sample.labels.get("scope", "")
        row[scope] = row.get(scope, 0.0) + sample.value
    return out


def observed(aggregator) -> Dict:
    """The aggregator's final state document, swept once more while the
    children still answer, with the federated position-tier hits by
    process and scope under ``postier_hits``."""
    aggregator.poll_once()
    doc = aggregator.fleet_doc()
    return {
        "procs": doc["procs"],
        "slo": doc["slo"],
        "stitch": doc["stitch"],
        "critical_path": doc["critical_path"],
        "postier_hits": federated_by_proc(
            aggregator.federated_families(), "fishnet_postier_hits_total"),
    }


def scenario_report(supervisor: FleetSupervisor, lichess,
                    exit_codes: Dict[str, Optional[int]]) -> Dict:
    """The drained fleet's timeline, exit codes, restarts, proxy stats,
    recovery times and the server's fleet-ledger audit."""
    return {
        "events": [list(e) for e in supervisor.events],
        "exit_codes": exit_codes,
        "restarts": supervisor.restarts_total(),
        "proxies": {name: h.proxy.stats()
                    for name, h in supervisor.procs.items()},
        "recovery": recovery_seconds(supervisor, lichess),
        "fleet": lichess.fleet_report(),
        "analyses_completed": len(lichess.analyses),
        "moves_completed": len(lichess.moves),
        "workdir": str(supervisor.workdir),
    }


def check_report(report: Dict, metrics_text: str) -> None:
    """The scenario's audit over a :func:`scenario_report` and the run's
    ``/metrics`` text: the ledger clean (0 lost, 0 duplicated) with work
    completed, a SIGKILL and a restart seen and counted, every drained
    process exited 0, and the fleet families exported. Raises
    AssertionError; sets ``metric_families``."""
    fleet = report["fleet"]
    kinds = [kind for _, _, kind in report["events"]]
    if not fleet["clean"]:
        raise AssertionError(f"fleet ledger dirty: {fleet}")
    if fleet["completed"] < 1:
        raise AssertionError(f"fleet completed nothing: {report}")
    if "kill" not in kinds:
        raise AssertionError(f"no SIGKILL fired: {kinds}")
    if "restart" not in kinds:
        raise AssertionError(f"no restart observed: {kinds}")
    if report["restarts"] < 1:
        raise AssertionError("restart counter never moved")
    bad_exits = {n: rc for n, rc in report["exit_codes"].items() if rc != 0}
    if bad_exits:
        raise AssertionError(
            f"fleet drain exited nonzero: {bad_exits} "
            f"(logs under {report['workdir']})"
        )
    missing = [f for f in REQUIRED_FAMILIES
               if f"# TYPE {f} " not in metrics_text]
    report["metric_families"] = sorted(REQUIRED_FAMILIES)
    if missing:
        raise AssertionError(f"/metrics missing families: {missing}")


async def run_chaos(
    procs: int = 3,
    seconds: float = 12.0,
    metrics_port: int = 0,
    drain_deadline: float = 5.0,
    verbose: int = 0,
    fleet_port: Optional[int] = None,
) -> Dict:
    """Run the fleet scenario; returns the report dict (key ``ok``).
    Raises AssertionError on a contract violation.

    ``fleet_port`` (0 = ephemeral) additionally runs a
    :class:`~fishnet_tpu_torch.telemetry.fleet.FleetAggregator` over the
    supervisor's port-file directory for the duration (the federated
    /metrics and /fleet routes stay scrapeable through every kill) and
    folds its final state document into the report under
    ``fleet_observability``."""
    from fishnet_tpu_torch import telemetry
    from fishnet_tpu_torch.utils.logger import Logger

    fake_server_mod = _load_fake_server()
    logger = Logger(verbose=verbose, stderr=True)
    report: Dict = {"procs": procs, "ok": False}
    exporter = telemetry.start_exporter(metrics_port)
    supervisor: Optional[FleetSupervisor] = None
    aggregator = None
    try:
        lichess = chaos_lichess(fake_server_mod, procs)
        with fake_server_mod.FakeServer(lichess) as server:
            supervisor = FleetSupervisor(
                server.endpoint,
                fleet_specs(procs),
                logger=logger,
                tick_seconds=0.2,
                drain_deadline=drain_deadline,
            )
            await supervisor.start()
            if fleet_port is not None:
                from fishnet_tpu_torch.telemetry.fleet import (
                    FleetAggregator,
                    port_dir_targets,
                )

                aggregator = FleetAggregator(
                    targets_fn=port_dir_targets(str(supervisor.workdir)),
                    poll_interval=0.3,
                    journal_dir=str(supervisor.workdir),
                ).start()
                fleet_exporter = aggregator.serve(fleet_port)
                logger.info(
                    f"fleet aggregator on {fleet_exporter.url}/fleet"
                )
            t0 = time.monotonic()
            while time.monotonic() - t0 < seconds:
                await asyncio.sleep(0.25)
            if aggregator is not None:
                # Final sweep + state doc BEFORE drain, while the
                # children still answer.
                report["fleet_observability"] = await asyncio.to_thread(
                    observed, aggregator)
            exit_codes = await supervisor.drain()
            report.update(scenario_report(supervisor, lichess, exit_codes))
            report["seconds"] = round(time.monotonic() - t0, 2)
            supervisor = None  # drained; skip the error-path kill_all
        check_report(report, await asyncio.to_thread(_scrape, exporter.port))
        report["ok"] = True
        return report
    finally:
        if aggregator is not None:
            aggregator.close()
        if supervisor is not None:
            await supervisor.kill_all()
        exporter.close()
        telemetry.disable()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch.cluster.chaos",
        description="Fleet chaos soak: client processes under kills, "
        "drains and partitions, exactly-once audited.",
    )
    parser.add_argument("--procs", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=12.0)
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="telemetry port for the run (0 = ephemeral)",
    )
    parser.add_argument(
        "--drain-deadline", type=float, default=5.0,
        help="drain deadline handed to every client process (seconds)",
    )
    parser.add_argument(
        "--fleet-port", type=int, default=None,
        help="also run the fleet aggregator over the supervised procs "
             "and serve /fleet on this port (0 = ephemeral)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)
    try:
        report = asyncio.run(
            run_chaos(
                procs=args.procs,
                seconds=args.seconds,
                metrics_port=args.metrics_port,
                drain_deadline=args.drain_deadline,
                verbose=args.verbose,
                fleet_port=args.fleet_port,
            )
        )
    except AssertionError as err:
        print(f"CHAOS FAILED: {err}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
