"""Fleet supervisor: real client processes under a crash/restart
contract.

The port of ``fishnet_tpu/cluster/supervisor.py``.
:class:`FleetSupervisor` spawns one ``python -m fishnet_tpu_torch run``
process per :class:`ProcSpec` (or ``python -m fishnet_tpu_torch.rpc.host``
for the evaluator role), each behind its own
:class:`~fishnet_tpu_torch.cluster.proxy.ChaosProxy`, and monitors the
fleet on a fixed tick. Each process carries its OWN fault plan (parsed
from ``ProcSpec.fault_spec``) shared between its proxy (which polls the
``proxy.*`` sites per forwarded request) and this supervisor (which
polls ``proc.kill`` / ``proc.sigterm`` once per monitor tick, so
``nth=N`` means that process's Nth tick). One plan per process keeps a
whole chaos scenario a set of plain grammar strings, seedable and
replayable.

A process that exits (killed, drained, or crashed on its own) is
restarted under a bounded per-process budget after a deterministic
jittered backoff (``random.Random`` seeded from the process name, so
both packages' supervisors draw the same schedule), incrementing
``fishnet_proc_restarts_total{proc}``. :meth:`drain` is the fleet-wide
shutdown: SIGTERM everyone, wait out the drain deadline, SIGKILL
stragglers, stop the proxies; the evaluator hosts go last, once the
clients whose batches they serve have exited.

Devices: the children run where the port's entry points run by default,
on ``cuda``. ``ProcSpec.extra_args`` carries ``--device cpu`` for a
child that would hold a device on a host without one (the default
``--engine mock`` client holds none).

Observability wiring (``metrics=True``, the default): every child runs
its metrics exporter on an ephemeral port and writes the bound port to
``<workdir>/<name>.port`` (``--metrics-port-file``), and every client
journals its batch spans to ``<workdir>/<name>.journal.jsonl``. That
directory IS the fleet's service discovery: the port's
:class:`~fishnet_tpu_torch.telemetry.fleet.FleetAggregator` re-reads it
every poll (``port_dir_targets``), so a restarted child that rebinds a
fresh port is picked up and a killed child goes stale.
"""

from __future__ import annotations

import asyncio
import os
import random
import signal
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.cluster.proxy import ChaosProxy
from fishnet_tpu_torch.resilience.faults import PLAN_ENV, FaultPlan

_RESTARTS = _telemetry.REGISTRY.counter(
    "fishnet_proc_restarts_total",
    "Client processes restarted by the fleet supervisor, per process.",
    labelnames=("proc",),
)

_REPO_ROOT = Path(__file__).resolve().parents[2]

ROLES = ("monolith", "frontend", "evaluator")


@dataclass
class ProcSpec:
    """One process in the fleet.

    ``key`` doubles as the process's identity on the wire: every
    protocol POST body carries ``fishnet.apikey``, so the fake server's
    fleet ledger attributes handouts and completions per process without
    any header rewriting in the proxy.

    ``role`` selects the split-plane shape: ``monolith`` (default) is
    the self-contained client; ``frontend`` runs the same client with
    ``FISHNET_RPC=1`` so its eval traffic rides the ring transport;
    ``evaluator`` runs ``python -m fishnet_tpu_torch.rpc.host`` serving
    every frontend's link in the supervisor's ``rpc_dir`` (its
    ``extra_args`` name what it serves, e.g. ``--nnue-file``). All three
    ride the same chaos proxies, restart budgets, drain, and metrics
    discovery.
    """

    name: str
    key: Optional[str] = None  # default: the name
    fault_spec: str = ""  # proxy.* + proc.* plan for THIS process
    extra_args: Tuple[str, ...] = ()
    restart_budget: int = 3
    role: str = "monolith"  # monolith | frontend | evaluator

    def __post_init__(self) -> None:
        if self.role not in ROLES:
            raise ValueError(
                f"ProcSpec role must be monolith|frontend|evaluator, "
                f"got {self.role!r}"
            )


@dataclass
class ProcHandle:
    spec: ProcSpec
    plan: Optional[FaultPlan]
    proxy: ChaosProxy
    log_path: Path
    rng: random.Random
    process: Optional[asyncio.subprocess.Process] = None
    restarts: int = 0
    spawns: int = 0
    exit_codes: List[int] = field(default_factory=list)
    monitor: Optional[asyncio.Task] = None


def restart_delay(base: float, restarts: int, rng: random.Random) -> float:
    """The backoff before restart number ``restarts + 1``: linear in the
    restarts so far, jittered by ``rng`` into [0.75, 1.25) of that."""
    return base * (1 + restarts) * (0.75 + 0.5 * rng.random())


class FleetSupervisor:
    """Spawn, chaos-drive, restart and drain a fleet of client
    processes against ``server_endpoint``."""

    def __init__(
        self,
        server_endpoint: str,
        specs: List[ProcSpec],
        *,
        workdir: Optional[str] = None,
        logger=None,
        tick_seconds: float = 0.25,
        drain_deadline: float = 5.0,
        restart_backoff: float = 0.4,
        metrics: bool = True,
        rpc_dir: Optional[str] = None,
    ) -> None:
        self.server_endpoint = server_endpoint
        self.specs = list(specs)
        self.workdir = Path(workdir) if workdir else Path(
            tempfile.mkdtemp(prefix="fishnet-fleet-")
        )
        # Link-file directory for split-role specs (frontend/evaluator);
        # monolith-only fleets never touch it.
        self.rpc_dir = rpc_dir or str(self.workdir / "rpc")
        self.logger = logger
        self.tick_seconds = tick_seconds
        self.drain_deadline = drain_deadline
        self.restart_backoff = restart_backoff
        self.metrics = metrics
        self.procs: Dict[str, ProcHandle] = {}
        #: Chaos/lifecycle timeline: (seconds since start, proc, kind)
        #: with kinds spawn, kill, sigterm, exit:<rc>, restart,
        #: budget-exhausted, drain-sigterm, drain-sigkill.
        self.events: List[Tuple[float, str, str]] = []
        self._t0 = 0.0
        self._stopping = False

    def _log(self, message: str) -> None:
        if self.logger is not None:
            self.logger.info(message)

    def _event(self, proc: str, kind: str) -> None:
        self.events.append((round(time.monotonic() - self._t0, 3), proc, kind))

    async def start(self) -> "FleetSupervisor":
        self._t0 = time.monotonic()
        self.workdir.mkdir(parents=True, exist_ok=True)
        for spec in self.specs:
            plan = FaultPlan.parse(spec.fault_spec) if spec.fault_spec else None
            proxy = await ChaosProxy(
                self.server_endpoint, plan=plan, name=spec.name
            ).start()
            handle = ProcHandle(
                spec=spec,
                plan=plan,
                proxy=proxy,
                log_path=self.workdir / f"{spec.name}.log",
                # str seeding is stable across runs and processes, so a
                # given fleet replays the same backoff schedule.
                rng=random.Random(spec.name),
            )
            self.procs[spec.name] = handle
            await self._spawn(handle)
            handle.monitor = asyncio.create_task(self._monitor(handle))
        return self

    def command(self, handle: ProcHandle) -> List[str]:
        """The child's argv for ``handle``'s role."""
        spec = handle.spec
        port_file = str(self.workdir / f"{spec.name}.port")
        if spec.role == "evaluator":
            # Device-holding half of the split plane: serves every
            # frontend link in rpc_dir; no lichess client underneath.
            cmd = [
                sys.executable, "-m", "fishnet_tpu_torch.rpc.host",
                "--dir", self.rpc_dir,
                *spec.extra_args,
            ]
            if self.metrics:
                cmd += ["--metrics-port", "0", "--metrics-port-file", port_file]
            return cmd
        cmd = [
            sys.executable, "-m", "fishnet_tpu_torch", "run",
            "--no-conf", "--no-stats-file",
            "--engine", "mock",
            "--endpoint", handle.proxy.endpoint,
            "--key", spec.key or spec.name,
            "--cores", "1",
            "--max-backoff", "1s",
            "--drain-deadline", f"{int(self.drain_deadline * 1000)}ms",
            *spec.extra_args,
        ]
        if self.metrics:
            cmd += [
                "--metrics-port", "0",
                "--metrics-port-file", port_file,
                # Batch-span write-ahead: spans recorded after the
                # aggregator's last scrape survive a SIGKILL, so the
                # fleet stitcher can join the dead incarnation's
                # reassigned unit cross-process. Restarts append a new
                # incarnation header to the same file.
                "--spans-journal",
                str(self.workdir / f"{spec.name}.journal.jsonl"),
            ]
        return cmd

    def child_env(self, spec: ProcSpec) -> Dict[str, str]:
        env = dict(os.environ)
        existing = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (
            f"{_REPO_ROOT}{os.pathsep}{existing}" if existing else str(_REPO_ROOT)
        )
        # Chaos lives at the proxy and this supervisor; the child runs
        # a clean, production-shaped client.
        env.pop(PLAN_ENV, None)
        # Role plumbing: a frontend is the SAME client binary with the
        # rpc gate flipped; a monolith must never inherit a split env
        # from the operator's shell.
        if spec.role == "frontend":
            env["FISHNET_RPC"] = "1"
            env["FISHNET_RPC_DIR"] = self.rpc_dir
        else:
            env.pop("FISHNET_RPC", None)
            if spec.role == "evaluator":
                env["FISHNET_RPC_DIR"] = self.rpc_dir
                # The host polls rpc.detach from ITS OWN plan env (the
                # proxy sites are meaningless to it).
                if spec.fault_spec:
                    env[PLAN_ENV] = spec.fault_spec
            else:
                env.pop("FISHNET_RPC_DIR", None)
        return env

    async def _spawn(self, handle: ProcHandle) -> None:
        spec = handle.spec
        with open(handle.log_path, "ab") as logf:
            handle.process = await asyncio.create_subprocess_exec(
                *self.command(handle),
                stdout=logf,
                stderr=asyncio.subprocess.STDOUT,
                cwd=str(self.workdir),
                env=self.child_env(spec),
                start_new_session=True,
            )
        handle.spawns += 1
        self._event(spec.name, "spawn")
        self._log(f"fleet: spawned {spec.name} (pid {handle.process.pid})")

    async def _monitor(self, handle: ProcHandle) -> None:
        name = handle.spec.name
        while not self._stopping:
            await asyncio.sleep(self.tick_seconds)
            if self._stopping:
                return
            process = handle.process
            if process is None:
                return
            rc = process.returncode
            if rc is None:
                rc = await self._poll_exit(process)
            if rc is not None:
                handle.exit_codes.append(rc)
                self._event(name, f"exit:{rc}")
                if handle.restarts >= handle.spec.restart_budget:
                    self._event(name, "budget-exhausted")
                    self._log(f"fleet: {name} restart budget exhausted")
                    return
                await asyncio.sleep(restart_delay(
                    self.restart_backoff, handle.restarts, handle.rng))
                if self._stopping:
                    return
                await self._spawn(handle)
                handle.restarts += 1
                _RESTARTS.inc(proc=name)
                self._event(name, "restart")
                continue
            # Chaos tick: poll BOTH proc sites every tick so nth=N means
            # tick N for each independently.
            plan = handle.plan
            if plan is None:
                continue
            kill_rule = plan.poll("proc.kill")
            term_rule = plan.poll("proc.sigterm")
            if kill_rule is not None:
                self._event(name, "kill")
                self._log(f"fleet: SIGKILL {name} (pid {process.pid})")
                self._signal(process, signal.SIGKILL)
            elif term_rule is not None:
                self._event(name, "sigterm")
                self._log(f"fleet: SIGTERM {name} (pid {process.pid}) -> drain")
                self._signal(process, signal.SIGTERM)

    @staticmethod
    async def _poll_exit(process: asyncio.subprocess.Process) -> Optional[int]:
        try:
            return await asyncio.wait_for(asyncio.shield(process.wait()), 0.01)
        except asyncio.TimeoutError:
            return None

    @staticmethod
    def _signal(process: asyncio.subprocess.Process, sig: int) -> None:
        try:
            process.send_signal(sig)
        except ProcessLookupError:
            pass  # lost the race with its own exit; the monitor sees it

    def metrics_targets(self) -> Dict[str, str]:
        """Current ``{proc_name: exporter_url}`` map from the workdir's
        port files. The fleet aggregator takes the same directory via
        ``targets_fn=port_dir_targets(str(sup.workdir))`` to follow
        restarts live."""
        from fishnet_tpu_torch.telemetry.fleet import port_dir_targets

        return port_dir_targets(str(self.workdir))()

    def live_count(self) -> int:
        return sum(
            1
            for h in self.procs.values()
            if h.process is not None and h.process.returncode is None
        )

    def restarts_total(self) -> int:
        return sum(h.restarts for h in self.procs.values())

    async def drain(self, grace: float = 10.0) -> Dict[str, Optional[int]]:
        """Fleet-wide graceful shutdown. SIGTERM every live process, wait
        out the drain deadline plus ``grace``, SIGKILL stragglers, stop
        the proxies. Returns final exit codes by process.

        Role-aware: the clients (monoliths and frontends) drain first and
        the evaluators only once every client has exited, since a
        frontend's in-flight batches are evaluated on its host; a fleet
        without evaluators drains in one wave, as in the JAX package."""
        self._stopping = True
        for handle in self.procs.values():
            if handle.monitor is not None:
                handle.monitor.cancel()
        await asyncio.gather(
            *(h.monitor for h in self.procs.values() if h.monitor is not None),
            return_exceptions=True,
        )
        exit_codes: Dict[str, Optional[int]] = {}
        for evaluators in (False, True):
            wave = {name: handle for name, handle in self.procs.items()
                    if (handle.spec.role == "evaluator") == evaluators}
            exit_codes.update(await self._drain_wave(wave, grace))
        for handle in self.procs.values():
            await handle.proxy.close()
        return {name: exit_codes[name] for name in self.procs}

    async def _drain_wave(self, wave: Dict[str, ProcHandle],
                          grace: float) -> Dict[str, Optional[int]]:
        for name, handle in wave.items():
            process = handle.process
            if process is not None and process.returncode is None:
                self._event(name, "drain-sigterm")
                self._signal(process, signal.SIGTERM)
        deadline = time.monotonic() + self.drain_deadline + grace
        exit_codes: Dict[str, Optional[int]] = {}
        for name, handle in wave.items():
            process = handle.process
            if process is None:
                exit_codes[name] = (
                    handle.exit_codes[-1] if handle.exit_codes else None
                )
                continue
            remaining = max(0.1, deadline - time.monotonic())
            try:
                rc = await asyncio.wait_for(process.wait(), remaining)
            except asyncio.TimeoutError:
                self._event(name, "drain-sigkill")
                self._log(f"fleet: {name} missed the drain deadline; SIGKILL")
                self._signal(process, signal.SIGKILL)
                rc = await process.wait()
            if not handle.exit_codes or handle.exit_codes[-1] != rc:
                handle.exit_codes.append(rc)
            exit_codes[name] = rc
        return exit_codes

    async def kill_all(self) -> None:
        """Error-path teardown: SIGKILL everything, close proxies."""
        self._stopping = True
        for handle in self.procs.values():
            if handle.monitor is not None:
                handle.monitor.cancel()
            process = handle.process
            if process is not None and process.returncode is None:
                self._signal(process, signal.SIGKILL)
        for handle in self.procs.values():
            if handle.process is not None:
                try:
                    await asyncio.wait_for(handle.process.wait(), 5)
                except asyncio.TimeoutError:
                    pass
            await handle.proxy.close()
