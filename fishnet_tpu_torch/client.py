"""Client supervisor: wires the API actor, queue actor, and worker pool.

The port's copy of ``fishnet_tpu/client.py``: with ``tenants`` > 1 the
multi-tenant front end (sched/frontend.py) replaces the single api and
queue actor pair (``FISHNET_NO_MULTITENANT=1`` keeps the single
stream). Equivalent of the reference's run()/worker()
(src/main.rs:76-403):

* one worker task per configured core (or ``workers`` pull loops over a
  shared batched engine), each owning at most one engine per flavor,
  created lazily with randomized restart backoff (main.rs:266-312);
* per-job rolling time budget: min(60 s, remaining) + the job's timeout;
  a hung engine is killed and the position reported failed
  (main.rs:272-273, 316, 343-358);
* workers request work via the Pull handshake and exit when the queue
  cancels their callback (drain); ``queue_depth`` reports what is left
  to the drain's readiness body;
* an engine start is the ``engine.spawn`` fault site: an injected fault
  there fails the position like an ``EngineError`` (requeued at the
  front of the queue, or of its tenant's lane);
* two-phase shutdown: ``shutdown_soon`` stops acquiring and drains
  pending batches, ``shutdown`` additionally aborts them upstream
  (main.rs:217-259).
"""

from __future__ import annotations

import asyncio
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.engine.base import Engine, EngineError, EngineFactory
from fishnet_tpu_torch.ipc import Position, PositionFailed
from fishnet_tpu_torch.net import api as api_mod
from fishnet_tpu_torch.protocol.types import EngineFlavor
from fishnet_tpu_torch.resilience import faults as _faults
from fishnet_tpu_torch.sched import queue as queue_mod
from fishnet_tpu_torch.sched.queue import BacklogOpt, Pull
from fishnet_tpu_torch.utils.backoff import RandomizedBackoff
from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.utils.stats import StatsRecorder
from fishnet_tpu_torch.version import __version__

DEFAULT_BUDGET_SECONDS = 60.0  # main.rs:272
SUMMARY_INTERVAL_SECONDS = 120.0  # main.rs:202


async def worker(
    i: int,
    factory: EngineFactory,
    queue: queue_mod.QueueStub,
    logger: Logger,
    states: Optional[List[str]] = None,
) -> None:
    """``states``: optional shared per-worker state table for the
    telemetry collector — this worker owns (and only writes) slot ``i``
    (values: starting_engine / searching / pulling / stopped)."""
    logger.debug(f"Started worker {i}.")
    job: Optional[Position] = None
    engines: Dict[EngineFlavor, Engine] = {}
    engine_backoff = RandomizedBackoff()
    budget = DEFAULT_BUDGET_SECONDS

    def note(state: str) -> None:
        if states is not None:
            states[i] = state

    try:
        while True:
            response: Optional[object] = None
            if job is not None:
                flavor = job.flavor
                engine = engines.pop(flavor, None)
                if engine is None:
                    backoff = engine_backoff.next()
                    level = logger.info if backoff >= 5.0 else logger.debug
                    level(f"Waiting {backoff:.1f}s before attempting to start engine")
                    await asyncio.sleep(backoff)
                    budget = DEFAULT_BUDGET_SECONDS
                    note("starting_engine")
                    try:
                        # "engine.spawn" fault site: models a failed
                        # engine start (a service rebuild failure) at
                        # the one chokepoint every engine backend
                        # passes through.
                        if _faults.enabled():
                            await _faults.fire_async("engine.spawn")
                        engine = await factory.create(flavor)
                    except (EngineError, _faults.FaultInjected) as err:
                        logger.error(f"Worker {i} failed to start engine: {err}")
                        response = PositionFailed(
                            batch_id=job.work.id, position_id=job.position_id
                        )
                        job = None

                if engine is not None:
                    budget = min(DEFAULT_BUDGET_SECONDS, budget) + job.work.timeout_seconds()
                    started = time.monotonic()
                    note("searching")
                    try:
                        response = await asyncio.wait_for(engine.go(job), timeout=budget)
                        engines[flavor] = engine
                        engine_backoff.reset()
                    except asyncio.TimeoutError:
                        logger.warn(
                            f"Engine timed out in worker {i}. If this happens "
                            "frequently it is better to stop and defer to "
                            f"faster clients. Context: {job.url or job.work.id}"
                        )
                        await engine.close()
                        response = PositionFailed(
                            batch_id=job.work.id, position_id=job.position_id
                        )
                    except asyncio.CancelledError:
                        await engine.close()
                        raise
                    except Exception as err:  # noqa: BLE001 - engine must not kill worker
                        logger.warn(
                            f"Worker {i} engine error: {err!r}. "
                            f"Context: {job.url or job.work.id}"
                        )
                        await engine.close()
                        response = PositionFailed(
                            batch_id=job.work.id, position_id=job.position_id
                        )
                    budget = max(0.0, budget - (time.monotonic() - started))
                    if budget < DEFAULT_BUDGET_SECONDS:
                        logger.debug(f"Low engine timeout budget: {budget:.1f}s")
                    job = None

            callback = asyncio.get_running_loop().create_future()
            note("pulling")
            await queue.pull(Pull(response=response, callback=callback))
            try:
                job = await callback
            except asyncio.CancelledError:
                break
    finally:
        note("stopped")
        for engine in engines.values():
            await engine.close()
        logger.debug(f"Stopped worker {i}")


@dataclass
class Client:
    """A running client instance."""

    endpoint: str
    key: Optional[str]
    cores: int
    engine_factory: EngineFactory
    logger: Logger = field(default_factory=Logger)
    stats: Optional[StatsRecorder] = None
    backlog: Optional[BacklogOpt] = None
    max_backoff: float = 30.0
    # Worker (pull-loop) count; None = one per core, the reference's
    # model, right for engines where a worker OWNS a CPU-bound engine
    # (mock). The batched device engine (tpu-nnue) shares ONE service
    # whose pool serves hundreds of concurrent searches — there a
    # worker is just an async pull loop, and running many per core is
    # what analyzes a batch's ~30 positions CONCURRENTLY instead of one
    # per device round-trip (__main__ sets this from
    # --search-concurrency / an auto default).
    workers: Optional[int] = None
    # Per-batch deadline budget (seconds): a pending batch older than
    # this is FLUSHED — its completed plies submitted, the rest marked
    # skipped — instead of wedging the queue behind a hung engine.
    # None = no deadline (the reference model: the server's own timeout
    # reassigns).
    batch_deadline: Optional[float] = None
    # Concurrent acquire streams (sched/frontend.py). 1 = the classic
    # single-stream client; >1 wires the multi-tenant front end with
    # priority lanes, DRR fairness, and admission control.
    # FISHNET_NO_MULTITENANT=1 forces the single-stream path.
    tenants: int = 1
    # Admission/shedding policy override (tests, the smoke run); None
    # builds the default watermark policy in the front end.
    shed_policy: Optional[object] = None
    # ServiceSupervisor whose ladder rung scales shed capacity.
    supervisor: Optional[object] = None

    _tasks: List[asyncio.Task] = field(default_factory=list)
    _queue_stub: Optional[queue_mod.QueueStub] = None
    _api_actor: Optional[api_mod.ApiActor] = None
    _frontend: Optional[object] = None
    _worker_states: Optional[List[str]] = None
    _collector_token: Optional[int] = None

    def _register_worker_collector(self) -> None:
        """``fishnet_workers{state=...}`` gauge: worker pull loops by
        state, pulled at scrape time from the shared state table (each
        worker single-writes its own slot; the collector reads a
        snapshot)."""
        ref = weakref.ref(self)

        def collect():
            client = ref()
            if client is None or client._worker_states is None:
                return None
            counts: Dict[str, int] = {}
            for s in list(client._worker_states):
                counts[s] = counts.get(s, 0) + 1
            fam = _telemetry.MetricFamily(
                "fishnet_workers", "gauge",
                "Worker pull loops by state.",
                [
                    _telemetry.Sample(
                        "fishnet_workers", n, {"state": state}
                    )
                    for state, n in sorted(counts.items())
                ],
            )
            return [fam]

        self._collector_token = _telemetry.REGISTRY.register_collector(
            collect, name="workers"
        )

    async def start(self) -> None:
        from fishnet_tpu_torch.sched import frontend as frontend_mod

        if frontend_mod.multitenant_enabled(self.tenants):
            frontend = frontend_mod.FrontEnd(
                self.endpoint, self.key, self.logger,
                cores=self.cores,
                tenants=self.tenants,
                stats=self.stats,
                backlog=self.backlog,
                max_backoff=self.max_backoff,
                batch_deadline=self.batch_deadline,
                shed_policy=self.shed_policy,
                supervisor=self.supervisor,
            )
            self._frontend = frontend
            queue_mod._register_queue_collector(frontend.state)
            for name, actor in frontend.api_actors():
                self._tasks.append(
                    asyncio.create_task(actor.run(), name=name)
                )
            queue_stub = frontend.stub
            self._queue_stub = queue_stub
            self._tasks.append(
                asyncio.create_task(frontend.run(), name="queue")
            )
        else:
            api_stub, api_actor = api_mod.channel(
                self.endpoint, self.key, self.logger
            )
            self._api_actor = api_actor
            self._tasks.append(asyncio.create_task(api_actor.run(), name="api"))

            queue_stub, queue_actor = queue_mod.channel(
                cores=self.cores,
                api=api_stub,
                logger=self.logger,
                stats=self.stats,
                backlog=self.backlog,
                max_backoff=self.max_backoff,
                batch_deadline=self.batch_deadline,
            )
            self._queue_stub = queue_stub
            self._tasks.append(
                asyncio.create_task(queue_actor.run(), name="queue")
            )

        n_workers = self.cores if self.workers is None else self.workers
        self._worker_states = ["idle"] * n_workers
        self._register_worker_collector()
        for i in range(n_workers):
            self._tasks.append(
                asyncio.create_task(
                    worker(i, self.engine_factory, queue_stub, self.logger,
                           states=self._worker_states),
                    name=f"worker-{i}",
                )
            )

    def stats_summary(self) -> str:
        assert self._queue_stub is not None
        stats, nnue_nps = self._queue_stub.stats()
        return (
            f"fishnet-tpu-torch/{__version__}: {nnue_nps} (nnue), "
            f"{stats.total_batches:,} batches, {stats.total_positions:,} positions, "
            f"{stats.total_nodes:,} total nodes"
        )

    async def run_summary_loop(self) -> None:
        """Periodic 120 s summary line (main.rs:201-213)."""
        while True:
            await asyncio.sleep(SUMMARY_INTERVAL_SECONDS)
            self.logger.fishnet_info(self.stats_summary())

    def shutdown_soon(self) -> None:
        """First Ctrl-C: stop acquiring, finish pending batches."""
        if self._queue_stub is not None:
            self._queue_stub.shutdown_soon()

    def queue_depth(self) -> Optional[Dict[str, int]]:
        """Remaining-work snapshot (pending batches/positions/queued) —
        the drain readiness body's progress report."""
        if self._queue_stub is None:
            return None
        return self._queue_stub.depth()

    async def wait_drained(self) -> None:
        """Resolve when workers and queue have exited (i.e. a
        ``shutdown_soon`` drain completed); the api actor stays up to
        deliver final submissions."""
        tasks = [
            t for t in self._tasks if not t.get_name().startswith("api")
        ]
        if tasks:
            await asyncio.wait(tasks)

    async def stop(self, abort_pending: bool = True) -> None:
        """Graceful stop. With ``abort_pending`` the server is told to
        reassign unfinished batches immediately (main.rs:248-249)."""
        if self._queue_stub is not None:
            if abort_pending:
                self._queue_stub.shutdown()
            else:
                self._queue_stub.shutdown_soon()

        # Workers + queue drain first; the api actor must outlive them to
        # deliver final submissions/aborts. On an immediate stop
        # (abort_pending) in-flight searches are cancelled almost at once
        # — cancellation propagates to the native search (fc_pool_stop;
        # the reference SIGKILLs its engine subprocesses here,
        # src/stockfish.rs:138); a graceful drain gets the full grace
        # period.
        worker_and_queue = [
            t for t in self._tasks
            if not t.get_name().startswith("api") and not t.done()
        ]
        if worker_and_queue:
            await asyncio.wait(
                worker_and_queue, timeout=2.0 if abort_pending else 30.0
            )
            for t in worker_and_queue:
                if not t.done():
                    t.cancel()

        if self._api_actor is not None:
            self._api_actor.stop()
        if self._frontend is not None:
            for ts in self._frontend.tenants.values():
                ts.actor.stop()
        api_tasks = [
            t for t in self._tasks
            if t.get_name().startswith("api") and not t.done()
        ]
        if api_tasks:
            await asyncio.wait(api_tasks, timeout=10.0)
            for t in api_tasks:
                if not t.done():
                    t.cancel()
        self._tasks.clear()
        if self._collector_token is not None:
            _telemetry.REGISTRY.unregister_collector(self._collector_token)
            self._collector_token = None
