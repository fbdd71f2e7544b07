"""Multi-tenant serving front end: N concurrent acquire streams
multiplexed into the shared coalescer/eval plane.

The port's copy of ``fishnet_tpu/sched/frontend.py``, with its metrics
(``fishnet_tenant_batches_acquired_total{tenant}``,
``fishnet_tenant_batches_shed_total{tenant}``), its ``queue.admit``
fault site, its ``/healthz`` "serving" provider and its ``admit`` span
(a child of the batch trace's root, gated on ``telemetry.enabled()``).

The reference client is one acquire stream feeding one queue; the
north-star deployment is many request sources feeding one accelerator
plane, because that is what keeps device batches full (PAPERS.md
1908.09296 fills Crazyhouse batches from concurrent games the same
way). This module is that multiplexing layer:

* each **tenant** owns a full ``net/api.py`` channel — its own actor
  task, error backoff, 429 suspension, and submit breaker, so one
  misbehaving stream cannot suspend traffic for the rest;
* all tenants feed one shared :class:`~fishnet_tpu_torch.sched.queue.QueueState`
  whose :class:`~fishnet_tpu_torch.sched.queue.LaneScheduler` splits work
  into a latency lane (best-move) and a throughput lane (analysis)
  with deficit-round-robin fairness across tenants;
* admission control (:class:`~fishnet_tpu_torch.resilience.shedding.ShedPolicy`)
  bounds the throughput lane: past the high watermark, analysis
  batches are **shed** — abandoned through the exactly-once ledger and
  aborted back to the server (which reassigns them), never silently
  lost — while shed-aware pacing slows every tenant's acquire stream
  until the queue drains under the low watermark;
* workers keep pulling through the ordinary ``QueueStub``; when the
  queue is empty their callbacks park here and are served the moment
  any tenant admits a batch.

``FISHNET_NO_MULTITENANT=1`` (or ``--tenants 1``) disables all of
this: the client wires the classic single-stream actor pair and no
code in this module runs.
"""

from __future__ import annotations

import asyncio
import os
import time
import weakref
from collections import deque
from typing import Deque, Dict, List, Optional

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.net import api as api_mod
from fishnet_tpu_torch.protocol.types import AcquiredKind, AcquireResponseBody
from fishnet_tpu_torch.resilience import accounting as _accounting
from fishnet_tpu_torch.resilience import faults as _faults
from fishnet_tpu_torch.resilience.shedding import (
    ADMIT,
    LANE_LATENCY,
    LANE_THROUGHPUT,
    SHED,
    ShedPolicy,
)
from fishnet_tpu_torch.resilience.supervisor import (
    any_breaker_open,
    breaker_states,
)
from fishnet_tpu_torch.sched.queue import (
    _ABANDONED,
    _QUEUE_ERRORS,
    BacklogOpt,
    LaneScheduler,
    QueueActor,
    QueueState,
    QueueStub,
    lane_of_work,
)
from fishnet_tpu_torch.telemetry import tracing as _tracing
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS
from fishnet_tpu_torch.utils.backoff import RandomizedBackoff
from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.utils.stats import StatsRecorder

#: Escape hatch: restores the single-stream client path byte-for-byte
#: regardless of --tenants.
NO_MULTITENANT_ENV = "FISHNET_NO_MULTITENANT"

_TENANT_ACQUIRED = _telemetry.REGISTRY.counter(
    "fishnet_tenant_batches_acquired_total",
    "Batches acquired per tenant stream.",
    labelnames=("tenant",),
)
_TENANT_SHED = _telemetry.REGISTRY.counter(
    "fishnet_tenant_batches_shed_total",
    "Batches shed (accounted abort back to the server) per tenant.",
    labelnames=("tenant",),
)


def multitenant_enabled(tenants: int) -> bool:
    """True when the multi-tenant front end should be wired."""
    return tenants > 1 and os.environ.get(NO_MULTITENANT_ENV) != "1"


class TenantStream:
    """One acquire stream: an api channel plus a helper QueueActor
    whose ``handle_acquired`` does the trust-boundary expansion (the
    helper's mailbox loop never runs — the front end is the loop)."""

    def __init__(self, name: str, stub, actor, helper: QueueActor) -> None:
        self.name = name
        self.stub = stub
        self.actor = actor
        self.helper = helper
        self.acquired = 0
        self.shed = 0
        self.rejected = False


class FrontEnd:
    """The multiplexer: owns the shared queue state, the per-tenant
    channels, and the admission/shedding policy. ``run()`` is the
    queue task; the per-tenant api actors are separate tasks the
    client schedules (``api_actors()``)."""

    def __init__(
        self,
        endpoint: str,
        key: Optional[str],
        logger: Logger,
        cores: int,
        tenants: int = 4,
        stats: Optional[StatsRecorder] = None,
        backlog: Optional[BacklogOpt] = None,
        max_backoff: float = 30.0,
        batch_deadline: Optional[float] = None,
        shed_policy: Optional[ShedPolicy] = None,
        supervisor=None,
    ) -> None:
        if tenants < 2:
            raise ValueError("FrontEnd needs >= 2 tenants")
        self.logger = logger
        self.cores = cores
        self.max_backoff = max_backoff
        self.backlog = backlog or BacklogOpt()
        rung_fn = (lambda: supervisor.rung) if supervisor is not None else None
        self.shed_policy = shed_policy or ShedPolicy(
            breaker_open_fn=any_breaker_open, rung_fn=rung_fn,
        )
        self.rx: "asyncio.Queue" = asyncio.Queue()
        self.interrupt = asyncio.Event()
        self.state = QueueState(
            cores,
            stats or StatsRecorder(cores, no_stats_file=True),
            logger,
            batch_deadline=batch_deadline,
            scheduler=LaneScheduler(),
            api_router=self._api_for_tenant,
        )
        self.tenants: Dict[str, TenantStream] = {}
        for i in range(tenants):
            name = f"t{i}"
            stub, actor = api_mod.channel(endpoint, key, logger, tenant=name)
            stub.pacer = api_mod.ShedAwarePacer(
                lambda: self.shed_policy.shed_active, tenant=name
            )
            helper = QueueActor(
                self.rx, self.interrupt, self.state, stub,
                self.backlog, logger, max_backoff,
            )
            self.tenants[name] = TenantStream(name, stub, actor, helper)
        self._default = next(iter(self.tenants.values()))
        self.stub = QueueStub(
            self.rx, self.interrupt, self.state, self._default.stub
        )
        #: Worker callbacks parked while the queue is empty.
        self._waiting: Deque[asyncio.Future] = deque()
        _register_frontend_health(self)

    # -- plumbing ---------------------------------------------------------

    def _api_for_tenant(self, tenant: str):
        ts = self.tenants.get(tenant)
        return ts.stub if ts is not None else None

    def api_actors(self) -> List[tuple]:
        """(name, actor) pairs for the client to schedule as tasks."""
        return [(f"api-{ts.name}", ts.actor) for ts in self.tenants.values()]

    def health_snapshot(self) -> Dict[str, object]:
        """Serving state for /healthz (telemetry/exporter.py). The
        exporter turns ``healthy: False`` into a non-200 so a load
        balancer drains this worker while it sheds."""
        sched = self.state.scheduler
        shed = self.shed_policy.shed_active
        snap: Dict[str, object] = {
            "healthy": not shed,
            "shedding": shed,
            "policy": self.shed_policy.snapshot(),
            "lane_depths": sched.depths() if sched is not None else {},
            "pending_batches": len(self.state.pending),
            "breakers": breaker_states(),
            "tenants": {
                ts.name: {"acquired": ts.acquired, "shed": ts.shed}
                for ts in self.tenants.values()
            },
        }
        return snap

    # -- admission --------------------------------------------------------

    async def _admit(self, ts: TenantStream, body: AcquireResponseBody) -> None:
        """Admission-check one acquired batch, then either schedule it
        (tenant-tagged, through the helper's trust-boundary expansion)
        or shed it: abandon through the ledger + abort upstream so the
        server reassigns it. Nothing is ever silently dropped."""
        context = body.work.id
        lane = lane_of_work(body.work)
        # Positions this batch will enqueue if admitted; known before
        # the (more expensive) legality replay.
        est = 1 if body.work.is_move else len(body.moves) + 1
        tel = _telemetry.enabled()
        t0 = time.monotonic() if tel else 0.0
        sched = self.state.scheduler
        decision = ADMIT
        try:
            # "queue.admit" fault site: an admission-layer failure
            # degrades to a shed — accounted and aborted, never lost.
            if _faults.enabled():
                await _faults.fire_async("queue.admit")
        except _faults.FaultInjected as err:
            self.logger.warn(f"Admission fault for {context}: {err}")
            decision = SHED
        if decision is not SHED:
            decision = self.shed_policy.admit(
                lane, est,
                sched.depth(LANE_THROUGHPUT), sched.depth(LANE_LATENCY),
            )
        if tel:
            _SPANS.record(
                "admit", t0, trace=_tracing.batch_child(context),
                batch=context, tenant=ts.name, lane=lane,
                decision=decision, positions=est,
            )
        if decision is SHED:
            ts.shed += 1
            _TENANT_SHED.inc(tenant=ts.name)
            _ABANDONED.inc(reason="shed")
            led = _accounting.get()
            if led is not None:
                led.record_abandoned(context, "shed")
            ts.stub.abort(context)
            self.logger.debug(
                f"Shed {lane}-lane batch {context} from {ts.name} "
                "(admission control); the server will reassign it."
            )
            return
        ts.acquired += 1
        _TENANT_ACQUIRED.inc(tenant=ts.name)
        await ts.helper.handle_acquired(body)
        self._kick()

    def _kick(self) -> None:
        """Serve parked worker callbacks from the (now non-empty)
        scheduler."""
        while self._waiting and self.state.incoming_len():
            callback = self._waiting.popleft()
            if callback.done():
                continue
            if not self.state.try_pull(callback):
                self._waiting.appendleft(callback)
                return

    # -- the two loop families --------------------------------------------

    async def _acquire_loop(self, ts: TenantStream) -> None:
        """One tenant's continuous acquire stream. Mirrors the
        single-stream actor's pull loop pacing (backlog thresholds,
        no-content backoff, reject stop) with shed-aware pacing layered
        on: while the policy sheds, each round first sleeps a pacing
        quantum, so a saturated queue is not churned with
        acquire/abort cycles any faster than it drains."""
        backoff = RandomizedBackoff(self.max_backoff)
        while not self.state.shutdown_soon:
            try:
                # Deadline budget: the single-stream actor flushes on
                # every pull-loop round; here the acquire rounds are the
                # periodic heartbeat (workers park in ``_waiting`` and
                # cannot drive the check while the queue is empty).
                self.state.flush_expired(ts.stub)
                await ts.stub.pace_acquire()
                if self.state.shutdown_soon:
                    return
                wait, slow = await ts.helper.backlog_wait_time()
                if wait >= 1.0:
                    self.logger.debug(
                        f"Tenant {ts.name} idle for {wait:.0f}s (backlog)."
                    )
                    await self._interruptible_sleep(wait)
                    continue
                acquired = await ts.stub.acquire(slow)
                if self.state.shutdown_soon:
                    if (
                        acquired is not None
                        and acquired.kind is AcquiredKind.ACCEPTED
                    ):
                        # Raced shutdown: hand it straight back, through
                        # the ledger (same contract as queue shutdown).
                        await ts.helper.handle_acquired(acquired.body)
                    return
                if acquired is None:
                    continue  # transport error: the api actor backed off
                if acquired.kind is AcquiredKind.ACCEPTED:
                    backoff.reset()
                    try:
                        await self._admit(ts, acquired.body)
                    except asyncio.CancelledError:
                        # Stream torn down mid-admission (client stop):
                        # the api actor already recorded the acquire, so
                        # close the lifecycle — abandoned + aborted, the
                        # server reassigns. (If the batch DID reach
                        # pending first, the queue-stub shutdown abandons
                        # it again — idempotent, still exactly-once.)
                        led = _accounting.get()
                        if led is not None:
                            led.record_abandoned(
                                acquired.body.work.id, "shutdown_cancelled"
                            )
                        ts.stub.abort(acquired.body.work.id)
                        raise
                elif acquired.kind is AcquiredKind.NO_CONTENT:
                    await self._interruptible_sleep(backoff.next())
                elif acquired.kind is AcquiredKind.REJECTED:
                    self.logger.error(
                        f"Server rejected tenant {ts.name}; stopping its "
                        "acquire stream."
                    )
                    ts.rejected = True
                    if all(t.rejected for t in self.tenants.values()):
                        # Every stream rejected: the client cannot work.
                        self.state.shutdown_soon = True
                        self.rx.put_nowait("wake")
                        self.interrupt.set()
                    return
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001 - keep the stream alive
                _QUEUE_ERRORS.inc()
                self.logger.error(f"Tenant {ts.name} stream error: {err!r}")
                await self._interruptible_sleep(backoff.next())

    async def _interruptible_sleep(self, seconds: float) -> None:
        self.interrupt.clear()
        try:
            await asyncio.wait_for(self.interrupt.wait(), timeout=seconds)
        except asyncio.TimeoutError:
            pass

    async def _handle_move_submissions(self) -> None:
        while True:
            if self.state.shutdown_soon:
                return
            if not self.state.move_submissions:
                return
            completed = self.state.move_submissions.popleft()
            ts = self.tenants.get(completed.tenant) or self._default
            acquired = await ts.stub.submit_move_and_acquire(
                completed.work.id, completed.into_best_move()
            )
            if acquired is not None and acquired.kind is AcquiredKind.ACCEPTED:
                await self._admit(ts, acquired.body)

    async def run(self) -> None:
        """The queue task: per-tenant acquire streams plus the shared
        mailbox loop (worker parking, move submissions, wake)."""
        self.logger.debug(
            f"Front end started ({len(self.tenants)} tenants)."
        )
        streams = [
            asyncio.create_task(
                self._acquire_loop(ts), name=f"tenant-{ts.name}"
            )
            for ts in self.tenants.values()
        ]
        try:
            while True:
                msg = await self.rx.get()
                if msg == "move_submitted":
                    try:
                        await self._handle_move_submissions()
                    except Exception as err:  # noqa: BLE001 - keep serving
                        _QUEUE_ERRORS.inc()
                        self.logger.error(f"Move submission error: {err!r}")
                    continue
                if msg == "wake":
                    if self.state.shutdown_soon:
                        break
                    continue
                callback: asyncio.Future = msg
                # The stub already tried the queue before parking this
                # callback; between then and now an admit may have
                # landed, so try once more before parking.
                if self.state.try_pull(callback):
                    continue
                if self.state.shutdown_soon:
                    if not callback.done():
                        callback.cancel()
                    continue
                self._waiting.append(callback)
        finally:
            # Retire the /healthz serving provider before any await: a
            # hard-cancelled run() must not leave an exited front end
            # reporting serving state until gc happens to collect it.
            from fishnet_tpu_torch.telemetry import exporter as _exporter

            _exporter.unregister_health_provider_if(
                "serving", self._health_provider
            )
            for task in streams:
                task.cancel()
            await asyncio.gather(*streams, return_exceptions=True)
            # Serve what remains of the queue to anyone still parked,
            # then release the rest (drain semantics, like QueueActor).
            self._kick()
            while self._waiting:
                leftover = self._waiting.popleft()
                if not leftover.done():
                    leftover.cancel()
            while not self.rx.empty():
                msg = self.rx.get_nowait()
                if isinstance(msg, asyncio.Future) and not msg.done():
                    msg.cancel()
            self.logger.debug("Front end exited")


def _register_frontend_health(frontend: FrontEnd) -> None:
    """Register the serving-state provider with the exporter's
    /healthz. Weakly referenced: a collected front end silently drops
    out of the report; :meth:`FrontEnd.run` retires it deterministically
    on exit (gc of a cyclic front end can lag the process by a long
    time, and an exited front end has no serving state to report)."""
    from fishnet_tpu_torch.telemetry import exporter as _exporter

    ref = weakref.ref(frontend)

    def provide():
        fe = ref()
        if fe is None:
            return None
        return fe.health_snapshot()

    frontend._health_provider = provide
    _exporter.register_health_provider("serving", provide)
