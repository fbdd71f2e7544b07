"""Batch scheduler: validates acquired games, expands them into per-ply
positions, schedules positions to workers, reassembles results, and
submits completed batches.

The port's copy of ``fishnet_tpu/sched/queue.py``, with its metrics
(``fishnet_batches_*``, ``fishnet_queue_exceptions_total``, the
``fishnet_queue_*`` gauges and, with a lane scheduler installed,
``fishnet_lane_depth`` and ``fishnet_tenant_positions_served``), its
``queue.schedule`` fault site (a fault there drops the batch like an
invalid one) and its exactly-once ledger calls (resilience/accounting.py:
scheduled, stepped, requeued, flushed, invalid, abandoned) and its
spans (``schedule`` under the batch trace's root, ``queue_wait`` at each
worker pull, gated on ``telemetry.enabled()``).
``QueueStub.depth`` is the drain's progress report. The
single-stream client queues positions in one FIFO deque, as the
reference's ``VecDeque`` does: a move job waits behind the analysis
positions queued before it. The multi-tenant front end
(sched/frontend.py) installs a ``LaneScheduler`` instead: two priority
lanes x N tenants with deficit round robin. Behavioral
equivalent of the reference's queue layer (src/queue.rs):

* acquired games are replayed move-by-move at the trust boundary before
  any engine sees them (queue.rs:543-552) — here via the native Board;
* a game expands into one Position per ply, root first (queue.rs:571-600),
  honoring ``skipPositions`` (queue.rs:602-606) with the all-skipped
  edge case completing immediately (queue.rs:608-621);
* engine flavor: standard-chess analysis -> OFFICIAL (NNUE); variants and
  all best-move jobs -> MULTI_VARIANT (HCE) (queue.rs:530-539);
* any position failure abandons the whole batch silently so the server
  reassigns it by timeout (queue.rs:207-214);
* partial progress is reported every 2 x cores completed positions, with
  the first part forced to null — lila distinguishes progress reports
  from final analysis by the first part (queue.rs:286-300, 686-697);
* acquire pacing: user/system backlog thresholds plus the NPS-derived
  minimum, polling the server's /status (queue.rs:331-365).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.chess import (
    Board,
    InvalidFenError,
    UnsupportedVariantError,
)
from fishnet_tpu_torch.ipc import Position, PositionFailed, PositionResponse
from fishnet_tpu_torch.net.api import ApiStub
from fishnet_tpu_torch.protocol.types import (
    AcquiredKind,
    AcquireResponseBody,
    AnalysisPart,
    AnalysisPartJson,
    EngineFlavor,
    Variant,
    Work,
)
from fishnet_tpu_torch.resilience import accounting as _accounting
from fishnet_tpu_torch.resilience import faults as _faults
from fishnet_tpu_torch.resilience.shedding import (
    LANE_LATENCY,
    LANE_THROUGHPUT,
    LANES,
)
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.telemetry import tracing as _tracing
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS
from fishnet_tpu_torch.utils.backoff import RandomizedBackoff
from fishnet_tpu_torch.utils.logger import Logger, ProgressAt, QueueStatusBar
from fishnet_tpu_torch.utils.stats import NpsRecorder, Stats, StatsRecorder


#: How many times a batch may be requeued after position failures
#: before it is abandoned to the server's reassignment timeout. Caps
#: the retry loop a deterministically-failing position would otherwise
#: spin forever (doc/resilience.md).
MAX_REQUEUE_GENERATIONS = 2

_REQUEUED = _telemetry.REGISTRY.counter(
    "fishnet_batches_requeued_total",
    "Failed positions re-queued for retry (bounded generations).",
)
_FLUSHED = _telemetry.REGISTRY.counter(
    "fishnet_batches_flushed_total",
    "Batches flushed as partial analyses by the per-batch deadline "
    "budget.",
)
_ABANDONED = _telemetry.REGISTRY.counter(
    "fishnet_batches_abandoned_total",
    "Batches abandoned to the server's reassignment timeout.",
    labelnames=("reason",),
)
_QUEUE_ERRORS = _telemetry.REGISTRY.counter(
    "fishnet_queue_exceptions_total",
    "Unexpected exceptions caught (and survived) by the queue actor.",
)

#: DRR quantum: positions a tenant may drain from the throughput lane
#: per scheduling turn. Large enough to keep a whole small batch
#: together (cache-friendly for the coalescer), small enough that no
#: tenant monopolizes a turn.
DRR_QUANTUM = 8


def lane_of_work(work: Work) -> str:
    """Best-move jobs ride the latency lane; analysis the throughput
    lane (resilience/shedding.py)."""
    return LANE_LATENCY if work.is_move else LANE_THROUGHPUT


class _Skip:
    """Sentinel marking a skipped position (distinct from None = not yet
    analysed), mirroring the reference's Skip<T> (queue.rs:495-505)."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "SKIP"


SKIP = _Skip()


class IncomingError(Exception):
    pass


class AllSkipped(IncomingError):
    def __init__(self, completed: "CompletedBatch") -> None:
        super().__init__("all positions skipped")
        self.completed = completed


@dataclass
class IncomingBatch:
    work: Work
    flavor: EngineFlavor
    variant: Variant
    positions: List[object]  # Position | SKIP
    url: Optional[str] = None

    @classmethod
    def from_acquired(
        cls, endpoint: str, body: AcquireResponseBody
    ) -> "IncomingBatch":
        """Validate + expand an acquired game (queue.rs:516-627). Raises
        IncomingError for invalid games, AllSkipped for the empty edge."""
        url = body.batch_url(endpoint)

        if body.variant.is_standard and body.work.is_analysis:
            flavor = EngineFlavor.OFFICIAL
        else:
            flavor = EngineFlavor.MULTI_VARIANT

        try:
            board = Board(body.position, body.variant)
        except (InvalidFenError, UnsupportedVariantError) as err:
            raise IncomingError(f"invalid position: {err}") from err
        root_fen = board.fen()

        # Trust-boundary legality replay; also normalizes each move's UCI
        # (e.g. e1g1 -> e1h1 castling notation).
        moves: List[str] = []
        replay = board.copy()
        for uci in body.moves:
            normalized = replay.normalize_uci(uci)
            if normalized is None:
                raise IncomingError(f"illegal move {uci!r}")
            replay.push_uci(normalized)
            moves.append(normalized)

        if body.work.is_move:
            positions: List[object] = [
                Position(
                    work=body.work,
                    position_id=0,
                    flavor=flavor,
                    variant=body.variant,
                    root_fen=root_fen,
                    moves=moves,
                    url=url,
                )
            ]
        else:
            positions = []
            for ply in range(len(moves) + 1):
                positions.append(
                    Position(
                        work=body.work,
                        position_id=ply,
                        flavor=flavor,
                        variant=body.variant,
                        root_fen=root_fen,
                        moves=moves[:ply],
                        url=f"{url}#{ply}" if url else None,
                    )
                )
            for skip in body.skip_positions:
                if 0 <= skip < len(positions):
                    positions[skip] = SKIP

            if all(p is SKIP for p in positions):
                now = time.monotonic()
                raise AllSkipped(
                    CompletedBatch(
                        work=body.work,
                        flavor=flavor,
                        variant=body.variant,
                        positions=[SKIP] * len(positions),
                        started_at=now,
                        completed_at=now,
                        url=url,
                    )
                )

        return cls(
            work=body.work,
            flavor=flavor,
            variant=body.variant,
            positions=positions,
            url=url,
        )


@dataclass
class PendingBatch:
    work: Work
    flavor: EngineFlavor
    variant: Variant
    # None = in flight, SKIP = skipped, PositionResponse = done.
    positions: List[object]
    started_at: float
    url: Optional[str] = None
    #: The original Position per index (SKIP for skipped) so a failed
    #: position can be re-queued without re-expanding the batch.
    sources: List[object] = field(default_factory=list)
    #: Requeue generation (bounded by MAX_REQUEUE_GENERATIONS).
    generation: int = 0
    #: The batch's ``schedule`` trace context (telemetry/tracing.py),
    #: set when telemetry is on: ``queue_wait`` spans recorded at
    #: worker-pull time chain under it. None with telemetry off.
    trace: Optional[object] = None
    #: Owning tenant ("" in single-tenant mode) — routes submissions
    #: back through the acquiring tenant's api actor.
    tenant: str = ""
    #: Serving lane (resilience/shedding.py).
    lane: str = LANE_THROUGHPUT

    def pending(self) -> int:
        return sum(1 for p in self.positions if p is None)

    def into_partial_completed(self, now: float) -> "CompletedBatch":
        """Deadline-flush view: everything not yet analysed reports as
        skipped — lila accepts skipped parts, and a partial analysis
        beats wedging the queue behind a hung position."""
        return CompletedBatch(
            work=self.work,
            flavor=self.flavor,
            variant=self.variant,
            positions=[SKIP if p is None else p for p in self.positions],
            started_at=self.started_at,
            completed_at=now,
            url=self.url,
            tenant=self.tenant,
        )

    def try_into_completed(self) -> Optional["CompletedBatch"]:
        if any(p is None for p in self.positions):
            return None
        return CompletedBatch(
            work=self.work,
            flavor=self.flavor,
            variant=self.variant,
            positions=list(self.positions),
            started_at=self.started_at,
            completed_at=time.monotonic(),
            url=self.url,
            tenant=self.tenant,
        )

    def progress_report(self) -> List[Optional[AnalysisPartJson]]:
        report: List[Optional[AnalysisPartJson]] = []
        for i, p in enumerate(self.positions):
            # Lila quirk: the first part must stay null in progress
            # reports (queue.rs:686-697).
            if i > 0 and isinstance(p, PositionResponse):
                report.append(p.to_best())
            else:
                report.append(None)
        return report


@dataclass
class CompletedBatch:
    work: Work
    flavor: EngineFlavor
    variant: Variant
    positions: List[object]  # PositionResponse | SKIP
    started_at: float
    completed_at: float
    url: Optional[str] = None
    tenant: str = ""

    def into_analysis(self) -> List[Optional[AnalysisPartJson]]:
        out: List[Optional[AnalysisPartJson]] = []
        for p in self.positions:
            if p is SKIP:
                out.append(AnalysisPart.skipped())
            else:
                assert isinstance(p, PositionResponse)
                out.append(p.into_matrix() if p.work.matrix_wanted else p.to_best())
        return out

    def into_best_move(self) -> Optional[str]:
        for p in self.positions:
            return p.best_move if isinstance(p, PositionResponse) else None
        return None

    def total_positions(self) -> int:
        return sum(1 for p in self.positions if p is not SKIP)

    def total_nodes(self) -> int:
        return sum(p.nodes for p in self.positions if isinstance(p, PositionResponse))

    def nps(self) -> Optional[int]:
        elapsed = self.completed_at - self.started_at
        if elapsed <= 0:
            return None
        return int(self.total_nodes() / elapsed)


# ---------------------------------------------------------------------------
# Multi-tenant lane scheduler
# ---------------------------------------------------------------------------


class LaneScheduler:
    """Two priority lanes x N tenants with deficit-round-robin fairness.

    Pop order is strict priority: the latency lane (best-move jobs)
    always drains first, plain round-robin across tenants — move jobs
    are rare and tiny, so strict priority cannot starve the bulk lane
    in practice while it guarantees the interactive p99. The
    throughput lane runs classic DRR with unit cost per position: each
    turn a tenant gets ``quantum`` credits and serves until they run
    out or its queue empties, then the turn rotates. Tenants with
    nothing queued hold no turn, so fairness is over *active* tenants
    (max/min served ratio bounded near 1 under sustained load).

    Single-threaded by construction — only the queue's event loop
    touches it; the metrics collector and the /healthz provider read
    ``served``/depths as racy snapshots, which is fine for gauges.
    """

    def __init__(self, quantum: int = DRR_QUANTUM) -> None:
        self.quantum = max(1, int(quantum))
        # lane -> tenant -> FIFO of Position
        self._queues: Dict[str, Dict[str, Deque[Position]]] = {
            lane: {} for lane in LANES
        }
        self._rings: Dict[str, Deque[str]] = {lane: deque() for lane in LANES}
        self._credit: Dict[str, int] = {}  # throughput-lane DRR deficits
        # Control-plane admission weights: a tenant's DRR turn refills
        # round(quantum * weight) credits (min 1). Missing = 1.0.
        self._weights: Dict[str, float] = {}
        #: Positions handed to workers, per tenant (fairness measure).
        self.served: Dict[str, int] = {}

    def set_tenant_weights(self, weights: Optional[Dict[str, float]]) -> None:
        """Control-plane actuation: REPLACE the admission-weight map
        (None or {} restores unweighted DRR). Weights scale the credit
        refill, so they reshape sustained throughput shares without
        ever starving a tenant — every active tenant still gets a turn
        with at least one credit."""
        self._weights = dict(weights) if weights else {}

    def tenant_weights(self) -> Dict[str, float]:
        return dict(self._weights)

    def push(
        self, position: Position, tenant: str, lane: str,
        front: bool = False,
    ) -> None:
        queues = self._queues[lane]
        q = queues.get(tenant)
        if q is None:
            q = queues[tenant] = deque()
        if front:
            q.appendleft(position)
        else:
            q.append(position)
        ring = self._rings[lane]
        if tenant not in ring:
            ring.append(tenant)

    def _pop_latency(self) -> Optional[Position]:
        ring = self._rings[LANE_LATENCY]
        queues = self._queues[LANE_LATENCY]
        while ring:
            q = queues.get(ring[0])
            if not q:
                ring.popleft()
                continue
            position = q.popleft()
            ring.rotate(-1)
            return position
        return None

    def _pop_throughput(self) -> Optional[Position]:
        ring = self._rings[LANE_THROUGHPUT]
        queues = self._queues[LANE_THROUGHPUT]
        while ring:
            tenant = ring[0]
            q = queues.get(tenant)
            if not q:
                # Queue drained mid-turn: the tenant leaves the ring
                # (and forfeits leftover credit) until new work arrives.
                ring.popleft()
                self._credit.pop(tenant, None)
                continue
            credit = self._credit.get(tenant)
            if credit is None:
                weight = self._weights.get(tenant, 1.0)
                credit = self._credit[tenant] = max(
                    1, int(round(self.quantum * weight))
                )
            if credit <= 0:
                # Turn over: rotate to the back; credit refills on the
                # next visit.
                del self._credit[tenant]
                ring.rotate(-1)
                continue
            self._credit[tenant] = credit - 1
            return q.popleft()
        return None

    def pop(self) -> Optional[Position]:
        position = self._pop_latency()
        if position is None:
            position = self._pop_throughput()
        return position

    def note_served(self, tenant: str) -> None:
        self.served[tenant] = self.served.get(tenant, 0) + 1

    def drop_batch(self, batch_id: str) -> int:
        """Remove every queued position of ``batch_id``; returns the
        number removed."""
        dropped = 0
        for queues in self._queues.values():
            for tenant, q in queues.items():
                kept = deque(p for p in q if p.work.id != batch_id)
                dropped += len(q) - len(kept)
                queues[tenant] = kept
        return dropped

    def clear(self) -> int:
        """Drop everything (hard shutdown); returns the count dropped."""
        dropped = len(self)
        for lane in LANES:
            self._queues[lane] = {}
            self._rings[lane].clear()
        self._credit.clear()
        return dropped

    def depth(self, lane: str) -> int:
        return sum(len(q) for q in self._queues[lane].values())

    def depths(self) -> Dict[str, int]:
        return {lane: self.depth(lane) for lane in LANES}

    def __len__(self) -> int:
        return sum(self.depth(lane) for lane in LANES)


# ---------------------------------------------------------------------------
# Queue state shared between stub and actor
# ---------------------------------------------------------------------------


def _register_queue_collector(state: "QueueState") -> int:
    """Expose queue depth as gauges, computed at scrape time from the
    live QueueState: positions in flight, batch count, incoming queue
    depth, backlog seconds (age of the oldest pending batch) and move
    submissions waiting. Holds only a weakref, so a finished client's
    state is collectable (the collector then unregisters itself); reads
    are snapshot copies and never mutate. With a lane scheduler
    installed (the multi-tenant front end, sched/frontend.py) it adds
    ``fishnet_lane_depth{lane}`` and
    ``fishnet_tenant_positions_served{tenant}``."""
    ref = weakref.ref(state)

    def collect():
        st = ref()
        if st is None:
            return None
        batches = list(st.pending.values())
        oldest = min((b.started_at for b in batches), default=None)
        backlog = 0.0 if oldest is None else max(
            0.0, time.monotonic() - oldest
        )
        families = [
            _telemetry.gauge_family(
                "fishnet_queue_pending_positions",
                "Positions assigned to workers but not yet analysed.",
                sum(b.pending() for b in batches),
            ),
            _telemetry.gauge_family(
                "fishnet_queue_pending_batches",
                "Acquired batches not yet fully analysed.", len(batches),
            ),
            _telemetry.gauge_family(
                "fishnet_queue_incoming_positions",
                "Positions queued for worker pull.", st.incoming_len(),
            ),
            _telemetry.gauge_family(
                "fishnet_queue_backlog_seconds",
                "Age of the oldest pending batch.", backlog,
            ),
            _telemetry.gauge_family(
                "fishnet_queue_move_submissions",
                "Completed move jobs awaiting submission.",
                len(st.move_submissions),
            ),
        ]
        sched = st.scheduler
        if sched is not None:
            families.append(_telemetry.MetricFamily(
                "fishnet_lane_depth", "gauge",
                "Positions queued per serving lane.",
                [
                    _telemetry.Sample(
                        "fishnet_lane_depth", float(depth), {"lane": lane}
                    )
                    for lane, depth in sched.depths().items()
                ],
            ))
            families.append(_telemetry.MetricFamily(
                "fishnet_tenant_positions_served", "gauge",
                "Positions handed to workers, per tenant (fairness).",
                [
                    _telemetry.Sample(
                        "fishnet_tenant_positions_served",
                        float(count), {"tenant": tenant},
                    )
                    for tenant, count in sorted(sched.served.items())
                ],
            ))
        return families

    return _telemetry.REGISTRY.register_collector(collect, name="queue")


class QueueState:
    def __init__(
        self,
        cores: int,
        stats: StatsRecorder,
        logger: Logger,
        batch_deadline: Optional[float] = None,
        scheduler: Optional[LaneScheduler] = None,
        api_router=None,
    ) -> None:
        self.shutdown_soon = False
        self.cores = cores
        self.incoming: Deque[Position] = deque()
        self.pending: Dict[str, PendingBatch] = {}
        self.move_submissions: Deque[CompletedBatch] = deque()
        self.stats_recorder = stats
        self.logger = logger
        #: Per-batch deadline budget (seconds); None = no deadline.
        self.batch_deadline = batch_deadline
        #: Multi-tenant mode: a LaneScheduler replaces the single
        #: ``incoming`` deque (every access goes through the
        #: ``incoming_*`` methods below, which keep the single-stream
        #: FIFO path when no scheduler is installed).
        self.scheduler = scheduler
        #: Callable[[tenant], Optional[ApiStub]] — routes submissions
        #: back through the acquiring tenant's api actor. None in
        #: single-tenant mode (the stub/actor default applies).
        self.api_router = api_router

    # -- incoming-queue access (FIFO deque vs lane scheduler) -------------

    def incoming_len(self) -> int:
        if self.scheduler is not None:
            return len(self.scheduler)
        return len(self.incoming)

    def incoming_push(
        self, position: Position, tenant: str = "",
        lane: str = LANE_THROUGHPUT, front: bool = False,
    ) -> None:
        if self.scheduler is not None:
            self.scheduler.push(position, tenant, lane, front=front)
        elif front:
            self.incoming.appendleft(position)
        else:
            self.incoming.append(position)

    def incoming_pop(self) -> Optional[Position]:
        if self.scheduler is not None:
            return self.scheduler.pop()
        return self.incoming.popleft() if self.incoming else None

    def incoming_drop_batch(self, batch_id: str) -> None:
        if self.scheduler is not None:
            self.scheduler.drop_batch(batch_id)
        else:
            self.incoming = deque(
                p for p in self.incoming if p.work.id != batch_id
            )

    def incoming_clear(self) -> None:
        if self.scheduler is not None:
            self.scheduler.clear()
        else:
            self.incoming.clear()

    def api_for(self, batch, default: ApiStub) -> ApiStub:
        """The api stub that owns ``batch`` (its tenant's actor in
        multi-tenant mode, the shared default otherwise)."""
        if self.api_router is not None and batch.tenant:
            stub = self.api_router(batch.tenant)
            if stub is not None:
                return stub
        return default

    def flush_expired(self, api: ApiStub) -> int:
        """Enforce the per-batch deadline budget: analysis batches older
        than the budget are submitted PARTIALLY (unanalysed plies marked
        skipped); expired move jobs are aborted (a stale move is
        useless). Cheap when nothing is pending or no deadline is set;
        called from the worker-pull hot points so one hung engine can
        never wedge every other batch behind it."""
        if self.batch_deadline is None or not self.pending:
            return 0
        now = time.monotonic()
        flushed = 0
        for batch_id in list(self.pending):
            batch = self.pending[batch_id]
            if now - batch.started_at <= self.batch_deadline:
                continue
            del self.pending[batch_id]
            self.incoming_drop_batch(batch_id)
            led = _accounting.get()
            if batch.work.is_analysis:
                _FLUSHED.inc()
                if led is not None:
                    led.record_flushed(batch_id)
                completed = batch.into_partial_completed(now)
                done = sum(
                    1 for p in completed.positions
                    if isinstance(p, PositionResponse)
                )
                self.logger.error(
                    f"Batch {batch.url or batch_id} exceeded its "
                    f"{self.batch_deadline:.0f}s deadline; flushing "
                    f"{done}/{len(completed.positions)} analysed plies."
                )
                self.api_for(batch, api).submit_analysis(
                    completed.work.id,
                    completed.flavor.eval_flavor(),
                    completed.into_analysis(),
                    final=True,
                )
            else:
                _ABANDONED.inc(reason="deadline")
                if led is not None:
                    led.record_abandoned(batch_id, "deadline")
                self.logger.error(
                    f"Move job {batch_id} exceeded its deadline; aborting."
                )
                self.api_for(batch, api).abort(batch_id)
            flushed += 1
        return flushed

    def status_bar(self) -> QueueStatusBar:
        return QueueStatusBar(
            pending=sum(p.pending() for p in self.pending.values()), cores=self.cores
        )

    def try_pull(self, callback: asyncio.Future) -> bool:
        """Serve a queued position to a worker callback; False if empty."""
        position = self.incoming_pop()
        if position is None:
            return False
        batch = self.pending.get(position.work.id)
        if not callback.done():
            if _telemetry.enabled():
                # "queue_wait" span: this position's dwell in the
                # incoming queue, from batch enqueue to this pull — a
                # child of the batch's schedule span (the context
                # stashed on PendingBatch at accept time).
                if batch is not None and batch.trace is not None:
                    _SPANS.record(
                        "queue_wait", batch.started_at,
                        trace=batch.trace.child(),
                        batch=position.work.id,
                        position_id=position.position_id,
                    )
            callback.set_result(position)
            if self.scheduler is not None and batch is not None:
                self.scheduler.note_served(batch.tenant)
            return True
        # Callback abandoned (worker gone): keep the position, front of
        # its own lane/tenant queue so ordering is preserved.
        if batch is not None:
            self.incoming_push(
                position, tenant=batch.tenant, lane=batch.lane, front=True
            )
        else:
            self.incoming_push(position, front=True)
        return True

    def add_incoming_batch(
        self,
        batch: IncomingBatch,
        trace: Optional[object] = None,
        tenant: str = "",
    ) -> None:
        batch_id = batch.work.id
        if batch_id in self.pending:
            self.logger.error(f"Dropping duplicate incoming batch {batch_id}")
            return
        lane = lane_of_work(batch.work)
        if tenant:
            # Stamp the originating tenant onto every position BEFORE
            # the push loop and the ``sources`` copy below, so both the
            # first pass and any requeue carry it down to the engine
            # tier. Position is frozen — replace, don't mutate.
            batch.positions = [
                p if p is SKIP else dataclasses.replace(p, tenant=tenant)
                for p in batch.positions
            ]
        placeholders: List[object] = []
        for pos in batch.positions:
            if pos is SKIP:
                placeholders.append(SKIP)
            else:
                placeholders.append(None)
                self.incoming_push(pos, tenant=tenant, lane=lane)
        self.pending[batch_id] = PendingBatch(
            work=batch.work,
            flavor=batch.flavor,
            variant=batch.variant,
            positions=placeholders,
            started_at=time.monotonic(),
            url=batch.url,
            sources=list(batch.positions),
            trace=trace,
            tenant=tenant,
            lane=lane,
        )
        led = _accounting.get()
        if led is not None:
            led.record_scheduled(batch_id)
        self.logger.progress(
            self.status_bar(), ProgressAt(batch_id=batch_id, batch_url=batch.url)
        )


# ---------------------------------------------------------------------------
# Stub + actor
# ---------------------------------------------------------------------------


@dataclass
class Pull:
    """The work-stealing handshake (ipc.rs:100-115): a worker hands back
    its previous result (if any) and a future to receive the next job."""

    response: Optional[object]  # PositionResponse | PositionFailed | None
    callback: asyncio.Future


class QueueStub:
    def __init__(
        self,
        tx: "asyncio.Queue",
        interrupt: asyncio.Event,
        state: QueueState,
        api: ApiStub,
    ) -> None:
        self._tx: Optional[asyncio.Queue] = tx
        self._interrupt = interrupt
        self._state = state
        self._api = api

    async def pull(self, pull: Pull) -> None:
        if pull.response is not None:
            self._handle_position_response(pull.response)
        # Deadline budget: every worker handoff checks for expired
        # batches, so a single hung engine cannot wedge the rest of the
        # queue behind its batch.
        self._state.flush_expired(self._api)
        if self._state.try_pull(pull.callback):
            return
        if self._state.shutdown_soon and not self._state.incoming_len():
            # Drain complete for this worker; release it (the reference
            # releases workers by dropping their callbacks, main.rs:374-382).
            if not pull.callback.done():
                pull.callback.cancel()
            return
        if self._tx is not None:
            await self._tx.put(pull.callback)
        elif not pull.callback.done():
            pull.callback.cancel()

    def _handle_position_response(self, res: object) -> None:
        state = self._state
        if isinstance(res, PositionFailed):
            self._handle_position_failed(res)
            return
        assert isinstance(res, PositionResponse)
        batch = state.pending.get(res.work.id)
        if batch is not None and 0 <= res.position_id < len(batch.positions):
            batch.positions[res.position_id] = res
            led = _accounting.get()
            if led is not None:
                led.record_stepped(res.work.id)
        state.logger.progress(
            state.status_bar(),
            ProgressAt(
                batch_id=res.work.id, batch_url=res.url, position_id=res.position_id
            ),
        )
        self._maybe_finished(res.work.id)

    def _handle_position_failed(self, res: PositionFailed) -> None:
        """Requeue a failed position (bounded generations) instead of
        abandoning the whole batch on the first transient engine
        failure. The requeued position goes to the FRONT of the
        incoming queue so an older batch's retry is served before fresh
        acquires' positions (acquire order preserved — a failed batch
        can no longer starve behind new work). Producers that do not
        identify the position (legacy PositionFailed without
        position_id), and batches over the generation cap, keep the
        reference behavior: abandon silently, the server reassigns by
        timeout (queue.rs:207-214)."""
        state = self._state
        batch = state.pending.get(res.batch_id)
        if batch is None:
            return
        src = None
        if res.position_id is not None and (
            0 <= res.position_id < len(batch.sources)
        ):
            src = batch.sources[res.position_id]
        led = _accounting.get()
        if (
            src is None
            or src is SKIP
            or batch.generation >= MAX_REQUEUE_GENERATIONS
        ):
            reason = (
                "requeue_cap" if batch.generation >= MAX_REQUEUE_GENERATIONS
                else "position_failed"
            )
            state.pending.pop(res.batch_id, None)
            state.incoming_drop_batch(res.batch_id)
            _ABANDONED.inc(reason=reason)
            if led is not None:
                led.record_abandoned(res.batch_id, reason)
            state.logger.warn(
                f"Abandoning batch {batch.url or res.batch_id} ({reason}); "
                "the server will reassign it."
            )
            return
        batch.generation += 1
        _REQUEUED.inc()
        if led is not None:
            led.record_requeued(res.batch_id, batch.generation)
        state.incoming_push(
            src, tenant=batch.tenant, lane=batch.lane, front=True
        )
        state.logger.debug(
            f"Requeued position {res.position_id} of {res.batch_id} "
            f"(generation {batch.generation}/{MAX_REQUEUE_GENERATIONS})."
        )

    def _maybe_finished(self, batch_id: str) -> None:
        state = self._state
        pending = state.pending.pop(batch_id, None)
        if pending is None:
            return
        completed = pending.try_into_completed()
        if completed is None:
            if not pending.work.matrix_wanted:
                report = pending.progress_report()
                done = sum(1 for p in report if p is not None)
                if done and done % (state.cores * 2) == 0:
                    state.api_for(pending, self._api).submit_analysis(
                        pending.work.id, pending.flavor.eval_flavor(), report
                    )
            state.pending[batch_id] = pending
            return

        # Batch completion ticks the eval cache's eviction clock
        # (search/eval_cache.py): entries inserted while this batch was
        # live age one generation, so under memory pressure the cache
        # sheds dead batches' positions before the live working set.
        # Purely an eviction-ordering signal: no value is invalidated.
        cache = eval_cache.get_cache()
        if cache is not None:
            cache.advance_generation()
            # The fleet tier shares the clock: any process's batch
            # completion ages the whole segment, so fixed-slot
            # replacement prefers positions no live batch is visiting.
            from fishnet_tpu_torch.cluster import position_tier

            tier = position_tier.get_tier()
            if tier is not None:
                tier.advance_generation()
        extra = []
        short = completed.variant.short_name()
        if short:
            extra.append(short)
        if completed.flavor.eval_flavor().is_hce:
            extra.append("hce")
        nps = completed.nps()
        if nps is not None:
            nnue_nps = nps if completed.flavor is EngineFlavor.OFFICIAL else None
            state.stats_recorder.record_batch(
                completed.total_positions(), completed.total_nodes(), nnue_nps
            )
            extra.append(f"{nps // 1000} knps")
        else:
            extra.append("? nps")
        label = completed.url or batch_id
        log = f"{state.status_bar()} {label} finished ({', '.join(extra)})"

        if completed.work.is_analysis:
            state.logger.info(log)
            state.api_for(completed, self._api).submit_analysis(
                completed.work.id,
                completed.flavor.eval_flavor(),
                completed.into_analysis(),
                final=True,
            )
        else:
            state.logger.debug(log)
            state.move_submissions.append(completed)
            self._move_submitted()

    def _move_submitted(self) -> None:
        if self._tx is not None:
            self._tx.put_nowait("move_submitted")
            self._interrupt.set()

    def shutdown_soon(self) -> None:
        self._state.shutdown_soon = True
        if self._tx is not None:
            self._tx.put_nowait("wake")
        self._tx = None
        self._interrupt.set()

    def shutdown(self) -> None:
        self.shutdown_soon()
        led = _accounting.get()
        for batch_id in list(self._state.pending):
            batch = self._state.pending.pop(batch_id)
            if led is not None:
                led.record_abandoned(batch_id, "shutdown_abort")
            self._state.api_for(batch, self._api).abort(batch_id)
        # Finished move jobs not submitted yet (the queue stops chasing
        # move submissions once shutdown_soon runs) go back too, or the
        # server would hold them until its timeout. The JAX package's
        # queue leaves them (ROADMAP C16 covers the drain's side).
        while self._state.move_submissions:
            completed = self._state.move_submissions.popleft()
            if led is not None:
                led.record_abandoned(completed.work.id, "shutdown_abort")
            self._state.api_for(completed, self._api).abort(completed.work.id)
        # The queued positions belonged to the batches just aborted;
        # drop them too so the drain check sees an empty queue.
        self._state.incoming_clear()

    def depth(self) -> Dict[str, int]:
        """Remaining-work snapshot (graceful drain's readiness body,
        resilience/drain.py): batches still pending, their unanalysed
        positions, and positions queued for worker pull."""
        state = self._state
        return {
            "batches": len(state.pending),
            "positions": sum(b.pending() for b in state.pending.values()),
            "queued": state.incoming_len(),
        }

    def stats(self) -> Tuple[Stats, NpsRecorder]:
        return (
            self._state.stats_recorder.stats,
            self._state.stats_recorder.nnue_nps,
        )


@dataclass
class BacklogOpt:
    """Backlog thresholds in seconds (reference: configure.rs:231-276;
    'short' = 30 s, 'long' = 1 h)."""

    user: Optional[float] = None
    system: Optional[float] = None


class QueueActor:
    def __init__(
        self,
        rx: "asyncio.Queue",
        interrupt: asyncio.Event,
        state: QueueState,
        api: ApiStub,
        backlog: BacklogOpt,
        logger: Logger,
        max_backoff: float = 30.0,
    ) -> None:
        self.rx = rx
        self.interrupt = interrupt
        self.state = state
        self.api = api
        self.backlog = backlog
        self.logger = logger
        self.backoff = RandomizedBackoff(max_backoff)

    async def backlog_wait_time(self) -> Tuple[float, bool]:
        """(seconds to wait before acquiring, slow?) — queue.rs:331-365."""
        min_user = self.state.stats_recorder.min_user_backlog()
        user_backlog = max(min_user, self.backlog.user or 0.0)
        system_backlog = self.backlog.system or 0.0

        if user_backlog >= 1.0 or system_backlog >= 1.0:
            status = await self.api.status()
            if status is not None:
                user_wait = max(0.0, user_backlog - status.user.oldest_seconds)
                system_wait = max(0.0, system_backlog - status.system.oldest_seconds)
                slow = user_wait >= system_wait + 1.0
                return min(user_wait, system_wait), slow
            self.logger.debug("Queue status not available. Will not delay acquire.")
            return 0.0, user_backlog >= system_backlog + 1.0
        return 0.0, False

    async def _interruptible_sleep(self, seconds: float) -> None:
        self.interrupt.clear()
        try:
            await asyncio.wait_for(self.interrupt.wait(), timeout=seconds)
        except asyncio.TimeoutError:
            pass

    async def handle_acquired(self, body: AcquireResponseBody) -> None:
        context = body.work.id
        # "schedule" span: trust-boundary replay + per-ply expansion +
        # enqueue — the stage between acquire and the search pipeline.
        # Its trace context parents into the batch trace by digest
        # (tracing.batch_child: the acquire root's span id IS the
        # deterministic trace id, no cross-actor plumbing needed).
        tel = _telemetry.enabled()
        t0 = time.monotonic() if tel else 0.0
        sched_ctx = _tracing.batch_child(context) if tel else None
        try:
            # "queue.schedule" fault site: a failure here is a
            # trust-boundary failure — the batch is dropped like an
            # invalid one and the server reassigns by timeout.
            if _faults.enabled():
                await _faults.fire_async("queue.schedule")
            incoming = IncomingBatch.from_acquired(self.api.endpoint, body)
        except AllSkipped as all_skipped:
            self.logger.warn(f"Completed empty batch {context}.")
            completed = all_skipped.completed
            led = _accounting.get()
            if led is not None:
                led.record_scheduled(completed.work.id)
            self.api.submit_analysis(
                completed.work.id,
                completed.flavor.eval_flavor(),
                completed.into_analysis(),
                final=True,
            )
            if tel:
                _SPANS.record(
                    "schedule", t0, trace=sched_ctx,
                    batch=context, outcome="all_skipped",
                )
            return
        except (IncomingError, _faults.FaultInjected) as err:
            self.logger.warn(f"Ignoring invalid batch {context}: {err}")
            led = _accounting.get()
            if led is not None:
                led.record_invalid(context, str(err))
            if tel:
                _SPANS.record(
                    "schedule", t0, trace=sched_ctx,
                    batch=context, outcome="invalid",
                )
            return
        if self.state.shutdown_soon:
            # Accepted while shutting down (an in-flight acquire
            # resolving after shutdown()): nobody will run it. Abandon
            # it through the ledger and hand it back to the server
            # instead of dropping it on the floor.
            _ABANDONED.inc(reason="shutdown_incoming")
            led = _accounting.get()
            if led is not None:
                led.record_abandoned(context, "shutdown_incoming")
            self.api.abort(context)
            if tel:
                _SPANS.record(
                    "schedule", t0, trace=sched_ctx,
                    batch=context, outcome="shutdown",
                )
            return
        self.state.add_incoming_batch(
            incoming, trace=sched_ctx, tenant=self.api.tenant
        )
        if tel:
            _SPANS.record(
                "schedule", t0, trace=sched_ctx,
                batch=context, outcome="accepted",
                positions=len(incoming.positions),
            )

    async def handle_move_submissions(self) -> None:
        while True:
            if self.state.shutdown_soon:
                # Move submissions can chain follow-up jobs; stop chasing
                # them during shutdown (queue.rs:399-404).
                return
            if not self.state.move_submissions:
                return
            completed = self.state.move_submissions.popleft()
            acquired = await self.api.submit_move_and_acquire(
                completed.work.id, completed.into_best_move()
            )
            if acquired is not None and acquired.kind is AcquiredKind.ACCEPTED:
                await self.handle_acquired(acquired.body)

    async def run(self) -> None:
        self.logger.debug("Queue actor started")
        try:
            while True:
                msg = await self.rx.get()
                if msg == "move_submitted":
                    await self.handle_move_submissions()
                    continue
                if msg == "wake":
                    if self.state.shutdown_soon:
                        break
                    continue
                callback: asyncio.Future = msg
                try:
                    await self._pull_loop(callback)
                except asyncio.CancelledError:
                    raise
                except Exception as err:  # noqa: BLE001 - keep the queue alive
                    _QUEUE_ERRORS.inc()
                    self.logger.error(f"Queue error: {err!r}")
                    if not callback.done():
                        callback.cancel()
                if self.state.shutdown_soon and not self.state.incoming_len():
                    break
        finally:
            # Release any workers still parked in the mailbox.
            while not self.rx.empty():
                leftover = self.rx.get_nowait()
                if isinstance(leftover, asyncio.Future) and not leftover.done():
                    leftover.cancel()
            self.logger.debug("Queue actor exited")

    async def _pull_loop(self, callback: asyncio.Future) -> None:
        while True:
            await self.handle_move_submissions()
            self.state.flush_expired(self.api)

            if self.state.try_pull(callback):
                return
            if self.state.shutdown_soon:
                # Drain phase: no more work will come; release the worker.
                if not callback.done():
                    callback.cancel()
                return
            if callback.done():
                return

            wait, slow = await self.backlog_wait_time()
            if wait >= 1.0:
                level = self.logger.info if wait >= 40.0 else self.logger.debug
                level(f"Going idle for {wait:.0f}s.")
                await self._interruptible_sleep(wait)
                continue

            acquired = await self.api.acquire(slow)
            if acquired is None:
                # Transport error: the api actor already backed off.
                continue
            if acquired.kind is AcquiredKind.ACCEPTED:
                self.backoff.reset()
                await self.handle_acquired(acquired.body)
            elif acquired.kind is AcquiredKind.NO_CONTENT:
                backoff = self.backoff.next()
                self.logger.debug(f"No job received. Backing off {backoff:.1f}s.")
                await self._interruptible_sleep(backoff)
            elif acquired.kind is AcquiredKind.REJECTED:
                self.logger.error(
                    "Client update or reconfiguration might be required. Stopping queue."
                )
                self.state.shutdown_soon = True
                if not callback.done():
                    callback.cancel()
                return


def channel(
    cores: int,
    api: ApiStub,
    logger: Logger,
    stats: Optional[StatsRecorder] = None,
    backlog: Optional[BacklogOpt] = None,
    max_backoff: float = 30.0,
    batch_deadline: Optional[float] = None,
) -> Tuple[QueueStub, QueueActor]:
    rx: "asyncio.Queue" = asyncio.Queue()
    interrupt = asyncio.Event()
    state = QueueState(
        cores, stats or StatsRecorder(cores, no_stats_file=True), logger,
        batch_deadline=batch_deadline,
    )
    _register_queue_collector(state)
    stub = QueueStub(rx, interrupt, state, api)
    actor = QueueActor(
        rx, interrupt, state, api, backlog or BacklogOpt(), logger, max_backoff
    )
    return stub, actor
