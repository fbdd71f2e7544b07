"""The az-mcts engine: batched-PUCT MCTS behind the engine seam.

The port of ``fishnet_tpu/engine/az_engine.py``. Like tpu-nnue it
serves every worker from one shared batched evaluator, but the search
is PUCT over the AlphaZero-style policy+value net (BASELINE.json config
5) instead of alpha-beta over NNUE. The AZ family serves standard
chess; when the factory is given a ``variant_fallback``, variant
positions route to it (the native alpha-beta tier on the host), as the
reference runs variant work on Fairy-Stockfish (src/queue.rs:530-539).

Topology mirrors SearchService: one driver thread steps the MctsPool
(collect leaves from every live search -> one microbatch on the shared
AZ dispatch plane, search/az_plane.py -> expand and back up), while
asyncio workers await futures. ``close()`` tears the pool, and the
plane it owns, down with the driver thread.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from fishnet_tpu_torch.engine.base import Engine, EngineError, EngineFactory
from fishnet_tpu_torch.ipc import Position, PositionResponse
from fishnet_tpu_torch.protocol.types import EngineFlavor, Matrix, Score, Variant
from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool, MctsResult

# Analysis node budgets are calibrated for alpha-beta nodes; a PUCT visit
# costs ~3 orders of magnitude more compute, so scale the protocol's node
# budget down to a visit budget (reference servers send ~1.5M nodes;
# /1024 gives ~1.5k visits, a sound default analysis depth for a net).
# This static mapping is only the CEILING: the service measures actual
# visits/second (EWMA, same pattern as utils/stats.py NpsRecorder) and
# the per-search budget is clamped so a slow net or a loaded batch still
# finishes inside the server's per-ply timeout
# (reference doc/protocol.md:32: e.g. 7000 ms).
NODES_PER_VISIT = 1024

#: Floor on any analysis visit budget: below this the PV/score are too
#: noisy to submit even under deadline pressure; the hard movetime stop
#: is what actually guarantees the timeout then.
MIN_ANALYSIS_VISITS = 64

#: Fraction of the per-ply timeout the calibrated budget aims at,
#: leaving headroom for queueing + harvest latency.
TIMEOUT_TARGET_FRACTION = 0.8


@dataclass
class _PendingSearch:
    future: asyncio.Future
    loop: asyncio.AbstractEventLoop
    deadline: Optional[float]
    token: object = None


class AzMctsService:
    """Owns the MctsPool and its driver thread. ``params`` is the
    JAX-layout dict of numpy arrays (models/az.py); the pool's plane
    runs the tower on ``device``, ``cuda`` unless the caller asks for
    the CPU (a CUDA request without a GPU raises here), over the shards
    ``devices`` (the plane's serving mesh; None: ``device`` alone)."""

    def __init__(self, params: Dict, cfg: MctsConfig = MctsConfig(),
                 device=None, devices=None) -> None:
        self.pool = MctsPool(params, cfg, device=device, devices=devices)
        self._pending: Dict[int, _PendingSearch] = {}
        self._submissions: List[tuple] = []
        self._cancelled_tokens: set = set()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopping = False
        # Measured visits/second (EWMA alpha=0.9, the stats.py pattern),
        # observed per completed search UNDER LOAD — so it already folds
        # in batching/queueing delays, which is what deadline math needs.
        self._visit_rate: Optional[float] = None
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="az-mcts-driver")
        self._thread.start()

    async def search(self, root_fen: str, moves: List[str], visits: int,
                     movetime_seconds: Optional[float] = None,
                     multipv: int = 1) -> MctsResult:
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        token = object()
        with self._lock:
            if self._stopping:
                raise EngineError("az-mcts service is shut down")
            self._submissions.append(
                (root_fen, moves, visits, movetime_seconds, future, loop,
                 multipv, token)
            )
        self._wake.set()
        try:
            return await future
        except asyncio.CancelledError:
            # Caller timed out / was cancelled (worker budget): stop the
            # underlying search so it frees its batch slots instead of
            # draining its full visit budget as an orphan.
            with self._lock:
                self._cancelled_tokens.add(token)
            self._wake.set()
            raise

    def visits_per_second(self) -> Optional[float]:
        """Measured per-search visit throughput; None until the first
        completed search."""
        with self._lock:
            return self._visit_rate

    def pool_counters(self) -> Dict:
        """Tree- and dispatch-side stats (visits, collisions, batch
        fill, subtree-reuse hits, the plane's dispatch and pre-wire
        counters)."""
        return self.pool.counters()

    def close(self) -> None:
        with self._lock:
            self._stopping = True
        self._wake.set()
        self._thread.join(timeout=60)
        # The driver is down: release the evaluator (the shared plane's
        # pipelines when this pool owns its plane).
        self.pool.close()

    # -- driver thread ----------------------------------------------------

    def _drive(self) -> None:
        try:
            self.pool.warmup()
            self._drive_inner()
        except Exception as err:  # noqa: BLE001 - driver must not die silently
            with self._lock:
                self._stopping = True
                pending = list(self._pending.values())
                self._pending.clear()
                subs = self._submissions
                self._submissions = []
            for p in pending:
                p.loop.call_soon_threadsafe(
                    _set_exception_if_waiting, p.future,
                    EngineError(f"az-mcts driver crashed: {err!r}"))
            for sub in subs:
                sub[4].get_loop().call_soon_threadsafe(
                    _set_exception_if_waiting, sub[4],
                    EngineError(f"az-mcts driver crashed: {err!r}"))
            raise

    def _drive_inner(self) -> None:
        while True:
            if self._stopping:
                with self._lock:
                    pending = list(self._pending.values())
                    self._pending.clear()
                    subs, self._submissions = self._submissions, []
                err = EngineError("az-mcts service shut down")
                for p in pending:
                    p.loop.call_soon_threadsafe(
                        _set_exception_if_waiting, p.future, err)
                for sub in subs:  # queued but never submitted: fail, don't hang
                    sub[5].call_soon_threadsafe(
                        _set_exception_if_waiting, sub[4], err)
                return

            with self._lock:
                submissions, self._submissions = self._submissions, []
                cancelled, self._cancelled_tokens = self._cancelled_tokens, set()
            for fen, moves, visits, movetime, future, loop, multipv, token in submissions:
                if token in cancelled:
                    cancelled.discard(token)
                    continue
                try:
                    sid = self.pool.submit(fen, moves, visits, multipv=multipv)
                except Exception as err:  # noqa: BLE001 - bad position
                    loop.call_soon_threadsafe(
                        _set_exception_if_waiting, future,
                        EngineError(f"submit failed: {err!r}"))
                    continue
                deadline = time.monotonic() + movetime if movetime else None
                self._pending[sid] = _PendingSearch(future, loop, deadline, token)

            now = time.monotonic()
            for sid, p in self._pending.items():
                if p.token in cancelled:
                    self.pool.stop_search(sid)
                elif p.deadline is not None and now >= p.deadline:
                    self.pool.stop_search(sid)

            evaluated = self.pool.step()

            for sid in self.pool.finished():
                p = self._pending.pop(sid, None)
                result = self.pool.harvest(sid)
                if result.visits > 0 and result.time_seconds > 0.02:
                    rate = result.visits / result.time_seconds
                    with self._lock:
                        self._visit_rate = (
                            rate if self._visit_rate is None
                            else 0.9 * self._visit_rate + 0.1 * rate
                        )
                if p is not None:
                    p.loop.call_soon_threadsafe(_set_result_if_waiting,
                                                p.future, result)

            if evaluated == 0 and self.pool.active() == 0:
                got = self._wake.wait(timeout=0.05)
                if got:
                    self._wake.clear()


def _set_result_if_waiting(future: asyncio.Future, result) -> None:
    if not future.done():
        future.set_result(result)


def _set_exception_if_waiting(future: asyncio.Future, err: BaseException) -> None:
    if not future.done():
        future.set_exception(err)


class AzMctsEngine(Engine):
    def __init__(self, service: AzMctsService, flavor: EngineFlavor) -> None:
        self.service = service
        self.flavor = flavor

    async def close(self) -> None:
        # The service is shared and outlives individual engine handles.
        return None

    async def go(self, position: Position) -> PositionResponse:
        if position.variant is not Variant.STANDARD:
            raise EngineError("az-mcts serves standard chess only")
        work = position.work
        if work.is_analysis:
            nodes = work.nodes.get(position.flavor.eval_flavor())
            visits = max(MIN_ANALYSIS_VISITS, nodes // NODES_PER_VISIT)
            movetime = None
            multipv = work.effective_multipv()
            timeout = work.timeout_seconds()
            if timeout > 0:
                # Calibrate the visit budget to the measured rate so the
                # search *plans* to finish inside the per-ply timeout,
                # and arm the movetime watchdog as the hard guarantee
                # (an early stop still returns the partial result).
                rate = self.service.visits_per_second()
                if rate is not None:
                    visits = min(
                        visits,
                        max(MIN_ANALYSIS_VISITS,
                            int(rate * timeout * TIMEOUT_TARGET_FRACTION)),
                    )
                movetime = timeout
        else:
            level = work.level
            visits = 1 << 20  # bounded by movetime, not visits
            movetime = level.movetime_ms() / 1000.0
            multipv = 1

        try:
            result = await self.service.search(
                position.root_fen, position.moves, visits, movetime,
                multipv=multipv,
            )
        except EngineError:
            raise
        except Exception as err:  # noqa: BLE001
            raise EngineError(f"az-mcts search failed: {err!r}") from err

        if result.best_move is None:
            # Terminal root: report mate/stalemate like the UCI driver does.
            board_outcome_mate = result.value <= -0.999
            scores = Matrix()
            pvs = Matrix()
            scores.set(1, 0, Score.mate(0) if board_outcome_mate else Score.cp(0))
            pvs.set(1, 0, [])
            return PositionResponse(
                work=work, position_id=position.position_id,
                scores=scores, pvs=pvs, best_move=None, depth=0,
                nodes=0, time_seconds=result.time_seconds, nps=None,
                url=position.url,
            )

        scores = Matrix()
        pvs = Matrix()
        depth = max(1, result.depth)
        for line in result.lines or []:
            scores.set(line.multipv, depth, Score.cp(line.cp))
            pvs.set(line.multipv, depth, line.pv)
        if not result.lines:
            scores.set(1, depth, Score.cp(result.cp))
            pvs.set(1, depth, result.pv)
        nodes = result.visits * NODES_PER_VISIT  # protocol-comparable scale
        nps = int(nodes / result.time_seconds) if result.time_seconds > 0 else None
        return PositionResponse(
            work=work, position_id=position.position_id,
            scores=scores, pvs=pvs, best_move=result.best_move,
            depth=depth, nodes=nodes, time_seconds=result.time_seconds,
            nps=nps, url=position.url,
        )


class _VariantRoutingEngine(Engine):
    """Serves standard positions with az-mcts and variant positions with
    the fallback engine (HCE alpha-beta), mirroring the reference where
    play/variant work runs on Fairy-Stockfish while the analysis engine
    differs (src/queue.rs:530-539)."""

    def __init__(self, az: Engine, fallback: Engine) -> None:
        self.az = az
        self.fallback = fallback

    async def go(self, position: Position) -> PositionResponse:
        if position.variant is Variant.STANDARD:
            return await self.az.go(position)
        return await self.fallback.go(position)

    async def close(self) -> None:
        await self.az.close()
        await self.fallback.close()


class AzMctsEngineFactory(EngineFactory):
    def __init__(self, service: AzMctsService,
                 variant_fallback: Optional[EngineFactory] = None) -> None:
        self.service = service
        self.variant_fallback = variant_fallback

    async def create(self, flavor: EngineFlavor) -> Engine:
        az = AzMctsEngine(self.service, flavor)
        if self.variant_fallback is None:
            return az
        fallback = await self.variant_fallback.create(flavor)
        return _VariantRoutingEngine(az, fallback)

    def close(self) -> None:
        self.service.close()
        if self.variant_fallback is not None:
            self.variant_fallback.close()
