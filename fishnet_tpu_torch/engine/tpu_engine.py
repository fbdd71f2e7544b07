"""The tpu-nnue engine: the reference's `--engine` seam filled with the
batched search service.

The port's copy of ``fishnet_tpu/engine/tpu_engine.py`` (the engine
keeps the JAX package's name). Where the reference's worker drives a
Stockfish subprocess over UCI (src/stockfish.rs:235-344), this engine
submits the position into the shared SearchService; its alpha-beta runs
as a fiber whose leaf evals are batched with every other in-flight
search onto the GPU. All `go`
parameters follow the reference's mapping (src/stockfish.rs:286-344):
analysis -> node budget per eval flavor (+ optional depth), play ->
movetime/depth by skill level.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from fishnet_tpu_torch.engine.base import Engine, EngineFactory, EngineError
from fishnet_tpu_torch.ipc import Position, PositionResponse
from fishnet_tpu_torch.protocol.types import Clock, EngineFlavor, Matrix, Score
from fishnet_tpu_torch.search.service import SearchResultData, SearchService


def clock_movetime_seconds(clock: Clock, white_to_move: bool) -> float:
    """Clock-derived think-time bound for a play job. The reference
    forwards wtime/btime/winc/binc and the engine's time manager takes
    the minimum of that allocation and the level movetime
    (src/stockfish.rs:307-336 + the engine's own timeman); this is that
    allocation: a 1/40th share of the remaining clock plus most of the
    increment, never more than half the remaining time, floor 10 ms so
    a flagged clock still produces SOME move."""
    mytime_ms = clock.wtime_ms if white_to_move else clock.btime_ms
    alloc_ms = mytime_ms / 40.0 + 0.75 * clock.inc_ms
    alloc_ms = min(alloc_ms, mytime_ms / 2.0)
    return max(alloc_ms, 10.0) / 1000.0


def _white_to_move(root_fen: str, moves: list) -> bool:
    """Side to move after `moves` are applied to `root_fen`."""
    parts = root_fen.split()
    root_white = len(parts) < 2 or parts[1] != "b"
    return root_white == (len(moves) % 2 == 0)


def result_to_response(position: Position, result: SearchResultData) -> PositionResponse:
    scores = Matrix()
    pvs = Matrix()
    for line in result.lines:
        score = Score.mate(line.value) if line.is_mate else Score.cp(line.value)
        scores.set(line.multipv, line.depth, score)
        pvs.set(line.multipv, line.depth, line.pv)
    if scores.best() is None:
        raise EngineError("search returned no score")
    nps = int(result.nodes / result.time_seconds) if result.time_seconds > 0 else None
    return PositionResponse(
        work=position.work,
        position_id=position.position_id,
        scores=scores,
        pvs=pvs,
        best_move=result.best_move,
        depth=result.depth,
        nodes=result.nodes,
        time_seconds=result.time_seconds,
        nps=nps,
        url=position.url,
    )


class TpuNnueEngine(Engine):
    """A lightweight handle; all instances share one SearchService, which
    is the whole point — leaves from every worker land in one batch."""

    def __init__(self, service: SearchService, flavor: EngineFlavor) -> None:
        self.service = service
        self.flavor = flavor

    async def go(self, position: Position) -> PositionResponse:
        work = position.work
        if work.is_analysis:
            nodes = work.nodes.get(position.flavor.eval_flavor())
            depth = work.depth or 0
            multipv = work.effective_multipv()
            movetime = None
            skill = 20
        else:
            # Play job: the reference sends `go movetime <level> depth
            # <level> wtime/btime/winc/binc` with `Skill Level` set
            # (src/stockfish.rs:254-261, 286-336) — here that maps to a
            # depth cap + the tighter of level movetime and the
            # clock-derived allocation, plus native skill weakening.
            level = work.level
            nodes = 0
            depth = level.depth()
            multipv = 1
            movetime = level.movetime_ms() / 1000.0
            skill = level.skill_level()
            if work.clock is not None:
                movetime = min(
                    movetime,
                    clock_movetime_seconds(
                        work.clock,
                        _white_to_move(position.root_fen, position.moves),
                    ),
                )

        try:
            result = await self.service.search(
                root_fen=position.root_fen,
                moves=position.moves,
                nodes=nodes,
                depth=depth,
                multipv=multipv,
                movetime_seconds=movetime,
                variant=position.variant,
                skill_level=skill,
                # The serving lane, as the JAX engine passes it: a
                # latency search keeps the coalescer from lingering.
                lane="throughput" if work.is_analysis else "latency",
                # The acquiring tenant, for the cost plane's owners.
                tenant=getattr(position, "tenant", ""),
            )
        except EngineError:
            raise
        except Exception as err:  # noqa: BLE001 - native/service failure
            raise EngineError(f"search service failed: {err!r}") from err
        return result_to_response(position, result)

    async def close(self) -> None:
        # The service is shared and outlives individual engine handles.
        return None


class TpuNnueEngineFactory(EngineFactory):
    """Hands out engine handles over one shared service; if the service
    dies (driver crash), the next create() builds a replacement — the
    worker pool's restart-with-backoff loop (client.py) then recovers
    exactly like the reference recovers crashed subprocesses
    (src/main.rs:284-312). Pass ``service_builder`` alone to construct
    the first service lazily (and off the event loop)."""

    def __init__(self, service: Optional[SearchService] = None,
                 service_builder=None) -> None:
        if service is None and service_builder is None:
            raise ValueError("need a service or a service_builder")
        self.service = service
        self._builder = service_builder
        self._rebuild_lock = asyncio.Lock()

    async def create(self, flavor: EngineFlavor) -> Engine:
        if (self.service is None or not self.service.is_alive()) and (
            self._builder is not None
        ):
            # After a service death every restarting worker lands here at
            # once; without mutual exclusion each would build (and all but
            # one leak) a full service — driver thread, pool mmap,
            # device-resident params. One worker rebuilds, the rest wait
            # and re-check.
            async with self._rebuild_lock:
                if self.service is None or not self.service.is_alive():
                    old = self.service

                    def rebuild():
                        # Construction (pool mmap, weight save, upload)
                        # and the old driver join can each take seconds:
                        # keep them off the event loop so other workers and
                        # the HTTP actor keep running.
                        svc = self._builder()
                        if old is not None:
                            try:
                                old.close()
                            except Exception:  # noqa: BLE001 - old service broken
                                pass
                        return svc

                    try:
                        self.service = await asyncio.to_thread(rebuild)
                    except Exception as err:  # noqa: BLE001 - keep worker backoff alive
                        raise EngineError(
                            f"engine service rebuild failed: {err!r}"
                        ) from err
        if self.service is None or not self.service.is_alive():
            raise EngineError("engine service is not running")
        return TpuNnueEngine(self.service, flavor)

    def close(self) -> None:
        if self.service is not None:
            self.service.close()
