"""Deterministic instant engine for tests.

The port's copy of ``fishnet_tpu/engine/mock.py``.

Produces well-formed PositionResponses without any search: scores derive
from the position hash (stable across runs), terminal positions report
the same way real engines do (``mate 0`` for checkmate, ``cp 0`` for
stalemate, depth 0, no bestmove — what Stockfish emits on a finished
game, cf. doc/protocol.md:99-104).
"""

from __future__ import annotations

import asyncio
from typing import Optional

from fishnet_tpu_torch.chess import Board
from fishnet_tpu_torch.engine.base import Engine, EngineFactory, EngineError
from fishnet_tpu_torch.ipc import Position, PositionResponse
from fishnet_tpu_torch.protocol.types import EngineFlavor, Matrix, Score


class MockEngine(Engine):
    def __init__(
        self,
        flavor: EngineFlavor,
        delay_seconds: float = 0.0,
        fail_on: Optional[str] = None,
        hang_on: Optional[str] = None,
    ) -> None:
        self.flavor = flavor
        self.delay = delay_seconds
        self.fail_on = fail_on  # root fen+moves substring triggering EngineError
        self.hang_on = hang_on  # ... triggering a hang (for budget tests)
        self.closed = False

    async def go(self, position: Position) -> PositionResponse:
        if self.closed:
            raise EngineError("engine is closed")
        key = f"{position.root_fen} {' '.join(position.moves)}#{position.position_id}"
        if self.fail_on is not None and self.fail_on in key:
            raise EngineError("mock engine failure")
        if self.hang_on is not None and self.hang_on in key:
            await asyncio.sleep(3600)
        if self.delay:
            await asyncio.sleep(self.delay)

        board = Board(position.root_fen, position.variant)
        for uci in position.moves:
            board.push_uci(uci)

        scores = Matrix()
        pvs = Matrix()

        outcome = board.outcome()
        if outcome in (Board.CHECKMATE, Board.STALEMATE, Board.DRAW):
            score = Score.mate(0) if outcome == Board.CHECKMATE else Score.cp(0)
            scores.set(1, 0, score)
            pvs.set(1, 0, [])
            return PositionResponse(
                work=position.work,
                position_id=position.position_id,
                scores=scores,
                pvs=pvs,
                best_move=None,
                depth=0,
                nodes=0,
                time_seconds=0.0,
                nps=None,
                url=position.url,
            )

        legal = board.legal_moves()
        multipv = position.work.effective_multipv()
        depth = position.work.depth or 12
        nodes = (
            position.work.nodes.get(position.flavor.eval_flavor())
            if position.work.is_analysis
            else 10_000
        )
        for rank in range(1, min(multipv, len(legal)) + 1):
            # Deterministic pseudo-eval from the position hash.
            cp = (board.zobrist_hash() + rank) % 200 - 100
            scores.set(rank, depth, Score.cp(int(cp)))
            pvs.set(rank, depth, [legal[rank - 1]])

        return PositionResponse(
            work=position.work,
            position_id=position.position_id,
            scores=scores,
            pvs=pvs,
            best_move=legal[0],
            depth=depth,
            nodes=nodes,
            time_seconds=max(self.delay, 0.001),
            nps=int(nodes / max(self.delay, 0.001)),
            url=position.url,
        )

    async def close(self) -> None:
        self.closed = True


class MockEngineFactory(EngineFactory):
    def __init__(self, **engine_kwargs) -> None:
        self.engine_kwargs = engine_kwargs
        self.created: list = []

    async def create(self, flavor: EngineFlavor) -> Engine:
        engine = MockEngine(flavor, **self.engine_kwargs)
        self.created.append(engine)
        return engine
