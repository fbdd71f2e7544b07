"""Shared vocabulary between the scheduler and the engine tier.

The port's copy of ``fishnet_tpu/ipc.py``. Equivalent of the
reference's src/ipc.rs: a ``Position`` is one search
job (a slice of a batch), a ``PositionResponse`` its result, and
``PositionFailed`` poisons the whole batch (the scheduler abandons it and
lets the server reassign by timeout, src/queue.rs:207-214).

In the reference these types cross a process boundary to a Stockfish
subprocess; here they cross into the batched GPU engine service.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from fishnet_tpu_torch.protocol.types import (
    AnalysisPart,
    AnalysisPartJson,
    EngineFlavor,
    Matrix,
    Score,
    Variant,
    Work,
)


@dataclass(frozen=True)
class Position:
    """One position to search: root FEN plus the UCI moves leading to it
    (ipc.rs:16-26). ``position_id`` is the ply index within the batch.
    ``tenant`` names the acquire stream the position arrived on (the
    multi-tenant front end stamps it, sched/queue.py), so device cost is
    attributable per tenant (telemetry/cost.py); "" in single-tenant
    mode."""

    work: Work
    position_id: int
    flavor: EngineFlavor
    variant: Variant
    root_fen: str
    moves: List[str] = field(default_factory=list)
    url: Optional[str] = None
    tenant: str = ""


@dataclass
class PositionResponse:
    """Search result for one position (ipc.rs:28-65). ``scores`` and
    ``pvs`` are multipv x depth matrices; ``best`` picks the deepest
    first-PV entry."""

    work: Work
    position_id: int
    scores: Matrix
    pvs: Matrix
    best_move: Optional[str]
    depth: int
    nodes: int
    time_seconds: float
    nps: Optional[int] = None
    url: Optional[str] = None

    def to_best(self) -> AnalysisPartJson:
        score = self.scores.best()
        assert score is not None, "got score"
        pv = self.pvs.best() or []
        return AnalysisPart.best(
            pv=list(pv),
            score=score,
            depth=self.depth,
            nodes=self.nodes,
            time_ms=int(self.time_seconds * 1000),
            nps=self.nps,
        )

    def into_matrix(self) -> AnalysisPartJson:
        return AnalysisPart.matrix(
            pv=self.pvs.to_json(),
            score=self.scores.to_json(),
            depth=self.depth,
            nodes=self.nodes,
            time_ms=int(self.time_seconds * 1000),
            nps=self.nps,
        )


@dataclass(frozen=True)
class PositionFailed:
    """A position the engine tier could not analyse. With
    ``position_id`` the scheduler requeues just that position (bounded
    generations, sched/queue.py); without it (legacy producers) the
    whole batch is abandoned and the server reassigns by timeout."""

    batch_id: str
    position_id: Optional[int] = None


class EngineError(Exception):
    """Engine-tier failure while searching a position."""
