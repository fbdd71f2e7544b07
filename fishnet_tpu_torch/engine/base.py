"""The engine seam.

The port's copy of ``fishnet_tpu/engine/base.py``: the reference's
per-worker ``StockfishStub::go(Position) -> PositionResponse``
(src/stockfish.rs:45-53) behind which the whole engine implementation can
be swapped. Engines here are:

* ``mock``     — deterministic instant engine for tests;
* ``tpu-nnue`` — the native C++ search core with leaf evaluations batched
                 onto the GPU (the name is the JAX package's);
* ``az-mcts``  — batched PUCT MCTS over the AlphaZero-style policy+value
                 net (engine/az_engine.py).
"""

from __future__ import annotations

import abc

from fishnet_tpu_torch.ipc import EngineError, Position, PositionResponse
from fishnet_tpu_torch.protocol.types import EngineFlavor

__all__ = ["Engine", "EngineFactory", "EngineError"]


class Engine(abc.ABC):
    """One engine instance, owned by one worker at a time."""

    @abc.abstractmethod
    async def go(self, position: Position) -> PositionResponse:
        """Search one position. Raises EngineError on any engine failure
        (the worker will discard this engine and restart with backoff,
        reference src/main.rs:335-341)."""

    @abc.abstractmethod
    async def close(self) -> None:
        """Tear down (kill subprocess / release slots). Idempotent."""


class EngineFactory(abc.ABC):
    """Creates engines per flavor. Workers cache one engine per flavor
    (reference src/main.rs:266-269)."""

    @abc.abstractmethod
    async def create(self, flavor: EngineFlavor) -> Engine:
        ...

    def close(self) -> None:
        """Tear down any shared backend (search service driver threads).
        Called once at client shutdown; a daemon thread left inside
        native code at interpreter exit aborts the process."""
        return None
