"""NNUE training-data generation, positions and teacher labels: the port
of ``fishnet_tpu/train/data.py``.

The standard NNUE recipe trains on (position, teacher score, game
outcome) triples. Positions come from seeded random playouts (or any FEN
source); teacher scores come from the port's own batched
``SearchService``, so every labelling search shares the device
microbatches serving uses (on the card: the hand FT-gather kernel, one
launch per device dispatch); outcomes come from the game results.

Output batches feed ``fishnet_tpu_torch.train.Trainer`` directly.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Sequence, Tuple

import numpy as np

from fishnet_tpu_torch.chess.board import Board
from fishnet_tpu_torch.protocol.types import STARTPOS

__all__ = ["label_positions", "playout_positions"]


def playout_positions(
    n_games: int = 8,
    max_plies: int = 60,
    seed: int = 0,
    skip_first: int = 6,
) -> List[Tuple[str, float]]:
    """Random playouts from the start position. Returns (fen,
    white_score) pairs where white_score is the game result for white in
    {0, 0.5, 1}; positions of the first ``skip_first`` plies are skipped
    (near-equal, they teach nothing). The same seed gives the JAX
    package's positions."""
    rng = np.random.default_rng(seed)
    out: List[Tuple[str, float]] = []
    for _ in range(n_games):
        board = Board(STARTPOS)
        fens: List[str] = []
        result = 0.5
        for ply in range(max_plies):
            moves = board.legal_moves()
            outcome = board.outcome()
            if outcome != Board.ONGOING or not moves:
                if outcome == Board.CHECKMATE:
                    result = 0.0 if board.turn() == "w" else 1.0
                else:
                    result = 0.5
                break
            if ply >= skip_first:
                fens.append(board.fen())
            board.push_uci(moves[int(rng.integers(len(moves)))])
        out.extend((fen, result) for fen in fens)
    return out


async def label_positions(
    service,
    positions: Sequence[Tuple[str, float]],
    nodes: int = 2000,
) -> Dict[str, np.ndarray]:
    """Teacher-label positions with fixed-node searches (all batched
    through ``service``, a ``SearchService``) and pack an NNUE training
    batch.

    Returns the Trainer's batch dict: indices int32 [B,2,32] (stm
    perspective, sentinel-padded), buckets int32 [B], score_cp float32
    [B] (from the side to move; mates clamp to +-30000), outcome float32
    [B] in {0,.5,1} from the side to move's perspective. A position
    whose search returned no line is dropped; none left gives an empty
    batch."""
    boards = [Board(fen) for fen, _ in positions]
    results = await asyncio.gather(
        *(service.search(fen, [], nodes=nodes) for fen, _ in positions)
    )

    indices = []
    buckets = []
    scores = []
    outcomes = []
    for (_fen, white_score), board, result in zip(positions, boards, results):
        # One line per (iteration depth, rank): the LAST multipv-1 entry
        # is the deepest completed iteration, the teacher score.
        line = None
        for entry in result.lines:
            if entry.multipv == 1:
                line = entry
        if line is None:
            continue
        value = line.value
        if line.is_mate:
            value = 30000 if line.value > 0 else -30000
        cp = float(np.clip(value, -30000, 30000))
        idx, bucket = board.nnue_features()
        indices.append(idx)
        buckets.append(bucket)
        scores.append(cp)
        stm_white = board.turn() == "w"
        outcomes.append(white_score if stm_white else 1.0 - white_score)
    if not indices:
        return {
            "indices": np.zeros((0, 2, 32), np.int32),
            "buckets": np.zeros((0,), np.int32),
            "score_cp": np.zeros((0,), np.float32),
            "outcome": np.zeros((0,), np.float32),
        }
    return {
        "indices": np.stack(indices).astype(np.int32),
        "buckets": np.asarray(buckets, np.int32),
        "score_cp": np.asarray(scores, np.float32),
        "outcome": np.asarray(outcomes, np.float32),
    }
