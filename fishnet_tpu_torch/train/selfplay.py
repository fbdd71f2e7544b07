"""Self-play data generation for the AZ policy+value family: the port of
``fishnet_tpu/train/selfplay.py``.

Many games play themselves concurrently over one ``MctsPool``, so every
game's PUCT leaves land in the same device microbatches. The pool's
default evaluator is the shared AZ dispatch plane (search/az_plane.py)
on the card; a ``RemoteAzPlane`` (rpc/client.py) sends the leaves to an
evaluator host instead, with the same results. Cross-move subtree reuse
rebases each game's previous tree at every ply (submit keys are
(start_fen, moves), so the one-ply ancestor always hits). Each move
stores (position planes, normalized root visit distribution, side to
move); finished games back-fill the outcome as the value target. The
produced batches feed ``AzTrainer`` directly.

The temperature moves are drawn from ``numpy.random.default_rng(seed)``,
as in the JAX package, so the same root visits give the same games in
both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from fishnet_tpu_torch.chess.board import Board
from fishnet_tpu_torch.models.az_encoding import (
    INPUT_PLANES,
    POLICY_SIZE,
    board_planes,
    move_to_index,
)
from fishnet_tpu_torch.protocol.types import STARTPOS

__all__ = ["SelfPlayConfig", "games_to_batch", "play_games", "selfplay_batch"]


@dataclass(frozen=True)
class SelfPlayConfig:
    games: int = 8
    visits: int = 64
    # Moves sampled proportionally to visits (exploration); afterwards
    # the max-visit move is played.
    temperature_moves: int = 8
    max_plies: int = 160


@dataclass
class _Record:
    planes: np.ndarray
    policy: np.ndarray  # dense [POLICY_SIZE], sums to 1
    stm_white: bool


@dataclass
class _Game:
    board: Board
    moves: List[str] = field(default_factory=list)
    records: List[_Record] = field(default_factory=list)
    outcome_white: Optional[float] = None  # +1 white win, 0 draw, -1 loss


def _game_over(board: Board) -> Optional[float]:
    """White-perspective result if the game has ended, else None."""
    outcome = board.outcome()
    if outcome == Board.ONGOING:
        return None
    white_to_move = board.turn() == "w"
    if outcome in (Board.CHECKMATE, Board.VARIANT_LOSS):
        return -1.0 if white_to_move else 1.0
    if outcome == Board.VARIANT_WIN:
        return 1.0 if white_to_move else -1.0
    return 0.0


def play_games(
    pool,
    cfg: SelfPlayConfig = SelfPlayConfig(),
    seed: int = 0,
    start_fen: str = STARTPOS,
) -> List[_Game]:
    """Play cfg.games concurrent self-play games to completion over
    ``pool`` (an ``MctsPool``)."""
    rng = np.random.default_rng(seed)
    games = [_Game(board=Board(start_fen)) for _ in range(cfg.games)]
    live = {i for i, g in enumerate(games) if _game_over(g.board) is None}

    while live:
        sids = {}
        for i in list(live):
            game = games[i]
            sids[pool.submit(start_fen, game.moves, cfg.visits)] = i
        while pool.active() > 0:
            pool.step()
        for sid, i in sids.items():
            game = games[i]
            result = pool.harvest(sid)
            if result.best_move is None or not result.root_visits:
                game.outcome_white = _game_over(game.board) or 0.0
                live.discard(i)
                continue

            stm_white = game.board.turn() == "w"
            moves = [m for m, _ in result.root_visits]
            visits = np.asarray([n for _, n in result.root_visits], np.float64)
            policy = np.zeros(POLICY_SIZE, np.float32)
            if visits.sum() > 0:
                probs = visits / visits.sum()
            else:
                probs = np.full(len(moves), 1.0 / len(moves))
            for m, p in zip(moves, probs):
                policy[move_to_index(m, stm_white)] = p
            game.records.append(
                _Record(board_planes(game.board.fen()), policy, stm_white)
            )

            if len(game.moves) < cfg.temperature_moves:
                choice = int(rng.choice(len(moves), p=probs))
            else:
                choice = int(np.argmax(visits))
            move = moves[choice]
            game.board.push_uci(move)
            game.moves.append(move)

            over = _game_over(game.board)
            if over is not None:
                game.outcome_white = over
                live.discard(i)
            elif len(game.moves) >= cfg.max_plies:
                game.outcome_white = 0.0  # adjudicate long games as draws
                live.discard(i)
    return games


def games_to_batch(games: List[_Game]) -> Dict[str, np.ndarray]:
    """Flatten finished games into one AzTrainer batch."""
    planes: List[np.ndarray] = []
    policies: List[np.ndarray] = []
    values: List[float] = []
    for game in games:
        z_white = game.outcome_white or 0.0
        for rec in game.records:
            planes.append(rec.planes)
            policies.append(rec.policy)
            values.append(z_white if rec.stm_white else -z_white)
    if not planes:
        # All games were terminal at the start position: empty batch.
        return {
            "planes": np.zeros((0, 8, 8, INPUT_PLANES), np.float32),
            "policy_target": np.zeros((0, POLICY_SIZE), np.float32),
            "value_target": np.zeros((0,), np.float32),
        }
    return {
        "planes": np.stack(planes).astype(np.float32),
        "policy_target": np.stack(policies).astype(np.float32),
        "value_target": np.asarray(values, np.float32),
    }


def selfplay_batch(
    pool,
    cfg: SelfPlayConfig = SelfPlayConfig(),
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """One generation: play games, return a training batch."""
    return games_to_batch(play_games(pool, cfg, seed))
