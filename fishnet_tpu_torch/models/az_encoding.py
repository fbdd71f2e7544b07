"""Board and move encodings for the AlphaZero-style model family: the
port's copy of ``fishnet_tpu/models/az_encoding.py`` (pure numpy; the
port imports nothing of the JAX package, so it keeps its own).

Everything is encoded from the side to move's perspective: the board is
flipped vertically when black moves, so the network always sees "my
pawns advance toward rank 8". This halves what the net must learn and is
the standard AlphaZero/Lc0 convention.

Input: 19 feature planes over the 8x8 board (own/opponent piece types,
castling rights, en-passant file, halfmove clock, bias plane).

Policy: the AlphaZero 8x8x73 move encoding — for each from-square, 56
queen-move planes (8 directions x up to 7 steps), 8 knight-move planes,
and 9 underpromotion planes (N/B/R x {push, capture-left,
capture-right}). Queen-promotions ride the queen-move planes. 4672
logits total. (The reference has no policy network at all — its engines'
move ordering is hand-crafted C++; this encoding exists for the MCTS
engine of BASELINE.json config 5.)
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

INPUT_PLANES = 19
POLICY_SIZE = 64 * 73

_PIECE_ORDER = "PNBRQK"

# Queen-move directions in (dfile, drank) order; plane = dir * 7 + (dist-1).
_QUEEN_DIRS = [(0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1)]
_KNIGHT_DIRS = [(1, 2), (2, 1), (2, -1), (1, -2), (-1, -2), (-2, -1), (-2, 1), (-1, 2)]
# Underpromotion planes: piece in N, B, R x direction {push, capture-left,
# capture-right} (df = 0, -1, +1 from the mover's perspective).
_UNDERPROMO_PIECES = "nbr"
_UNDERPROMO_DF = [0, -1, 1]


def _sq(file: int, rank: int) -> int:
    return rank * 8 + file


def _parse_sq(s: str) -> Tuple[int, int]:
    return ord(s[0]) - ord("a"), ord(s[1]) - ord("1")


def _flip_rank(rank: int) -> int:
    return 7 - rank


@functools.lru_cache(maxsize=1 << 14)
def move_to_index(uci: str, stm_white: bool) -> int:
    """Policy index of a UCI move (stm perspective). Raises ValueError on
    moves outside the encoding (e.g. crazyhouse drops — the AZ family
    serves standard chess only). Memoised: a pure function of a few
    thousand distinct moves, called for every legal move of every
    evaluated leaf."""
    if "@" in uci:
        raise ValueError(f"drop moves are not in the AZ policy encoding: {uci}")
    ff, fr = _parse_sq(uci[0:2])
    tf, tr = _parse_sq(uci[2:4])
    promo = uci[4:5]
    if not stm_white:
        fr, tr = _flip_rank(fr), _flip_rank(tr)
    df, dr = tf - ff, tr - fr

    if promo and promo != "q":
        try:
            piece = _UNDERPROMO_PIECES.index(promo)
        except ValueError as err:
            raise ValueError(f"bad promotion piece in {uci}") from err
        try:
            direction = _UNDERPROMO_DF.index(df)
        except ValueError as err:
            raise ValueError(f"bad promotion direction in {uci}") from err
        plane = 64 + piece * 3 + direction
    elif (df, dr) in _KNIGHT_DIRS:
        plane = 56 + _KNIGHT_DIRS.index((df, dr))
    else:
        if df and dr and abs(df) != abs(dr):
            raise ValueError(f"not a queen-line move: {uci}")
        dist = max(abs(df), abs(dr))
        if dist == 0 or dist > 7:
            raise ValueError(f"bad move distance: {uci}")
        step = (0 if df == 0 else df // abs(df), 0 if dr == 0 else dr // abs(dr))
        try:
            direction = _QUEEN_DIRS.index(step)
        except ValueError as err:
            raise ValueError(f"bad direction: {uci}") from err
        plane = direction * 7 + (dist - 1)

    return _sq(ff, fr) * 73 + plane


def legal_policy_indices(moves: List[str], stm_white: bool) -> np.ndarray:
    """int32 policy indices for a legal-move list, aligned with `moves`."""
    return np.asarray([move_to_index(m, stm_white) for m in moves], dtype=np.int32)


def _parse_fen_fields(fen: str) -> Dict[str, str]:
    parts = fen.split()
    return {
        "placement": parts[0],
        "turn": parts[1] if len(parts) > 1 else "w",
        "castling": parts[2] if len(parts) > 2 else "-",
        "ep": parts[3] if len(parts) > 3 else "-",
        "halfmove": parts[4] if len(parts) > 4 else "0",
    }


def board_planes(fen: str) -> np.ndarray:
    """[8, 8, 19] float32 feature planes (rank-major, stm perspective).

    Planes 0-5 own P N B R Q K, 6-11 opponent, 12-13 own castling (king /
    queen side), 14-15 opponent castling, 16 en-passant square, 17
    halfmove clock / 100, 18 all-ones.
    """
    f = _parse_fen_fields(fen)
    stm_white = f["turn"] == "w"
    planes = np.zeros((8, 8, INPUT_PLANES), dtype=np.float32)

    rank = 7
    file = 0
    for c in f["placement"].split("[", 1)[0]:
        if c == "/":
            rank -= 1
            file = 0
        elif c.isdigit():
            file += int(c)
        elif c == "~":
            continue
        else:
            white = c.isupper()
            idx = _PIECE_ORDER.index(c.upper())
            plane = idx if white == stm_white else 6 + idx
            r = rank if stm_white else _flip_rank(rank)
            planes[r, file, plane] = 1.0
            file += 1

    own, opp = ("KQ", "kq") if stm_white else ("kq", "KQ")
    castling = f["castling"]
    if own[0] in castling:
        planes[:, :, 12] = 1.0
    if own[1] in castling:
        planes[:, :, 13] = 1.0
    if opp[0] in castling:
        planes[:, :, 14] = 1.0
    if opp[1] in castling:
        planes[:, :, 15] = 1.0
    # Chess960 Shredder-FEN rights (file letters): we can't cheaply tell
    # king- from queen-side here, so light both planes for that color.
    for c in castling:
        if c in "-KQkq":
            continue
        base = 12 if c.isupper() == stm_white else 14
        planes[:, :, base] = 1.0
        planes[:, :, base + 1] = 1.0

    if f["ep"] != "-":
        ef, er = _parse_sq(f["ep"])
        planes[er if stm_white else _flip_rank(er), ef, 16] = 1.0

    try:
        halfmove = float(f["halfmove"])
    except ValueError:
        halfmove = 0.0
    planes[:, :, 17] = min(halfmove, 100.0) / 100.0
    planes[:, :, 18] = 1.0
    return planes
