"""The port's Board (fishnet_tpu_torch.chess) against the JAX package's,
in a process that has imported torch first: the FEN formatter gives the
strings of chip_smoke.py's FEN check (ROADMAP C7), and the legality
replay the scheduler runs (normalize/push, legal moves, outcome) agrees
with the reference's."""

import torch  # noqa: F401 - first, as on the card

import random

import pytest

from chip_smoke import FEN_CHECKS
from fishnet_tpu.chess import Board as RefBoard
from fishnet_tpu.protocol.types import Variant as RefVariant
from fishnet_tpu_torch.chess import (
    Board,
    IllegalMoveError,
    InvalidFenError,
    variant_supported,
)
from fishnet_tpu_torch.protocol.types import Variant


@pytest.mark.parametrize("fen, variant, want", FEN_CHECKS,
                         ids=[f"{v}-{i}" for i, (_, v, _) in enumerate(FEN_CHECKS)])
def test_fen_check_list(fen, variant, want):
    got = Board(fen, Variant.parse(variant)).fen()
    assert got == want
    assert got == RefBoard(fen, RefVariant.parse(variant)).fen()


@pytest.mark.parametrize("variant", [v.value for v in Variant])
def test_random_walks_replay_alike(variant):
    """Seeded random games: after every move the port's board and the
    reference's agree on FEN, legal moves, side to move, check, hash and
    outcome; castling moves normalise alike."""
    assert variant_supported(Variant(variant))
    rnd = random.Random(variant)
    for _ in range(3):
        port = Board(variant=Variant(variant))
        ref = RefBoard(variant=RefVariant(variant))
        for _ in range(40):
            legal = port.legal_moves()
            assert legal == ref.legal_moves()
            assert (port.fen(), port.turn(), port.is_check(),
                    port.zobrist_hash(), port.outcome()) == (
                ref.fen(), ref.turn(), ref.is_check(), ref.zobrist_hash(),
                ref.outcome())
            if port.outcome() != Board.ONGOING or not legal:
                break
            move = rnd.choice(legal)
            assert port.normalize_uci(move) == ref.normalize_uci(move)
            copy = port.copy()
            port.push_uci(move)
            ref.push_uci(move)
            assert copy.fen() != port.fen()


def test_standard_castling_notation_and_errors():
    board = Board("r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 1")
    assert board.normalize_uci("e1g1") == "e1h1"
    assert board.normalize_uci("e1e3") is None
    with pytest.raises(IllegalMoveError):
        board.push_uci("a1a8a")
    with pytest.raises(InvalidFenError):
        Board("not a fen")


def test_held_board_walks_like_the_reference():
    """A board whose native calls keep the interpreter lock
    (``held=True``, the bounds tier's walks) and its copies replay a
    seeded game like the reference: FEN, legal moves, hash; the child
    hashes the service derives from it equal the reference's, child by
    child."""
    from fishnet_tpu_torch.search.service import SearchService

    rnd = random.Random(7)
    port, ref = Board(held=True), RefBoard()
    for _ in range(30):
        legal = port.legal_moves()
        assert legal == ref.legal_moves()
        assert (port.fen(), port.zobrist_hash()) == (ref.fen(),
                                                     ref.zobrist_hash())
        children = []
        for mv in legal:
            child = RefBoard(ref.fen())
            child.push_uci(mv)
            children.append(child.zobrist_hash())
        assert SearchService._child_hashes(port) == children
        if not legal:
            break
        move = rnd.choice(legal)
        port = port.copy()
        port.push_uci(move)
        ref.push_uci(move)
