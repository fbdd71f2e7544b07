"""High-level Board wrapper over the native core.

The port's copy of ``fishnet_tpu/chess/board.py``. Used by the
scheduler for the trust-boundary legality replay the reference performs
with shakmaty (src/queue.rs:543-552): every acquired game is replayed
move by move before any engine sees it, and its root position is
normalised through ``fen()``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

from fishnet_tpu_torch.chess.core import NativeCoreError, load, load_held
from fishnet_tpu_torch.protocol.types import STARTPOS as STARTPOS_FEN
from fishnet_tpu_torch.protocol.types import Variant

#: Variant -> the integer the native core takes (cpp/src/capi.cpp).
_VARIANT_CODES = {
    Variant.STANDARD: 0,
    Variant.ANTICHESS: 1,
    Variant.ATOMIC: 2,
    Variant.CRAZYHOUSE: 3,
    Variant.HORDE: 4,
    Variant.KING_OF_THE_HILL: 5,
    Variant.RACING_KINGS: 6,
    Variant.THREE_CHECK: 7,
}

_BUF_LEN = 8192


class IllegalMoveError(ValueError):
    pass


class InvalidFenError(ValueError):
    pass


class UnsupportedVariantError(NotImplementedError):
    pass


def variant_supported(variant: Variant) -> bool:
    return bool(load().fc_variant_supported(_VARIANT_CODES[variant]))


class Board:
    """A chess position. Outcome codes (matching the native core):
    0 ongoing, 1 checkmate (side to move is mated), 2 stalemate,
    3 variant loss, 4 variant win, 5 draw.

    ``held=True`` makes its native calls keep the interpreter lock
    (``core.load_held``; so do its copies): for a walk of many short
    calls on a busy thread."""

    ONGOING = 0
    CHECKMATE = 1
    STALEMATE = 2
    VARIANT_LOSS = 3
    VARIANT_WIN = 4
    DRAW = 5

    def __init__(
        self,
        fen: str = STARTPOS_FEN,
        variant: Variant = Variant.STANDARD,
        _handle: Optional[int] = None,
        held: bool = False,
    ) -> None:
        self._lib = load_held() if held else load()
        self._held = held
        self.variant = variant
        if _handle is not None:
            self._pos = _handle
            return
        if not self._lib.fc_variant_supported(_VARIANT_CODES[variant]):
            raise UnsupportedVariantError(f"variant not yet supported: {variant.value}")
        err = ctypes.create_string_buffer(256)
        self._pos = self._lib.fc_pos_new(
            fen.encode(), _VARIANT_CODES[variant], err, len(err)
        )
        if not self._pos:
            raise InvalidFenError(
                f"invalid FEN {fen!r}: {err.value.decode(errors='replace')}"
            )

    def __del__(self) -> None:
        pos = getattr(self, "_pos", None)
        if pos:
            self._lib.fc_pos_free(pos)
            self._pos = None

    def copy(self) -> "Board":
        handle = self._lib.fc_pos_clone(self._pos)
        if not handle:
            raise NativeCoreError("clone failed")
        return Board(variant=self.variant, _handle=handle, held=self._held)

    def push_uci(self, uci: str) -> None:
        if self._lib.fc_pos_play_uci(self._pos, uci.encode()) != 0:
            raise IllegalMoveError(f"illegal move {uci!r} in {self.fen()}")

    def normalize_uci(self, uci: str) -> Optional[str]:
        """Canonical UCI of a legal move (standard castling notation is
        rewritten to king-takes-rook); None if the move is illegal."""
        buf = ctypes.create_string_buffer(16)
        if self._lib.fc_pos_parse_uci(self._pos, uci.encode(), buf, len(buf)) < 0:
            return None
        return buf.value.decode()

    def fen(self) -> str:
        buf = ctypes.create_string_buffer(_BUF_LEN)
        if self._lib.fc_pos_fen(self._pos, buf, _BUF_LEN) < 0:
            raise NativeCoreError("fen buffer overflow")
        return buf.value.decode()

    def turn(self) -> str:
        """'w' or 'b'."""
        return "w" if self._lib.fc_pos_turn(self._pos) == 0 else "b"

    def is_check(self) -> bool:
        return bool(self._lib.fc_pos_is_check(self._pos))

    def halfmove_clock(self) -> int:
        return self._lib.fc_pos_halfmove(self._pos)

    def fullmove_number(self) -> int:
        return self._lib.fc_pos_fullmove(self._pos)

    def zobrist_hash(self) -> int:
        return self._lib.fc_pos_hash(self._pos)

    def outcome(self) -> int:
        return self._lib.fc_pos_outcome(self._pos)

    def legal_moves(self) -> List[str]:
        buf = ctypes.create_string_buffer(_BUF_LEN)
        if self._lib.fc_pos_legal_moves(self._pos, buf, _BUF_LEN) < 0:
            raise NativeCoreError("legal_moves buffer overflow")
        text = buf.value.decode()
        return text.split() if text else []

    def nnue_features(self):
        """(indices, bucket): HalfKAv2_hm feature indices as an int32
        [2, 32] array (perspective 0 = side to move, padded with
        NUM_FEATURES) plus the layer-stack bucket. Raises
        ``UnsupportedVariantError`` outside standard chess."""
        import numpy as np

        from fishnet_tpu_torch.nnue.spec import NUM_FEATURES

        out = np.full((2, 32), NUM_FEATURES, dtype=np.int32)
        for perspective in (0, 1):
            buf = (ctypes.c_int32 * 32)()
            n = self._lib.fc_pos_features(self._pos, perspective, buf)
            if n < 0:
                raise UnsupportedVariantError(
                    "HalfKAv2_hm features are defined for standard chess only"
                )
            out[perspective, :n] = np.frombuffer(buf, dtype=np.int32, count=n)
        return out, self._lib.fc_pos_psqt_bucket(self._pos)
