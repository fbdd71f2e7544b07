from fishnet_tpu_torch.chess.board import (
    Board,
    IllegalMoveError,
    InvalidFenError,
    STARTPOS_FEN,
    UnsupportedVariantError,
    variant_supported,
)

__all__ = [
    "Board",
    "IllegalMoveError",
    "InvalidFenError",
    "STARTPOS_FEN",
    "UnsupportedVariantError",
    "variant_supported",
]
