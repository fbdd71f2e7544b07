"""The pieces of the fishnet wire model that the UCI serving path uses:
``Variant``, ``STARTPOS`` and ``ProtocolError``.

The port's own copy of those three names from
``fishnet_tpu/protocol/types.py`` (the rest of that module — work
items, analysis bodies, clocks — belongs to the ``run`` client path,
which this package does not serve yet).
"""

from __future__ import annotations

import enum
from typing import Optional


class ProtocolError(ValueError):
    """Malformed input from a peer (here: an unknown variant name)."""


class Variant(enum.Enum):
    STANDARD = "standard"
    ANTICHESS = "antichess"
    ATOMIC = "atomic"
    CRAZYHOUSE = "crazyhouse"
    HORDE = "horde"
    KING_OF_THE_HILL = "kingofthehill"
    RACING_KINGS = "racingkings"
    THREE_CHECK = "3check"

    @classmethod
    def parse(cls, s: Optional[str]) -> "Variant":
        if not s:
            return cls.STANDARD
        key = s.lower().replace(" ", "").replace("-", "")
        aliases = {
            "standard": cls.STANDARD,
            "chess960": cls.STANDARD,
            "fromposition": cls.STANDARD,
            "chess": cls.STANDARD,
            "antichess": cls.ANTICHESS,
            "atomic": cls.ATOMIC,
            "crazyhouse": cls.CRAZYHOUSE,
            "horde": cls.HORDE,
            "kingofthehill": cls.KING_OF_THE_HILL,
            "racingkings": cls.RACING_KINGS,
            "3check": cls.THREE_CHECK,
            "threecheck": cls.THREE_CHECK,
        }
        try:
            return aliases[key]
        except KeyError:
            raise ProtocolError(f"unknown variant: {s!r}") from None

    def uci(self) -> str:
        """Variant name as spoken over UCI (`UCI_Variant`)."""
        return {
            Variant.STANDARD: "chess",
            Variant.ANTICHESS: "antichess",
            Variant.ATOMIC: "atomic",
            Variant.CRAZYHOUSE: "crazyhouse",
            Variant.HORDE: "horde",
            Variant.KING_OF_THE_HILL: "kingofthehill",
            Variant.RACING_KINGS: "racingkings",
            Variant.THREE_CHECK: "3check",
        }[self]


STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
