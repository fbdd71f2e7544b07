"""Variant codes of the native core's C ABI.

The port's copy of ``_VARIANT_CODES`` from ``fishnet_tpu/chess/board.py``
(the ``Board`` wrapper itself serves the ``run`` client path's legality
replay and is not needed by the UCI serving path).
"""

from __future__ import annotations

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
