"""Ed25519 signature verification on the standard library.

The update channel's release artifacts carry a detached Ed25519
signature (``update.py``). The JAX package checks it with the
``cryptography`` package; the port imports nothing outside torch, numpy
and the standard library, so it verifies with this module: the
verification of RFC 8032 §5.1.7 in plain integer arithmetic (the
curve's twisted Edwards form in extended coordinates), verify only.

* Cofactorless: the check is [S]B = R + [k]A, computed as
  R' = [S]B - [k]A, encoded and compared with the signature's R bytes,
  as OpenSSL (under ``cryptography``) does.
* Strict decoding: a point encoding whose y is not below p, that has no
  x, or that sets the sign bit of x = 0 is refused, for the key and for
  R alike; so is S >= L (RFC 8032 §5.1.7 step 1).
* Any signature that cannot be checked (a wrong length, a bad point) is
  refused exactly like a signature that does not verify.

Variable-time, which is fine for a verifier: it handles public data
only.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

__all__ = ["verify"]

#: The field prime, the curve constant d, the group order L and sqrt(-1).
P = 2 ** 255 - 19
D = -121665 * pow(121666, P - 2, P) % P
L = 2 ** 252 + 27742317777372353535851937790883648493
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]  # extended coordinates (X, Y, Z, T)


def _recover_x(y: int, sign: int) -> Optional[int]:
    """The x of the curve point with this y and x's low bit ``sign``, or
    None where there is none or the encoding is not canonical."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


def _decode(data: bytes) -> Optional[Point]:
    """A 32-byte point encoding as a point, or None (RFC 8032 §5.1.3)."""
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign, y = y >> 255, y & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _encode(pt: Point) -> bytes:
    zinv = pow(pt[2], P - 2, P)
    x, y = pt[0] * zinv % P, pt[1] * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _add(p1: Point, p2: Point) -> Point:
    a = (p1[1] - p1[0]) * (p2[1] - p2[0]) % P
    b = (p1[1] + p1[0]) * (p2[1] + p2[0]) % P
    c = 2 * p1[3] * p2[3] * D % P
    d = 2 * p1[2] * p2[2] % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(s: int, pt: Point) -> Point:
    out: Point = (0, 1, 1, 0)  # the neutral element
    while s > 0:
        if s & 1:
            out = _add(out, pt)
        pt = _add(pt, pt)
        s >>= 1
    return out


def _neg(pt: Point) -> Point:
    return ((P - pt[0]) % P, pt[1], pt[2], (P - pt[3]) % P)


_BY = 4 * pow(5, P - 2, P) % P
BASE: Point = (_recover_x(_BY, 0), _BY, 1, _recover_x(_BY, 0) * _BY % P)


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """True when ``signature`` (64 bytes: R, then S little-endian) is a
    valid Ed25519 signature of ``message`` under ``public_key`` (32
    bytes); False for anything else."""
    if len(public_key) != 32 or len(signature) != 64:
        return False
    a = _decode(public_key)
    r_bytes = signature[:32]
    if a is None or _decode(r_bytes) is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(
        hashlib.sha512(r_bytes + public_key + message).digest(), "little") % L
    return _encode(_add(_mul(s, BASE), _mul(k, _neg(a)))) == r_bytes
