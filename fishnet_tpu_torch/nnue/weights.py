"""NNUE weight container: random init, save/load in the SF-style binary
layout described in spec.py.

The port's own copy of ``fishnet_tpu/nnue/weights.py``: the same file
format and the same numpy draw in ``random`` (so one seed gives one net
in both packages), shared by the C++ scalar evaluator and the torch
evaluator.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Union

import numpy as np

from fishnet_tpu_torch.nnue import spec


@dataclass
class NnueWeights:
    # Feature transformer
    ft_weight: np.ndarray  # [NUM_FEATURES, L1] int16
    ft_bias: np.ndarray  # [L1] int16
    ft_psqt: np.ndarray  # [NUM_FEATURES, NUM_PSQT_BUCKETS] int32
    # Per-bucket layer stacks
    l1_weight: np.ndarray  # [8, L2+1, L1] int8
    l1_bias: np.ndarray  # [8, L2+1] int32
    l2_weight: np.ndarray  # [8, L3, 2*L2] int8
    l2_bias: np.ndarray  # [8, L3] int32
    out_weight: np.ndarray  # [8, 1, L3] int8
    out_bias: np.ndarray  # [8, 1] int32

    def validate(self) -> None:
        assert self.ft_weight.shape == (spec.NUM_FEATURES, spec.L1)
        assert self.ft_weight.dtype == np.int16
        assert self.ft_bias.shape == (spec.L1,) and self.ft_bias.dtype == np.int16
        assert self.ft_psqt.shape == (spec.NUM_FEATURES, spec.NUM_PSQT_BUCKETS)
        assert self.ft_psqt.dtype == np.int32
        b = spec.NUM_PSQT_BUCKETS
        assert self.l1_weight.shape == (b, spec.L2 + 1, spec.L1)
        assert self.l1_weight.dtype == np.int8
        assert self.l1_bias.shape == (b, spec.L2 + 1) and self.l1_bias.dtype == np.int32
        assert self.l2_weight.shape == (b, spec.L3, 2 * spec.L2)
        assert self.l2_weight.dtype == np.int8
        assert self.l2_bias.shape == (b, spec.L3) and self.l2_bias.dtype == np.int32
        assert self.out_weight.shape == (b, 1, spec.L3)
        assert self.out_weight.dtype == np.int8
        assert self.out_bias.shape == (b, 1) and self.out_bias.dtype == np.int32

    # -- constructors -----------------------------------------------------

    @classmethod
    def random(cls, seed: int = 0) -> "NnueWeights":
        """A random but *plausible* net: FT weights small so accumulators
        stay in int16 range with 32 active features."""
        rng = np.random.default_rng(seed)
        b = spec.NUM_PSQT_BUCKETS
        return cls(
            ft_weight=rng.integers(-32, 33, (spec.NUM_FEATURES, spec.L1)).astype(np.int16),
            ft_bias=rng.integers(-128, 129, (spec.L1,)).astype(np.int16),
            ft_psqt=rng.integers(-6000, 6001, (spec.NUM_FEATURES, b)).astype(np.int32),
            l1_weight=rng.integers(-64, 65, (b, spec.L2 + 1, spec.L1)).astype(np.int8),
            l1_bias=rng.integers(-8192, 8193, (b, spec.L2 + 1)).astype(np.int32),
            l2_weight=rng.integers(-64, 65, (b, spec.L3, 2 * spec.L2)).astype(np.int8),
            l2_bias=rng.integers(-8192, 8193, (b, spec.L3)).astype(np.int32),
            out_weight=rng.integers(-64, 65, (b, 1, spec.L3)).astype(np.int8),
            out_bias=rng.integers(-8192, 8193, (b, 1)).astype(np.int32),
        )

    def fingerprint(self) -> int:
        """Stable 64-bit digest of the CANONICAL serialized form (what
        ``save`` writes), so ``w.fingerprint()`` equals a blake2b over
        the ``.nnue`` file byte-for-byte. The eval cache mixes this into
        its keys so a process serving (or respawning into) a different
        network never reads the old network's evals
        (search/eval_cache.py net_fingerprint)."""
        import hashlib

        h = hashlib.blake2b(digest_size=8)

        class _HashSink:
            def write(self, b: bytes) -> None:
                h.update(b)

        self._write(_HashSink())
        return int.from_bytes(h.digest(), "little")

    # -- serialization ----------------------------------------------------

    def save(self, path: Union[str, Path]) -> None:
        with open(path, "wb") as f:
            self._write(f)

    def _write(self, f: BinaryIO) -> None:
        f.write(struct.pack("<II", spec.FILE_VERSION, spec.ARCH_HASH))
        f.write(struct.pack("<I", len(spec.ARCH_DESCRIPTION)))
        f.write(spec.ARCH_DESCRIPTION)
        # Feature transformer (hash framing as in the SF format).
        f.write(struct.pack("<I", 0x5D69D5B8))
        f.write(self.ft_bias.astype("<i2").tobytes())
        f.write(self.ft_weight.astype("<i2").tobytes())
        f.write(self.ft_psqt.astype("<i4").tobytes())
        # Layer stacks, bucket-major. The l2 rows are padded to
        # spec.L2_PADDED_INPUTS on disk (SF serializes affine inputs
        # rounded up to 32; the pad columns are zero).
        for b in range(spec.NUM_PSQT_BUCKETS):
            f.write(struct.pack("<I", 0x63337156))
            f.write(self.l1_bias[b].astype("<i4").tobytes())
            f.write(self.l1_weight[b].astype("<i1").tobytes())
            f.write(self.l2_bias[b].astype("<i4").tobytes())
            l2 = np.zeros((spec.L3, spec.L2_PADDED_INPUTS), np.int8)
            l2[:, : 2 * spec.L2] = self.l2_weight[b]
            f.write(l2.astype("<i1").tobytes())
            f.write(self.out_bias[b].astype("<i4").tobytes())
            f.write(self.out_weight[b].astype("<i1").tobytes())

    @classmethod
    def load(cls, path: Union[str, Path]) -> "NnueWeights":
        data = Path(path).read_bytes()
        off = 0

        def take(n: int) -> bytes:
            nonlocal off
            chunk = data[off : off + n]
            if len(chunk) != n:
                raise ValueError(
                    "truncated nnue file (wanted "
                    f"{n} bytes at offset {off}, {len(data) - off} left). "
                    "Note: nets saved by pre-r2 builds of this framework "
                    "used unpadded l2 rows and are exactly 512 bytes/stack "
                    "short of the SF/nnue-pytorch layout — re-export them "
                    "with the current build."
                )
            off += n
            return chunk

        version, arch_hash = struct.unpack("<II", take(8))
        if version != spec.FILE_VERSION:
            raise ValueError(f"unsupported nnue version 0x{version:08X}")
        if arch_hash != spec.ARCH_HASH:
            raise ValueError(
                f"wrong architecture hash 0x{arch_hash:08X} "
                f"(expected 0x{spec.ARCH_HASH:08X})"
            )
        (desc_len,) = struct.unpack("<I", take(4))
        take(desc_len)  # description string (informational)
        take(4)  # FT hash

        def arr(dtype: str, shape) -> np.ndarray:
            count = int(np.prod(shape))
            itemsize = np.dtype(dtype).itemsize
            return np.frombuffer(take(count * itemsize), dtype=dtype).reshape(shape).copy()

        ft_bias = arr("<i2", (spec.L1,))
        ft_weight = arr("<i2", (spec.NUM_FEATURES, spec.L1))
        ft_psqt = arr("<i4", (spec.NUM_FEATURES, spec.NUM_PSQT_BUCKETS))

        nb = spec.NUM_PSQT_BUCKETS
        l1_w = np.empty((nb, spec.L2 + 1, spec.L1), np.int8)
        l1_b = np.empty((nb, spec.L2 + 1), np.int32)
        l2_w = np.empty((nb, spec.L3, 2 * spec.L2), np.int8)
        l2_b = np.empty((nb, spec.L3), np.int32)
        o_w = np.empty((nb, 1, spec.L3), np.int8)
        o_b = np.empty((nb, 1), np.int32)
        for b in range(nb):
            take(4)  # stack hash
            l1_b[b] = arr("<i4", (spec.L2 + 1,))
            l1_w[b] = arr("<i1", (spec.L2 + 1, spec.L1))
            l2_b[b] = arr("<i4", (spec.L3,))
            # On disk the l2 rows span the PADDED input width; the pad
            # columns carry no weights.
            l2_w[b] = arr("<i1", (spec.L3, spec.L2_PADDED_INPUTS))[:, : 2 * spec.L2]
            o_b[b] = arr("<i4", (1,))
            o_w[b] = arr("<i1", (1, spec.L3))

        weights = cls(
            ft_weight=ft_weight.astype(np.int16),
            ft_bias=ft_bias.astype(np.int16),
            ft_psqt=ft_psqt.astype(np.int32),
            l1_weight=l1_w,
            l1_bias=l1_b,
            l2_weight=l2_w,
            l2_bias=l2_b,
            out_weight=o_w,
            out_bias=o_b,
        )
        weights.validate()
        return weights
