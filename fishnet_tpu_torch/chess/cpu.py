"""Host CPU feature detection for native-library tier selection.

The reference embeds up to six CPU-feature-tiered engine builds and
picks the best at startup (assets.rs:86-126), including a heuristic
that treats BMI2/PEXT as *slow* on AMD before Zen 3 (family < 0x19,
assets.rs:94-108) — those chips microcode-emulate PEXT, so the
SSE-level build outruns the BMI2 one. This module mirrors that logic
for the portable tiers `make tiers` produces (x86-64-v2, -v3 and
-v4) plus the aarch64 tier; a host-built -march=native library always
wins when present.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import FrozenSet, Optional


@dataclass(frozen=True)
class CpuInfo:
    vendor: str = ""
    family: int = 0
    flags: FrozenSet[str] = field(default_factory=frozenset)
    #: Machine architecture (platform.machine()): tier selection is
    #: x86-feature based on x86-64 and a single armv8 tier on aarch64
    #: (mirroring the reference's armv8 build, build.rs:187-276).
    arch: str = "x86_64"

    @property
    def fast_pext(self) -> bool:
        """BMI2 present and not microcoded (AMD pre-Zen3 emulates PEXT)."""
        if "bmi2" not in self.flags:
            return False
        if self.vendor == "AuthenticAMD" and self.family < 0x19:
            return False
        return True

    def best_tier(self) -> Optional[str]:
        """'v4' (AVX-512), 'v3' (AVX2+fast BMI2), 'v2' (SSE4.2/POPCNT),
        'arm64' (aarch64), or None."""
        if self.arch in ("aarch64", "arm64"):
            return "arm64"
        # x86-64-v4 needs the AVX-512 F/BW/CD/DQ/VL group (and still
        # benefits from fast PEXT — BMI2 is part of v3's baseline).
        if (
            {"avx512f", "avx512bw", "avx512cd", "avx512dq", "avx512vl"}
            <= self.flags
            and self.fast_pext
        ):
            return "v4"
        if {"avx2", "bmi2"} <= self.flags and self.fast_pext:
            return "v3"
        if {"sse4_2", "popcnt"} <= self.flags:
            return "v2"
        return None


def parse_cpuinfo(text: str) -> CpuInfo:
    vendor = ""
    family = 0
    flags: FrozenSet[str] = frozenset()
    for line in text.splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        value = value.strip()
        if key == "vendor_id" and not vendor:
            vendor = value
        elif key == "cpu family" and not family:
            try:
                family = int(value)
            except ValueError:
                pass
        elif key == "flags" and not flags:
            flags = frozenset(value.split())
    return CpuInfo(vendor=vendor, family=family, flags=flags)


def detect(cpuinfo_path: str = "/proc/cpuinfo") -> CpuInfo:
    import dataclasses
    import platform

    arch = platform.machine() or "x86_64"
    try:
        text = Path(cpuinfo_path).read_text()
    except OSError:
        return CpuInfo(arch=arch)
    return dataclasses.replace(parse_cpuinfo(text), arch=arch)
