"""Level-prefixed logging with an in-place TTY progress line.

The port's copy of ``fishnet_tpu/utils/logger.py``. Equivalent of the
reference's logger (src/logger.rs:20-203): lines are
prefixed `D:` / `W:` / `E:` / `><>`; verbosity is a counter; when
attached to a TTY, a progress line with an ASCII queue bar is redrawn in
place with `\\r` and cleared before real log lines.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Optional

#: Short display names of non-standard variants (src/logger.rs:192-203).
SHORT_VARIANT_NAMES = {
    "antichess": "anti",
    "atomic": "atomic",
    "crazyhouse": "zh",
    "horde": "horde",
    "kingofthehill": "koth",
    "racingkings": "race",
    "threecheck": "3check",
    "3check": "3check",
}


def short_variant_name(variant: str) -> Optional[str]:
    return SHORT_VARIANT_NAMES.get(variant.lower().replace(" ", ""))


@dataclass
class ProgressAt:
    """Pointer to where work currently is: batch (+ optional ply)."""

    batch_id: str
    batch_url: Optional[str] = None
    position_id: Optional[int] = None

    def __str__(self) -> str:
        if self.batch_url:
            base = self.batch_url
            if self.position_id is not None:
                return f"{base}#{self.position_id}"
            return base
        return str(self.batch_id)


@dataclass
class QueueStatusBar:
    """ASCII queue bar `[===   |==   ]` scaled to cores vs pending work
    (src/logger.rs:166-190)."""

    pending: int
    cores: int

    def __str__(self) -> str:
        width = 20
        cores = max(1, self.cores)
        # Two lanes: first `cores` slots are active workers, the rest backlog.
        cells = min(width, (self.pending * width + 2 * cores - 1) // (2 * cores))
        bar = "=" * min(cells, width // 2)
        bar += " " * (width // 2 - len(bar))
        bar += "|"
        rest = "=" * max(0, cells - width // 2)
        bar += rest + " " * (width // 2 - len(rest))
        return f"[{bar}] {self.pending}"


class Logger:
    def __init__(self, verbose: int = 0, stderr: bool = False) -> None:
        self.verbose = verbose
        self.stream = sys.stderr if stderr else sys.stdout
        self._lock = threading.Lock()
        self._progress_shown = False
        try:
            self._atty = self.stream.isatty()
        except Exception:
            self._atty = False

    # -- internal ---------------------------------------------------------

    def _clear_progress(self) -> None:
        if self._progress_shown:
            self.stream.write("\r\x1b[K")
            self._progress_shown = False

    def _line(self, prefix: str, msg: str) -> None:
        with self._lock:
            self._clear_progress()
            self.stream.write(f"{prefix}{msg}\n")
            self.stream.flush()

    # -- public API (mirrors logger.rs:57-106) ----------------------------

    def debug(self, msg: str) -> None:
        if self.verbose >= 1:
            self._line("D: ", msg)

    def info(self, msg: str) -> None:
        self._line("", msg)

    def fishnet_info(self, msg: str) -> None:
        self._line("><> ", msg)

    def warn(self, msg: str) -> None:
        self._line("W: ", msg)

    def error(self, msg: str) -> None:
        self._line("E: ", msg)

    def progress(self, bar: QueueStatusBar, at: ProgressAt) -> None:
        if not self._atty:
            return
        with self._lock:
            self.stream.write(f"\r\x1b[K{bar} {at}")
            self.stream.flush()
            self._progress_shown = True
