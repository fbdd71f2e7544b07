"""Randomized exponential backoff.

The port's copy of ``fishnet_tpu/utils/backoff.py``. Behavioral
equivalent of the reference's RandomizedBackoff
(src/util.rs:10-37): draw uniformly from [100ms, 4 * max(100ms, last)),
then cap at the configured maximum (default 30s). Used for acquire
polling, engine restarts, and API error handling.

Two additions over the reference (doc/resilience.md):

* ``jitter="full"`` — AWS-style full jitter: draw uniformly from
  [0, min(cap, 100ms * 2**attempt)). Decorrelated jitter (the default)
  never draws below 100 ms and correlates consecutive draws through
  ``last``; full jitter spreads a thundering herd across the whole
  interval, which is what you want when MANY clients hit one recovering
  endpoint at once.
* ``reset_after`` — a re-arm grace period: after a long outage, a
  single success used to re-arm the 100 ms floor instantly, so the very
  next failure hammered a barely-recovered server at full rate. With
  ``reset_after=S``, a ``reset()`` issued less than S seconds after the
  last failure only HALVES the backoff state (gradual re-arm); the full
  reset happens once the system has stayed healthy for S seconds.
"""

from __future__ import annotations

import random
import time

_LOW = 0.1  # 100 ms


class RandomizedBackoff:
    def __init__(
        self,
        max_backoff_seconds: float = 30.0,
        *,
        jitter: str = "decorrelated",
        reset_after: float | None = None,
    ) -> None:
        if jitter not in ("decorrelated", "full"):
            raise ValueError(f"unknown jitter mode: {jitter!r}")
        if reset_after is not None and reset_after < 0:
            raise ValueError("reset_after must be non-negative")
        self.max_backoff = max(_LOW, max_backoff_seconds)
        self.jitter = jitter
        self.reset_after = reset_after
        self._last = 0.0
        self._attempt = 0
        self._last_failure: float | None = None

    def next(self) -> float:
        """Return the next backoff duration in seconds."""
        self._last_failure = time.monotonic()
        if self.jitter == "full":
            high = min(self.max_backoff, _LOW * (2.0 ** self._attempt))
            self._attempt += 1
            duration = random.uniform(0.0, high)
            self._last = duration
            return duration
        high = 4.0 * max(_LOW, self._last)
        duration = min(self.max_backoff, random.uniform(_LOW, high))
        self._last = duration
        self._attempt += 1
        return duration

    def reset(self) -> None:
        """Note a success. Without ``reset_after`` (the reference
        behavior) the state re-arms immediately; with it, a success
        inside the grace window only decays the state one step."""
        if (
            self.reset_after is not None
            and self._last_failure is not None
            and time.monotonic() - self._last_failure < self.reset_after
        ):
            # Grace: one success after a long outage must not instantly
            # re-arm 100 ms retries against a barely-recovered peer.
            self._last = self._last / 2.0
            self._attempt = max(0, self._attempt - 1)
            if self._last < _LOW:
                self._last = 0.0
                self._attempt = 0
                self._last_failure = None
            return
        self._last = 0.0
        self._attempt = 0
        self._last_failure = None
