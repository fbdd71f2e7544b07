"""Degradation ladder and circuit breaker: recovery *policy* for the
serving stack.

The port's copy of ``fishnet_tpu/resilience/supervisor.py``, with its
metrics (``fishnet_degradations_total{from,to}``,
``fishnet_pool_respawns_total``, ``fishnet_breaker_state{endpoint}``)
and its ``recover`` span (every supervised build, with the rung and
whether it was a respawn, when telemetry is on). Two policy objects:

* :class:`ServiceSupervisor` wraps a ``SearchService`` builder for
  ``TpuNnueEngineFactory``. When the factory rebuilds a dead service,
  the supervisor counts the death, enforces a bounded respawn budget,
  and — after ``degrade_after`` rapid deaths — steps the requested
  evaluation path down the service's ``psqt_path`` rungs. The rungs
  keep the JAX package's names, but the ladder depends on the device
  (``ladder_for``)::

      cuda:  fused (hand kernel, device PSQT) ──> host-material (hand kernel)
      cpu:   xla (plain version)              ──> host-material (plain)

  Both CUDA rungs run the hand CUDA kernel: "xla", the plain version,
  is the CPU rung and is never entered on the card, so no step-down
  hides the kernel. Every rung is bit-identical in output, so degrading
  trades wire efficiency for liveness and never correctness. Each step
  is logged at error level.

* :class:`CircuitBreaker` is the submit-endpoint breaker the API actor
  consults (net/api.py): repeated submit failures open it, parking
  submissions instead of hammering a failing server; after a cooldown
  one probe goes through (half-open) and a success closes it and
  drains the parked work.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS

#: The rung names of the JAX package's lattice, best rung first.
RUNGS = ("fused", "xla", "host-material")

_DEGRADATIONS = _telemetry.REGISTRY.counter(
    "fishnet_degradations_total",
    "Degradation-ladder steps (requested eval path, from -> to).",
    labelnames=("from", "to"),
)
_RESPAWNS = _telemetry.REGISTRY.counter(
    "fishnet_pool_respawns_total",
    "Search-service (fc_pool) respawns performed by the supervisor.",
)
_BREAKER_STATE = _telemetry.REGISTRY.gauge(
    "fishnet_breaker_state",
    "Circuit-breaker state: 0 closed, 1 open, 2 half-open.",
    labelnames=("endpoint",),
)

#: Span stage recorded around every supervised rebuild — the seventh
#: stage next to the six pipeline stages (doc/observability.md).
RECOVER_STAGE = "recover"

#: Live breakers, by name, for the front end's shed policy and its
#: /healthz serving-state view (sched/frontend.py). Weak references: a
#: finished client's breakers vanish from the report without any
#: unregistration dance.
_BREAKERS: "weakref.WeakValueDictionary[str, CircuitBreaker]" = (
    weakref.WeakValueDictionary()
)


def breaker_states() -> Dict[str, str]:
    """Name -> state for every live CircuitBreaker in the process."""
    return {name: br.state for name, br in sorted(_BREAKERS.items())}


def any_breaker_open() -> bool:
    return any(br.state == CircuitBreaker.OPEN for br in _BREAKERS.values())


def ladder_for(device_type: str) -> Tuple[str, ...]:
    """The rungs a service on ``device_type`` can run, best first: the
    hand kernel's two wires on CUDA, the plain version's on the CPU."""
    if device_type == "cuda":
        return ("fused", "host-material")
    return ("xla", "host-material")


class RespawnBudgetExhausted(RuntimeError):
    """Too many respawns inside the window: the supervisor refuses to
    thrash. The engine factory surfaces this as an EngineError, so the
    worker pool's restart backoff paces further attempts."""


class CircuitBreaker:
    """Minimal three-state breaker with an injectable clock.

    Thread-compatible: all transitions happen under one lock. The
    caller pattern is ``allow()`` before attempting, then exactly one
    of ``record_success()`` / ``record_failure()`` for attempts that
    went through.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
    _GAUGE_VALUES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_seconds: float = 30.0,
        name: str = "submit",
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_seconds = cooldown_seconds
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._export()
        _BREAKERS[name] = self

    def _export(self) -> None:
        _BREAKER_STATE.set(
            self._GAUGE_VALUES[self._state], endpoint=self.name
        )

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def remaining_cooldown(self) -> float:
        """Seconds until an open breaker will admit its probe (0 when
        not open)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(
                0.0, self.cooldown_seconds - (self._clock() - self._opened_at)
            )

    def allow(self) -> bool:
        """True if an attempt may proceed. An open breaker past its
        cooldown transitions to half-open and admits exactly one probe;
        further attempts park until the probe resolves."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.cooldown_seconds:
                    self._state = self.HALF_OPEN
                    self._export()
                    return True
                return False
            return False  # half-open: probe already in flight

    def record_success(self) -> bool:
        """Note a successful attempt; returns True if the breaker just
        CLOSED (the caller should drain parked work)."""
        with self._lock:
            was = self._state
            self._state = self.CLOSED
            self._failures = 0
            self._export()
            return was != self.CLOSED

    def record_failure(self) -> bool:
        """Note a failed attempt; returns True if the breaker just
        OPENED (the caller should schedule a cooldown wake)."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                # Failed probe: straight back to open, fresh cooldown.
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._export()
                return True
            self._failures += 1
            if self._state == self.CLOSED and (
                self._failures >= self.failure_threshold
            ):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._export()
                return True
            return False


class ServiceSupervisor:
    """Wraps a service builder with the degradation ladder and a
    bounded respawn budget.

    ``builder`` is ``Callable[[str], service]``: it receives the rung
    to build (a ``psqt_path`` request). ``rungs`` is the device's ladder
    (``ladder_for``); the first build runs its top rung.
    ``supervisor.build`` matches ``TpuNnueEngineFactory``'s
    ``service_builder`` signature (no arguments).

    Death accounting: every ``build()`` after the first means the
    previous service died (the factory only rebuilds dead services). A
    service that survived ``healthy_seconds`` before dying resets the
    death streak; ``degrade_after`` rapid deaths step the ladder down
    one rung. The ladder never steps below its last rung; once there,
    the supervisor keeps respawning at the bottom rung (bounded by the
    respawn budget).
    """

    def __init__(
        self,
        builder: Callable[[str], object],
        *,
        rungs: Tuple[str, ...] = ladder_for("cuda"),
        degrade_after: int = 2,
        max_respawns: int = 5,
        respawn_window: float = 300.0,
        healthy_seconds: float = 60.0,
        logger=None,
    ) -> None:
        unknown = [r for r in rungs if r not in RUNGS]
        if not rungs or unknown:
            raise ValueError(f"unknown rungs {unknown} (rungs: {RUNGS})")
        self._builder = builder
        self._logger = logger
        self.rungs = tuple(rungs)
        self.degrade_after = max(1, degrade_after)
        self.max_respawns = max(1, max_respawns)
        self.respawn_window = respawn_window
        self.healthy_seconds = healthy_seconds
        self._lock = threading.Lock()
        self._rung_idx = 0
        self._builds = 0
        self._streak = 0
        self._last_build = 0.0
        self._respawn_times: List[float] = []

    # -- introspection ----------------------------------------------------

    @property
    def rung(self) -> str:
        with self._lock:
            return self.rungs[self._rung_idx]

    @property
    def respawns(self) -> int:
        with self._lock:
            return max(0, self._builds - 1)

    # -- the builder seam --------------------------------------------------

    def build(self):
        """Build (or respawn) the supervised service. Matches the
        engine factory's ``service_builder`` signature."""
        now = time.monotonic()
        with self._lock:
            respawn = self._builds > 0
            if respawn:
                if (
                    self.healthy_seconds > 0
                    and now - self._last_build > self.healthy_seconds
                ):
                    self._streak = 0  # previous service lived long enough
                self._streak += 1
                self._respawn_times = [
                    t for t in self._respawn_times
                    if now - t < self.respawn_window
                ]
                if len(self._respawn_times) >= self.max_respawns:
                    raise RespawnBudgetExhausted(
                        f"{len(self._respawn_times)} respawns in the last "
                        f"{self.respawn_window:.0f}s — refusing to thrash"
                    )
                self._respawn_times.append(now)
                if (
                    self._streak >= self.degrade_after
                    and self._rung_idx < len(self.rungs) - 1
                ):
                    frm = self.rungs[self._rung_idx]
                    self._rung_idx += 1
                    self._streak = 0
                    to = self.rungs[self._rung_idx]
                    _DEGRADATIONS.inc(**{"from": frm, "to": to})
                    if self._logger is not None:
                        self._logger.error(
                            f"Degrading eval path {frm} -> {to} after "
                            "repeated service deaths."
                        )
            request = self.rungs[self._rung_idx]
            builds = self._builds
        if respawn:
            _RESPAWNS.inc()
        t0 = time.monotonic()
        svc = self._builder(request)
        realized = getattr(svc, "psqt_path", None)
        with self._lock:
            self._builds = builds + 1
            self._last_build = time.monotonic()
        if _telemetry.enabled():
            _SPANS.record(
                RECOVER_STAGE, t0,
                rung=realized or request or "auto",
                respawn=int(respawn),
            )
        if self._logger is not None and respawn:
            self._logger.info(f"Respawned search service (path {request}).")
        return svc
