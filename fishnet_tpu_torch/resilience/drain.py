"""Graceful-drain state: one process-wide flag with a telemetry face.

The port's copy of ``fishnet_tpu/resilience/drain.py``. The drain
contract: on SIGTERM the client stops acquiring, flushes in-flight
batches within a deadline (``--drain-deadline``, 25 s by default),
aborts the remainder upstream (accounted — the server reassigns), and
exits 0. This module owns the *observable* half of that contract:

* ``fishnet_drain_state`` gauge — 0 serving, 1 draining — so a fleet
  dashboard can see which processes are on the way out;
* a ``drain`` EVENT span (telemetry/spans.py) marking when the drain
  began, with its reason and deadline, when telemetry is on;
* a ``/healthz`` readiness provider: while draining, readiness is 503
  (``draining: true`` in the body, with the reason, the seconds since
  the drain began, the deadline and the queue's remaining work) so an
  orchestrator stops routing work at a dying process, while
  ``/healthz/live`` stays 200 — the process is alive and flushing, not
  wedged (the liveness-vs-readiness split, telemetry/exporter.py).

Single-process behavior is unchanged when drain is never entered: the
gauge sits at 0 and the readiness provider is only registered by the
first :func:`begin`, so a process that never receives SIGTERM serves
the exact same ``/healthz`` bodies as before this module existed.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.telemetry.exporter import (
    register_health_provider,
    unregister_health_provider,
)

#: 0 = serving, 1 = draining. Set to 0 at import so the family is
#: present on /metrics from process start.
_DRAIN_GAUGE = _telemetry.REGISTRY.gauge(
    "fishnet_drain_state",
    "Graceful-drain state: 0 serving, 1 draining (readiness is 503).",
)
_DRAIN_GAUGE.set(0)

_lock = threading.Lock()
_draining = False
_reason: Optional[str] = None
_since: Optional[float] = None
_deadline: Optional[float] = None
_depth_fn: Optional[Callable[[], Optional[dict]]] = None


def _provider() -> dict:
    """/healthz readiness provider: unhealthy (-> 503) while draining."""
    with _lock:
        draining = _draining
        reason = _reason
        since = _since
        deadline = _deadline
        depth_fn = _depth_fn
    state: dict = {"healthy": not draining, "draining": draining}
    if draining:
        state["reason"] = reason
        if since is not None:
            state["draining_for_s"] = round(time.monotonic() - since, 3)
        if deadline is not None:
            state["deadline_s"] = deadline
        if depth_fn is not None:
            try:
                pending = depth_fn()
            except Exception:  # noqa: BLE001 - a broken probe must not 500
                pending = None
            if pending is not None:
                state["pending"] = pending
    return state


def begin(
    reason: str,
    deadline: Optional[float] = None,
    depth_fn: Optional[Callable[[], Optional[dict]]] = None,
) -> bool:
    """Enter the draining state (idempotent). Returns True on the
    transition, False if already draining. ``depth_fn`` optionally
    reports remaining work (the client's ``queue_depth``) in the
    readiness body so an operator can watch the flush progress."""
    global _draining, _reason, _since, _deadline, _depth_fn
    with _lock:
        if _draining:
            return False
        _draining = True
        _reason = reason
        _since = time.monotonic()
        _deadline = deadline
        _depth_fn = depth_fn
    _DRAIN_GAUGE.set(1)
    register_health_provider("drain", _provider)
    if _telemetry.enabled():
        fields = {"reason": reason}
        if deadline is not None:
            fields["deadline_s"] = deadline
        _telemetry.RECORDER.record("drain", _since, **fields)
    return True


def draining() -> bool:
    with _lock:
        return _draining


def reset() -> None:
    """Back to serving (tests; a real process exits after draining)."""
    global _draining, _reason, _since, _deadline, _depth_fn
    with _lock:
        _draining = False
        _reason = None
        _since = None
        _deadline = None
        _depth_fn = None
    _DRAIN_GAUGE.set(0)
    unregister_health_provider("drain")
