"""The typed actuator registry: bounded, revertible knob setters — the
port of ``fishnet_tpu/control/actuators.py``.

Every subsystem that the control plane tunes exports one setter through
an :class:`Actuator` row:

* **bounded** — the registry clamps every value into the actuator's
  declared ``[lo, hi]`` before the setter sees it (pair knobs clamp
  element-wise, weight maps clamp every entry), so no policy bug can
  push a subsystem outside its safe envelope;
* **revertible** — the value the subsystem held at registration is its
  static default; ``revert()`` / ``revert_all()`` restore it exactly,
  which is what makes ``FISHNET_NO_CONTROL=1`` an escape hatch even
  after a controller has been live;
* **observable** — every actuation bumps
  ``fishnet_control_actuations_total{knob,direction}``, refreshes
  ``fishnet_control_knob_value{knob}``, appends to the bounded actuation
  log (``fishnet_control_actuation_log``, which the fleet console's
  control panel reads), and records a ``control`` span (gated on
  ``telemetry.enabled()`` like every span site) so a trace shows why a
  knob moved.

With ``FISHNET_NO_CONTROL=1`` :meth:`ActuatorRegistry.apply` refuses to
move anything; ``revert`` still works, since restoring the static
defaults is what the hatch promises.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.telemetry import tracing as _tracing
from fishnet_tpu_torch.telemetry.registry import MetricFamily, Sample
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS

_ACTUATIONS = _telemetry.REGISTRY.counter(
    "fishnet_control_actuations_total",
    "Control-plane knob actuations, by knob and direction "
    "(up/down/set/revert).",
    labelnames=("knob", "direction"),
)
_KNOB_VALUE = _telemetry.REGISTRY.gauge(
    "fishnet_control_knob_value",
    "Current control-plane value per scalar knob (pair knobs report "
    "their high bound; map knobs report their entry count).",
    labelnames=("knob",),
)

#: Actuation-log ring depth per registry (the fleet console renders
#: the last few; the counter family carries the totals).
LOG_DEPTH = 8


@dataclass(frozen=True)
class Actuator:
    """One bounded, revertible knob binding. ``setter(value)`` applies
    a clamped value (``None`` = the subsystem's static default);
    shard-scoped setters additionally take ``shards`` (an iterable of
    shard indices, ``None`` = all) so the controller can skip shards
    mid-degradation. ``getter`` returns the live value when the
    subsystem can report one (used for direction + the gauge)."""

    name: str
    setter: Callable
    lo: float
    hi: float
    default: object
    getter: Optional[Callable[[], object]] = None
    shard_scoped: bool = False


@dataclass(frozen=True)
class Actuation:
    """One applied actuation, as kept in the log ring."""

    seq: int
    window: int
    knob: str
    direction: str
    value: object
    reason: str


def _clamp(act: Actuator, value):
    """Clamp ``value`` into the actuator's bounds. Scalars clamp
    directly; pairs element-wise; maps per entry. ``None`` passes
    through (= restore the static default)."""
    if value is None:
        return None
    if isinstance(value, dict):
        return {
            k: min(act.hi, max(act.lo, float(v))) for k, v in value.items()
        }
    if isinstance(value, (tuple, list)):
        return tuple(
            int(min(act.hi, max(act.lo, float(v)))) for v in value
        )
    if isinstance(value, float) and not float(value).is_integer():
        return min(act.hi, max(act.lo, float(value)))
    return int(min(act.hi, max(act.lo, float(value))))


def _scalar(value) -> Optional[float]:
    """Gauge projection: scalars as-is, pairs -> first element (the
    high bound), maps -> entry count, None -> None."""
    if value is None:
        return None
    if isinstance(value, dict):
        return float(len(value))
    if isinstance(value, (tuple, list)):
        return float(value[0]) if value else None
    return float(value)


class ActuatorRegistry:
    """Registration + application + revert, with the observability
    contract applied uniformly. Thread-safe; setters run OUTSIDE the
    registry lock (they take their own subsystem locks)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._actuators: Dict[str, Actuator] = {}
        self._current: Dict[str, object] = {}
        self._applied: Dict[str, bool] = {}
        self._log: Deque[Actuation] = deque(maxlen=LOG_DEPTH)
        self._seq = 0
        self._collector_token = _telemetry.REGISTRY.register_collector(
            self._collect, name="control-actuators"
        )

    def close(self) -> None:
        """Unregister the log collector (idempotent)."""
        token, self._collector_token = self._collector_token, None
        if token is not None:
            _telemetry.REGISTRY.unregister_collector(token)

    # -- registration -----------------------------------------------------

    def register(self, actuator: Actuator) -> None:
        with self._lock:
            if actuator.name in self._actuators:
                raise ValueError(f"actuator {actuator.name!r} registered twice")
            self._actuators[actuator.name] = actuator
            self._current[actuator.name] = actuator.default
            self._applied[actuator.name] = False

    def register_all(self, actuators) -> None:
        for act in actuators:
            self.register(act)

    def knobs(self) -> List[str]:
        with self._lock:
            return sorted(self._actuators)

    def is_shard_scoped(self, knob: str) -> bool:
        with self._lock:
            act = self._actuators.get(knob)
        return bool(act is not None and act.shard_scoped)

    def snapshot(self) -> Dict[str, object]:
        """Knob -> current value (live getter when available, else the
        last applied value; the static default before any apply)."""
        with self._lock:
            rows = list(self._actuators.items())
            current = dict(self._current)
        out: Dict[str, object] = {}
        for name, act in rows:
            if act.getter is not None:
                out[name] = act.getter()
            else:
                out[name] = current[name]
        return out

    def recent(self, n: int = LOG_DEPTH) -> List[Actuation]:
        with self._lock:
            return list(self._log)[-n:]

    # -- actuation --------------------------------------------------------

    def apply(
        self,
        knob: str,
        value,
        reason: str = "",
        window: int = 0,
        shards=None,
    ) -> Optional[Actuation]:
        """Clamp + apply one actuation. Returns the log entry, or None
        when nothing moved: value already current, the knob unknown, or
        the control plane disabled (FISHNET_NO_CONTROL=1)."""
        from fishnet_tpu_torch.control import control_enabled

        if not control_enabled():
            return None
        with self._lock:
            act = self._actuators.get(knob)
            prev = self._current.get(knob)
        if act is None:
            return None
        value = _clamp(act, value)
        if value == prev and shards is None:
            return None
        before, after = _scalar(prev), _scalar(value)
        if before is None or after is None or after == before:
            direction = "set"
        else:
            direction = "up" if after > before else "down"
        return self._actuate(act, value, direction, reason, window, shards)

    def revert(self, knob: str, reason: str = "revert") -> Optional[Actuation]:
        """Restore one knob's static default (works with the escape
        hatch set — that is the point of the hatch)."""
        with self._lock:
            act = self._actuators.get(knob)
            applied = self._applied.get(knob, False)
        if act is None or not applied:
            return None
        return self._actuate(act, act.default, "revert", reason, 0, None)

    def revert_all(self, reason: str = "revert") -> List[Actuation]:
        return [
            a for k in self.knobs()
            if (a := self.revert(k, reason=reason)) is not None
        ]

    def _actuate(
        self, act: Actuator, value, direction: str, reason: str,
        window: int, shards,
    ) -> Actuation:
        tel = _telemetry.enabled()
        t0 = time.monotonic() if tel else 0.0
        if act.shard_scoped:
            act.setter(value, shards=shards)
        else:
            act.setter(value)
        with self._lock:
            self._seq += 1
            entry = Actuation(
                seq=self._seq, window=window, knob=act.name,
                direction=direction, value=value, reason=reason,
            )
            self._log.append(entry)
            self._current[act.name] = value
            self._applied[act.name] = direction != "revert"
        _ACTUATIONS.inc(knob=act.name, direction=direction)
        gauge = _scalar(value if value is not None else act.default)
        if gauge is not None:
            _KNOB_VALUE.set(gauge, knob=act.name)
        if tel:
            _SPANS.record(
                "control", t0, trace=_tracing.new_trace(),
                knob=act.name, direction=direction,
                value=repr(value), window=window, reason=reason,
            )
        return entry

    # -- exposition -------------------------------------------------------

    def _collect(self):
        """Pull collector: the bounded actuation log as a gauge family
        (value = the actuation's signal window; labels carry the what
        and the which-way). The fleet console's control panel sorts
        by ``seq`` for "last N actuations per proc"."""
        with self._lock:
            entries = list(self._log)
        fam = MetricFamily(
            name="fishnet_control_actuation_log",
            type="gauge",
            help="Recent control-plane actuations (value = signal "
                 "window; bounded ring).",
        )
        for e in entries:
            fam.samples.append(Sample(
                name="fishnet_control_actuation_log",
                value=float(e.window),
                labels={
                    "seq": str(e.seq), "knob": e.knob,
                    "direction": e.direction, "to": repr(e.value),
                },
            ))
        return [fam]
