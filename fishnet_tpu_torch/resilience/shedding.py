"""Admission control and load shedding for the multi-tenant front end.

The port's copy of ``fishnet_tpu/resilience/shedding.py``, with its
metrics (``fishnet_admission_total{lane,decision}``,
``fishnet_shed_active``) on the port's registry.

The serving plane has two priority lanes:

* ``latency`` — best-move jobs. A game is waiting on this move; the lane
  is admitted up to a hard bound far above anything a healthy worker
  queues, so its p99 survives saturation of the bulk lane.
* ``throughput`` — analysis jobs. Bulk work with no interactive
  deadline; this is the lane that sheds under overload.

Shedding is *accounted*, never silent: a shed batch is recorded in the
exactly-once ledger (``record_abandoned(_, "shed")``) and aborted back
to the server, which reassigns it to another worker — the same contract
as the reference's abandon-by-timeout path, just explicit and
immediate. The ledger therefore stays 0-lost/0-duplicated straight
through an overload episode.

The policy is a watermark pair with hysteresis: shedding starts when
the throughput lane's queued depth crosses the high watermark and stops
only once it falls back under the low watermark, so the decision does
not flap batch-by-batch at the boundary. Effective capacity shrinks
when the serving plane is already degraded — an open submit breaker or
a degradation-ladder rung below "fused" halves (or quarters) the
watermarks, shedding earlier because the plane is provably slower.

``RUNG_CAPACITY_SCALE`` keeps the JAX package's map by rung name, but
the port's ladders differ (resilience/supervisor.py ``ladder_for``): on
CUDA it goes ``fused`` -> ``host-material``, so one step down the card's
ladder quarters capacity where one step on the TPU (``xla``) halves it;
on the CPU the top rung is ``xla``, so a ``--device cpu`` client sheds
at half the watermarks from its first batch; a split-plane frontend's
only rung is ``host-material`` (a quarter).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from fishnet_tpu_torch import telemetry as _telemetry

#: Lane names — a stable label contract (the JAX package's).
LANE_LATENCY = "latency"
LANE_THROUGHPUT = "throughput"
LANES = (LANE_LATENCY, LANE_THROUGHPUT)

#: Admission decisions (the ``decision`` label on the counter below).
ADMIT = "admit"
SHED = "shed"

#: Default high watermark: queued *positions* in the throughput lane.
DEFAULT_HIGH_WATERMARK = 256

#: Latency-lane hard bound as a multiple of the high watermark. The
#: latency lane is never shed by load — only by this sanity bound
#: against a pathological flood of move jobs.
LATENCY_BOUND_FACTOR = 4

#: Capacity scale per degradation rung (resilience/supervisor.py
#: RUNGS): a degraded plane sheds earlier.
RUNG_CAPACITY_SCALE = {"fused": 1.0, "xla": 0.5, "host-material": 0.25}

_ADMISSIONS = _telemetry.REGISTRY.counter(
    "fishnet_admission_total",
    "Admission-control decisions on acquired batches.",
    labelnames=("lane", "decision"),
)
_SHED_ACTIVE = _telemetry.REGISTRY.gauge(
    "fishnet_shed_active",
    "1 while the throughput lane is shedding (watermark hysteresis).",
)


class ShedPolicy:
    """Watermark-hysteresis admission for the two serving lanes.

    ``breaker_open_fn``/``rung_fn`` are optional probes into the
    resilience plane (supervisor breaker state, degradation-ladder
    rung); both are read on every decision so capacity tracks the
    plane's health without any registration dance.
    """

    def __init__(
        self,
        high_watermark: int = DEFAULT_HIGH_WATERMARK,
        low_watermark: Optional[int] = None,
        latency_bound: Optional[int] = None,
        breaker_open_fn: Optional[Callable[[], bool]] = None,
        rung_fn: Optional[Callable[[], str]] = None,
    ) -> None:
        self.high_watermark = max(1, int(high_watermark))
        self.low_watermark = (
            max(1, int(low_watermark))
            if low_watermark is not None
            else max(1, self.high_watermark // 2)
        )
        self.latency_bound = (
            max(1, int(latency_bound))
            if latency_bound is not None
            else self.high_watermark * LATENCY_BOUND_FACTOR
        )
        self._breaker_open_fn = breaker_open_fn
        self._rung_fn = rung_fn
        self._shedding = False
        self.shed_count = 0
        self.admit_count = 0

    def set_watermarks(self, pair, low: Optional[int] = None) -> None:
        """Control-plane actuation: re-tune the watermark pair at
        runtime. Accepts ``set_watermarks((high, low))`` — the actuator
        registry's pair-knob shape — or ``set_watermarks(high, low)``;
        a missing low re-derives as high//2, and low is clamped under
        high. The latency bound is left alone: it is an SLO-shaped
        promise, not a congestion knob."""
        if isinstance(pair, (tuple, list)):
            high = pair[0]
            if len(pair) > 1:
                low = pair[1]
        else:
            high = pair
        self.high_watermark = max(1, int(high))
        self.low_watermark = min(
            max(1, int(low)) if low is not None
            else max(1, self.high_watermark // 2),
            self.high_watermark,
        )

    # -- capacity ---------------------------------------------------------

    def _scale(self) -> float:
        scale = 1.0
        if self._rung_fn is not None:
            scale = RUNG_CAPACITY_SCALE.get(self._rung_fn(), 1.0)
        if self._breaker_open_fn is not None and self._breaker_open_fn():
            # Submissions are failing: the queue can only grow. Halve
            # capacity on top of any rung degradation.
            scale *= 0.5
        return scale

    def effective_high(self) -> int:
        return max(1, int(self.high_watermark * self._scale()))

    def effective_low(self) -> int:
        return min(
            max(1, int(self.low_watermark * self._scale())),
            self.effective_high(),
        )

    # -- decisions --------------------------------------------------------

    @property
    def shed_active(self) -> bool:
        return self._shedding

    def note_depth(self, throughput_depth: int) -> bool:
        """Update the hysteresis state from the current throughput-lane
        depth; returns the (possibly new) shed-active flag."""
        if self._shedding:
            if throughput_depth <= self.effective_low():
                self._shedding = False
        elif throughput_depth >= self.effective_high():
            self._shedding = True
        _SHED_ACTIVE.set(1.0 if self._shedding else 0.0)
        return self._shedding

    def admit(
        self, lane: str, n_positions: int, throughput_depth: int,
        latency_depth: int,
    ) -> str:
        """ADMIT or SHED one acquired batch of ``n_positions`` against
        the current lane depths. Updates hysteresis as a side effect."""
        self.note_depth(throughput_depth)
        if lane == LANE_LATENCY:
            decision = (
                SHED
                if latency_depth + n_positions > self.latency_bound
                else ADMIT
            )
        else:
            decision = SHED if self._shedding else ADMIT
        _ADMISSIONS.inc(lane=lane, decision=decision)
        if decision is SHED:
            self.shed_count += 1
        else:
            self.admit_count += 1
        return decision

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Serving-state view for /healthz (telemetry/exporter.py)."""
        return {
            "shed_active": self._shedding,
            "high_watermark": self.effective_high(),
            "low_watermark": self.effective_low(),
            "latency_bound": self.latency_bound,
            "shed_count": self.shed_count,
            "admit_count": self.admit_count,
        }
