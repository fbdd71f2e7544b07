"""Control-signal folding: windowed, hysteresis-smoothed snapshots of
the in-process telemetry sources — the port of
``fishnet_tpu/control/signals.py``.

The collector taps the same sources the observability plane exports; it
never scrapes its own process over HTTP:

* stage durations through the span recorder's one stage-observer slot
  (:func:`fishnet_tpu_torch.telemetry.spans.set_stage_observer`),
  chained: an observer already in the slot (the profiler's histogram
  feed) keeps seeing every span;
* per-component attribution with the critical-path stage map, folded a
  window and smoothed by :class:`HysteresisSwitch` so the dominant
  component does not flap on one noisy window;
* SLO burn rates from :meth:`fishnet_tpu_torch.telemetry.slo.SLOEngine
  .burn_snapshot`;
* cost books from :data:`fishnet_tpu_torch.telemetry.cost.LEDGER`;
* the coalescer's occupancy and the shards' rungs from ``SearchService
  .shard_report()``, dispatch counters from ``counters()``, the AZ
  plane's fill from its ``counters()``, and the lanes' depths from
  ``LaneScheduler.depths()``.

Every :meth:`SignalCollector.sample` call closes one window and bumps
the window counter; the controller keys every decision to that counter
(never the wall clock), so the decision path is a deterministic function
of the observed traffic.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from fishnet_tpu_torch.telemetry import spans as _spans

#: Stage -> critical-path component, duration-sum flavor of the
#: interval-sweep map in telemetry/critical_path.py (``dispatch_wait``
#: is the decode worker blocked on wire + device compute, so it stands
#: in for the in-flight ``device_compute`` interval here).
STAGE_COMPONENT: Dict[str, str] = {
    "pack": "pack",
    "device_step": "pack",
    "dispatch_issue": "transport",
    "coalesce": "transport",
    "dispatch_wait": "compute",
    "wire_decode": "decode_wait",
    "queue_wait": "queue_wait",
    "submit": "submit",
}

COMPONENTS = (
    "pack", "transport", "compute", "decode_wait", "queue_wait", "submit",
)


class _StageAccum:
    """Per-thread stage-duration cells behind the stage-observer slot.

    The observer runs inside ``SpanRecorder.record()`` on the recording
    thread, so its hot path must stay lock-free: each recording thread
    owns one cell (``dict stage -> [sum_s, count]``, single writer,
    GIL-atomic list mutation), and only cell CREATION takes the lock —
    the same discipline as the metrics registry's per-thread counters.
    ``fold()`` (control cadence, ~Hz) sums a racy snapshot across
    cells; at worst one in-flight sample lands in the next window.
    """

    def __init__(self) -> None:
        self._local = threading.local()
        self._cells: List[Dict[str, List[float]]] = []
        self._lock = threading.Lock()

    def observe(self, stage: str, duration_s: float) -> None:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = {}
            with self._lock:
                self._cells.append(cell)
            self._local.cell = cell
        acc = cell.get(stage)
        if acc is None:
            cell[stage] = [duration_s, 1.0]
        else:
            acc[0] += duration_s
            acc[1] += 1.0

    def fold(self) -> Dict[str, List[float]]:
        """Cumulative ``{stage: [sum_s, count]}`` across every cell."""
        with self._lock:
            cells = list(self._cells)
        out: Dict[str, List[float]] = {}
        for cell in cells:
            for stage, acc in list(cell.items()):
                tot = out.setdefault(stage, [0.0, 0.0])
                tot[0] += acc[0]
                tot[1] += acc[1]
        return out


class HysteresisSwitch:
    """Dominance smoothing: the reported dominant component only
    switches when a challenger leads by ``margin`` share for ``hold``
    CONSECUTIVE windows — one noisy window never re-tunes the system.
    Deterministic: state is a pure function of the update sequence."""

    def __init__(self, margin: float = 0.10, hold: int = 2) -> None:
        self.margin = margin
        self.hold = max(1, int(hold))
        self.current: Optional[str] = None
        self._challenger: Optional[str] = None
        self._streak = 0

    def update(self, shares: Dict[str, float]) -> Optional[str]:
        if not shares:
            self._challenger, self._streak = None, 0
            return self.current
        top = max(sorted(shares), key=lambda k: shares[k])
        if self.current is None:
            self.current = top
            return self.current
        if top == self.current:
            self._challenger, self._streak = None, 0
            return self.current
        lead = shares[top] - shares.get(self.current, 0.0)
        if lead < self.margin:
            self._challenger, self._streak = None, 0
            return self.current
        if top == self._challenger:
            self._streak += 1
        else:
            self._challenger, self._streak = top, 1
        if self._streak >= self.hold:
            self.current = top
            self._challenger, self._streak = None, 0
        return self.current


@dataclass
class ControlSignals:
    """One window's folded snapshot — everything a policy may read.
    ``window`` is the decision key; nothing here carries a wall-clock
    timestamp, so identical traffic yields identical snapshots."""

    window: int
    #: Per-component stage-duration sums for THIS window (ms).
    components: Dict[str, float] = field(default_factory=dict)
    #: Hysteresis-smoothed dominant component (None until traffic).
    dominant: Optional[str] = None
    dominant_share: float = 0.0
    #: Coalescer occupancy EMA per shard (shard_report()["occupancy"]).
    occupancy: List[float] = field(default_factory=list)
    #: Degradation steps per shard ABOVE the healthiest rung this
    #: collector has observed for it (0 = healthy). The raw
    #: ``rung_index`` is an absolute _MESH_RUNGS position and a healthy
    #: service may legitimately idle mid-ladder (CPU runs serve from
    #: "xla"), so the collector baselines per shard rather than
    #: hard-coding rung 0.
    shard_rungs: List[int] = field(default_factory=list)
    #: Service counter DELTAS for this window (dispatches, eval_steps,
    #: decode_queue, cache hits, ...).
    counters: Dict[str, float] = field(default_factory=dict)
    #: Pre-dispatch eval-cache hit rate over the window (0 with no
    #: eval traffic).
    cache_hit_rate: float = 0.0
    #: SLO name -> status ("ok" / "burning" / "breach").
    slo_status: Dict[str, str] = field(default_factory=dict)
    #: Tenant -> share of window device-ms (cost books; empty with the
    #: cost plane off or no attributed traffic).
    tenant_cost_share: Dict[str, float] = field(default_factory=dict)
    #: Lane -> queue depth (frontend scheduler; empty standalone).
    queue_depths: Dict[str, int] = field(default_factory=dict)


class SignalCollector:
    """Folds the live sources into :class:`ControlSignals` windows.

    ``attach()`` installs the chained stage observer; ``detach()``
    restores whatever was installed before (the profiler's feed
    survives both). ``sample()`` closes a window: per-stage deltas
    since the previous sample, component shares through the
    hysteresis switch, plus the service / SLO / cost / queue reads.
    """

    def __init__(
        self,
        service=None,
        slo_engine=None,
        scheduler=None,
        counters_fn: Optional[Callable[[], Dict[str, int]]] = None,
        az_plane=None,
        margin: float = 0.10,
        hold: int = 2,
    ) -> None:
        self._service = service
        self._slo = slo_engine
        self._scheduler = scheduler
        self._counters_fn = counters_fn
        self._az_plane = az_plane
        self._last_az: Dict[str, float] = {}
        self._accum = _StageAccum()
        self._switch = HysteresisSwitch(margin=margin, hold=hold)
        self._window = 0
        self._last_stage: Dict[str, List[float]] = {}
        self._last_counters: Dict[str, int] = {}
        self._last_cost: Dict[str, float] = {}
        self._rung_floor: List[int] = []
        self._prev_observer = None
        self._attached = False

    # -- observer plumbing ------------------------------------------------

    def attach(self) -> "SignalCollector":
        """Install the stage observer, CHAINING any existing one (the
        profiler installs its histogram feed through the same single
        slot; both must keep seeing every span)."""
        if self._attached:
            return self
        prev = _spans.STAGE_OBSERVER
        self._prev_observer = prev
        accum = self._accum

        if prev is None:
            _spans.set_stage_observer(accum.observe)
        else:
            def chained(stage: str, duration_s: float) -> None:
                prev(stage, duration_s)
                accum.observe(stage, duration_s)

            _spans.set_stage_observer(chained)
        self._attached = True
        return self

    def detach(self) -> None:
        """Restore the pre-attach observer. If someone re-installed the
        slot after us (profiler restart), leave their observer alone —
        our accumulator simply stops being fed."""
        if not self._attached:
            return
        self._attached = False
        cur = _spans.STAGE_OBSERVER
        if cur is not None and getattr(cur, "__self__", None) is self._accum:
            _spans.set_stage_observer(self._prev_observer)
        elif cur is not None and cur.__code__.co_name == "chained":
            _spans.set_stage_observer(self._prev_observer)
        self._prev_observer = None

    # -- feeding (tests inject synthetic stage traffic here) --------------

    def feed(self, stage: str, duration_s: float) -> None:
        """Directly feed one stage duration (what the observer does)."""
        self._accum.observe(stage, duration_s)

    # -- sampling ---------------------------------------------------------

    @property
    def window(self) -> int:
        return self._window

    def sample(self) -> ControlSignals:
        """Close one window and return its snapshot."""
        self._window += 1
        sig = ControlSignals(window=self._window)

        # Stage durations -> component sums (window deltas, ms).
        folded = self._accum.fold()
        comps: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
        for stage, (total_s, _count) in folded.items():
            comp = STAGE_COMPONENT.get(stage)
            if comp is None:
                continue
            prev = self._last_stage.get(stage, [0.0, 0.0])[0]
            comps[comp] += max(0.0, total_s - prev) * 1e3
        self._last_stage = folded
        sig.components = comps
        live = sum(comps.values())
        if live > 0.0:
            shares = {c: v / live for c, v in comps.items()}
            sig.dominant = self._switch.update(shares)
            sig.dominant_share = shares.get(sig.dominant, 0.0)
        else:
            sig.dominant = self._switch.current
            sig.dominant_share = 0.0

        # Service: shard rungs / occupancy + counter deltas.
        svc = self._service
        if svc is not None:
            rep = svc.shard_report()
            sig.occupancy = list(rep.get("occupancy", []))
            idx = list(rep.get("rung_index", []))
            if len(self._rung_floor) != len(idx):
                self._rung_floor = list(idx)
            else:
                self._rung_floor = [
                    min(f, c) for f, c in zip(self._rung_floor, idx)
                ]
            sig.shard_rungs = [
                c - f for c, f in zip(idx, self._rung_floor)
            ]
        counters_fn = self._counters_fn or (
            svc.counters if svc is not None else None
        )
        if counters_fn is not None:
            cur = counters_fn()
            delta = {
                k: float(v - self._last_counters.get(k, 0))
                for k, v in cur.items()
                if isinstance(v, (int, float))
            }
            # Level gauges ride as-is, not as deltas.
            for k in ("decode_queue", "inflight_dispatches",
                      "async_ready_queue", "latency_active",
                      "prefetch_budget", "dispatch_fill",
                      "speculation_budget"):
                if k in cur:
                    delta[k] = float(cur[k])
            self._last_counters = cur
            sig.counters = delta
            shipped = max(1.0, delta.get("evals_shipped", 0.0))
            sig.cache_hit_rate = min(
                1.0,
                (delta.get("cache_prewire_hits", 0.0)
                 + delta.get("tt_eval_hits", 0.0)) / shipped,
            )

        # AZ dispatch plane: WINDOW fill ratio (real rows over shipped
        # device slots this window — the speculation rule's pin signal)
        # plus pad/speculation deltas. ``dispatch_fill`` is set only
        # when the window shipped slots: a quiet window must not read
        # as "0% fill" and flap the speculation pin.
        plane = self._az_plane
        if plane is not None:
            az = plane.counters()
            rows = float(az.get("rows_dispatched", 0))
            slots = float(az.get("slots_dispatched", 0))
            drows = rows - self._last_az.get("rows", 0.0)
            dslots = slots - self._last_az.get("slots", 0.0)
            self._last_az["rows"] = rows
            self._last_az["slots"] = slots
            if dslots > 0.0:
                sig.counters["dispatch_fill"] = min(1.0, drows / dslots)
            for k in ("pad_rows", "spec_rows"):
                v = float(az.get(k, 0))
                sig.counters["az_" + k] = v - self._last_az.get(k, 0.0)
                self._last_az[k] = v
            sig.counters["speculation_budget"] = float(
                az.get("speculation_budget", 0)
            )

        # SLO burn (programmatic seam — no self-scrape over HTTP).
        if self._slo is not None:
            snap = self._slo.burn_snapshot()
            sig.slo_status = {
                name: entry["status"] for name, entry in snap.items()
            }

        # Cost books: window device-ms share per tenant.
        from fishnet_tpu_torch.telemetry import cost as _cost

        if _cost.enabled():
            book = _cost.LEDGER.snapshot()
            tenants = book.get("tenant_device_ms", {}) or {}
            deltas = {
                t: max(0.0, ms - self._last_cost.get(t, 0.0))
                for t, ms in tenants.items()
            }
            self._last_cost = dict(tenants)
            total = sum(deltas.values())
            if total > 0.0:
                sig.tenant_cost_share = {
                    t: d / total for t, d in deltas.items()
                }

        # Lane queue depths (frontend scheduler, when wired).
        if self._scheduler is not None:
            sig.queue_depths = dict(self._scheduler.depths())
        return sig
