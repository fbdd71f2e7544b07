"""The deterministic rule/probe controller — the port of
``fishnet_tpu/control/controller.py``.

The decision path is a pure function of the folded signal window: no
wall clock, no randomness. The optional background thread only paces
``step()``; the cadence never changes what any window decides, so a test
can drive the same windows synchronously and pin the exact actuation
sequence.

:class:`RuleProbePolicy` is the starting policy: critical-path rules and
a measured hill-climb over the coalesce width. Another policy drops in
behind the :class:`Policy` protocol without touching the loop.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol

from fishnet_tpu_torch.control.actuators import ActuatorRegistry
from fishnet_tpu_torch.control.signals import ControlSignals, SignalCollector

log = logging.getLogger("fishnet.control")

#: Shed-watermark floor the policy never tightens below.
WATERMARK_FLOOR = 64
#: Cache-hit-rate thresholds for pinning / unpinning prefetch (mirrors
#: the service's own prefetch-steering hysteresis, search/service.py).
PREFETCH_PIN = 0.6
PREFETCH_UNPIN = 0.3
#: Dispatch-fill thresholds for pinning / unpinning speculative
#: pad-row evals (az_plane.set_speculation_budget): above PIN the pow2
#: buckets are nearly full — speculation has no free slots to ride and
#: would only displace padding that does not exist; below UNPIN the
#: padding is back and the static budget is restored.
SPECULATION_PIN = 0.9
SPECULATION_UNPIN = 0.5
#: A tenant must burn more than this share of window device-ms before
#: an SLO burn reweights its admission.
COST_HOG_SHARE = 0.5
#: Coalesce-width probe rungs (doubling ladder up to the coalescer's
#: MAX_WIDTH).
WIDTH_LADDER = (1, 2, 4, 8)


class LadderProbe:
    """Deterministic 1-D hill-climb over a fixed knob ladder, scored by
    a throughput proxy fed one live window at a time.

    Whether a wider coalesce window pays depends on the backend's fused
    -dispatch economics (a CPU segmented dispatch can cost several
    single dispatches; a fused launch on the card amortizes its fixed
    cost), so the policy MEASURES
    instead of assuming a direction: hold the incumbent rung for
    ``settle`` windows, step one rung (narrower first — undoing a
    narrow step is cheap), hold again, and keep the move only when the
    score improved by ``min_gain``. A failed trial steps back, backs
    off for an exponentially growing hold (capped at ``max_hold``
    windows), and tries the other direction next. State is a pure
    function of the fed ``(rung, score)`` sequence — no wall clock —
    so tests replay exact probe schedules."""

    def __init__(
        self,
        ladder=WIDTH_LADDER,
        settle: int = 4,
        min_gain: float = 0.05,
        max_hold: int = 64,
    ) -> None:
        self.ladder = tuple(ladder)
        self.settle = max(1, int(settle))
        self.min_gain = min_gain
        self.max_hold = max_hold
        self._scores: List[float] = []
        self._ref: Optional[float] = None
        self._trial: Optional[tuple] = None
        self._dir = -1
        self._hold = 0
        self._hold_len = self.settle

    def index_of(self, value) -> int:
        """Nearest ladder rung for an arbitrary knob value (an external
        pin may have parked the knob off-ladder)."""
        return min(
            range(len(self.ladder)),
            key=lambda i: (abs(self.ladder[i] - value), i),
        )

    def update(self, idx: int, score: float):
        """Feed one live window at rung ``idx``. Returns ``(next_idx,
        kind)`` when the probe wants to move — ``"trial"`` steps onto a
        candidate rung, ``"revert"`` undoes a failed trial — else
        ``None`` (measuring, or backing off)."""
        if self._hold > 0:
            self._hold -= 1
            return None
        self._scores.append(score)
        if len(self._scores) < self.settle:
            return None
        mean = sum(self._scores) / len(self._scores)
        del self._scores[:]
        if self._trial is None:
            self._ref = mean
            nxt = idx + self._dir
            if not 0 <= nxt < len(self.ladder):
                self._dir = -self._dir
                nxt = idx + self._dir
                if not 0 <= nxt < len(self.ladder):
                    return None
            self._trial = (idx, nxt)
            return (nxt, "trial")
        frm, _to = self._trial
        self._trial = None
        if self._ref is not None and mean >= self._ref * (1.0 + self.min_gain):
            self._hold_len = self.settle  # progress: reset the backoff
            return None
        self._hold = self._hold_len
        self._hold_len = min(self.max_hold, self._hold_len * 2)
        self._dir = -self._dir
        return (frm, "revert")


@dataclass(frozen=True)
class Action:
    """One policy decision: move ``knob`` to ``value`` (``None`` =
    revert to the subsystem's static default)."""

    knob: str
    value: object
    reason: str


class Policy(Protocol):
    """Decision seam: window signals + current knob values -> actions.
    Implementations must be deterministic in their input sequence."""

    def decide(
        self, sig: ControlSignals, knobs: Dict[str, object]
    ) -> List[Action]:
        ...


class RuleProbePolicy:
    """Critical-path rules over the folded signals:

    * transport-dominated with live eval traffic -> hill-climb the
      coalesce width along :data:`WIDTH_LADDER` with a
      :class:`LadderProbe`, scored by the window's ``eval_steps``
      throughput — the probe DISCOVERS whether fusing dispatches pays
      on this backend instead of assuming a direction;
    * a standing decode queue (whatever dominates the stage sums) ->
      deepen the async pipeline (+1, cap 4);
    * any SLO burning or breached -> halve the shed high watermark
      (floor 64) and, when one tenant burns most of the window's
      device-ms, downweight its DRR admission;
    * pre-dispatch cache hot (hit rate > 0.6) -> pin prefetch off;
      cold again (< 0.3) -> restore adaptive prefetch;
    * AZ dispatch fill high (> 0.9) -> pin the speculative pad-row
      budget to 0 (the pow2 buckets carry no padding worth filling);
      fill back under 0.5 -> restore the bind-time budget;
    * ``calm_hold`` consecutive QUIESCENT windows (no eval traffic, no
      rule fired, no SLO burning) -> step ONE moved knob back toward
      its static default per window, sorted order, so a transient
      burst does not leave an idle system permanently re-tuned. While
      traffic flows the probe's operating point sticks; the default
      hold (20 windows, ~2 s at the stock 0.1 s cadence) rides out the
      momentary zero-throughput windows a live pipeline produces.

    State is the calm-streak counter plus the width probe's ladder
    state — both deterministic in the window sequence.
    """

    def __init__(self, calm_hold: int = 20) -> None:
        self.calm_hold = max(1, int(calm_hold))
        self._calm = 0
        self.width_probe = LadderProbe()

    def decide(
        self, sig: ControlSignals, knobs: Dict[str, object]
    ) -> List[Action]:
        actions: List[Action] = []
        slo_hot = any(
            status in ("burning", "breach")
            for status in sig.slo_status.values()
        )
        throughput = sig.counters.get("eval_steps", 0.0)
        live = throughput > 0.0

        if sig.dominant == "transport" and live and "coalesce_width" in knobs:
            cur = knobs.get("coalesce_width")
            probe = self.width_probe
            idx = probe.index_of(int(cur) if cur else probe.ladder[0])
            move = probe.update(idx, throughput)
            if move is not None and move[0] != idx:
                nxt, kind = move
                actions.append(Action(
                    "coalesce_width", probe.ladder[nxt],
                    f"transport-dominated ({sig.dominant_share:.0%}): "
                    + ("probe trial" if kind == "trial"
                       else "trial regressed, step back"),
                ))
        # Standing decode queue: the async pipeline is the bottleneck
        # regardless of which component dominates the stage sums, so
        # this rule is not gated on ``dominant``.
        if sig.counters.get("decode_queue", 0.0) > 0.0:
            cur = knobs.get("pipeline_depth")
            cur = int(cur) if cur else 2
            if cur < 4:
                actions.append(Action(
                    "pipeline_depth", cur + 1,
                    "standing decode queue: deepen the async pipeline",
                ))

        if slo_hot:
            pair = knobs.get("shed_watermark")
            if isinstance(pair, (tuple, list)) and pair:
                high = int(pair[0])
                if high > WATERMARK_FLOOR:
                    new_high = max(WATERMARK_FLOOR, high // 2)
                    actions.append(Action(
                        "shed_watermark", (new_high, new_high // 2),
                        "SLO burning: tighten shed watermarks",
                    ))
            if sig.tenant_cost_share:
                top = max(
                    sorted(sig.tenant_cost_share),
                    key=lambda t: sig.tenant_cost_share[t],
                )
                if sig.tenant_cost_share[top] > COST_HOG_SHARE:
                    weights = dict(knobs.get("tenant_weights") or {})
                    if weights.get(top) != 0.5:
                        weights[top] = 0.5
                        actions.append(Action(
                            "tenant_weights", weights,
                            f"SLO burning: downweight cost hog {top}",
                        ))

        if "prefetch_budget" in knobs:
            pinned = knobs.get("prefetch_budget") is not None
            if sig.cache_hit_rate > PREFETCH_PIN and not pinned:
                actions.append(Action(
                    "prefetch_budget", 0,
                    f"cache hot ({sig.cache_hit_rate:.0%}): pin "
                    "prefetch off",
                ))
            elif sig.cache_hit_rate < PREFETCH_UNPIN and pinned:
                actions.append(Action(
                    "prefetch_budget", None,
                    f"cache cold ({sig.cache_hit_rate:.0%}): restore "
                    "adaptive prefetch",
                ))

        if "speculation_budget" in knobs:
            fill = sig.counters.get("dispatch_fill")
            pinned = knobs.get("speculation_budget") is not None
            if fill is not None:
                if fill > SPECULATION_PIN and not pinned:
                    actions.append(Action(
                        "speculation_budget", 0,
                        f"dispatch fill {fill:.0%}: padding scarce, "
                        "pin speculation off",
                    ))
                elif fill < SPECULATION_UNPIN and pinned:
                    actions.append(Action(
                        "speculation_budget", None,
                        f"dispatch fill {fill:.0%}: padding back, "
                        "restore speculation budget",
                    ))

        if actions or slo_hot or live:
            # Live traffic keeps the current tuning earning its keep:
            # step-back waits for quiescence, not just for quiet rules.
            self._calm = 0
            return actions

        self._calm += 1
        if self._calm >= self.calm_hold:
            for knob in sorted(knobs):
                if knobs.get(knob) is None:
                    continue
                if knob in ("prefetch_budget", "speculation_budget"):
                    # Pinning is governed by the hit-rate / dispatch-fill
                    # rules above, not the calm step-back.
                    continue
                self._calm = 0
                return [Action(
                    knob, None,
                    f"calm for {self.calm_hold} windows: step back",
                )]
        return []


class Controller:
    """The loop: sample a window, ask the policy, actuate — skipping
    shard-scoped actuation on any shard mid-degradation (rung != 0),
    because the degradation ladder is already re-tuning that shard and
    two controllers fighting over one knob helps nobody."""

    def __init__(
        self,
        collector: SignalCollector,
        registry: ActuatorRegistry,
        policy: Optional[Policy] = None,
    ) -> None:
        self.collector = collector
        self.registry = registry
        self.policy = policy or RuleProbePolicy()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_signals: Optional[ControlSignals] = None

    def step(self):
        """Close one signal window and apply the policy's actions.
        Returns the applied :class:`Actuation` list (empty when the
        escape hatch is set — the window still advances so re-enabling
        resumes cleanly)."""
        from fishnet_tpu_torch.control import control_enabled

        sig = self.collector.sample()
        self.last_signals = sig
        if not control_enabled():
            return []
        knobs = self.registry.snapshot()
        applied = []
        for action in self.policy.decide(sig, knobs):
            shards = None
            if self.registry.is_shard_scoped(action.knob) and sig.shard_rungs:
                eligible = [
                    i for i, rung in enumerate(sig.shard_rungs) if rung == 0
                ]
                if not eligible:
                    continue
                if len(eligible) < len(sig.shard_rungs):
                    shards = eligible
            if action.value is None:
                entry = self.registry.revert(action.knob, reason=action.reason)
            else:
                entry = self.registry.apply(
                    action.knob, action.value, reason=action.reason,
                    window=sig.window, shards=shards,
                )
            if entry is not None:
                applied.append(entry)
        return applied

    def revert_all(self):
        """Restore every moved knob's static default."""
        return self.registry.revert_all()

    # -- pacing (the thread never changes WHAT a window decides) ----------

    def start(self, period_s: float = 1.0) -> "Controller":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(period_s):
                try:
                    self.step()
                except Exception:
                    log.exception("control step failed; continuing")

        self._thread = threading.Thread(
            target=loop, name="fishnet-control", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, revert: bool = True) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if revert:
            self.registry.revert_all(reason="controller stop")


def standard_actuators(
    service=None, shed_policy=None, mcts_pool=None, scheduler=None,
    az_plane=None,
):
    """The stock actuator set for whatever subsystems are wired.
    Defaults are captured HERE, at bind time — that snapshot is what
    ``revert()`` and the escape hatch restore."""
    from fishnet_tpu_torch.control.actuators import Actuator

    acts = []
    if service is not None:
        acts.append(Actuator(
            name="coalesce_width",
            setter=service.set_coalesce_width,
            lo=1, hi=8, default=None,
            getter=service.coalesce_width,
            shard_scoped=True,
        ))
        acts.append(Actuator(
            name="pipeline_depth",
            setter=service.set_async_depth,
            lo=1, hi=4, default=service.async_depth(),
            getter=service.async_depth,
        ))

        def set_prefetch(value) -> None:
            from fishnet_tpu_torch.search.service import MIN_BATCH_CAPACITY

            if value is None:
                service.set_prefetch(MIN_BATCH_CAPACITY, adaptive=True)
            else:
                service.set_prefetch(int(value), adaptive=False)

        acts.append(Actuator(
            name="prefetch_budget",
            setter=set_prefetch,
            lo=0, hi=512, default=None,
        ))
    if shed_policy is not None:
        acts.append(Actuator(
            name="shed_watermark",
            setter=shed_policy.set_watermarks,
            lo=WATERMARK_FLOOR // 2, hi=4096,
            default=(shed_policy.high_watermark, shed_policy.low_watermark),
            getter=lambda: (
                shed_policy.high_watermark, shed_policy.low_watermark
            ),
        ))
    if mcts_pool is not None:
        acts.append(Actuator(
            name="mcts_leaf_max",
            setter=mcts_pool.set_leaf_width_max,
            lo=1, hi=64,
            default=mcts_pool.leaf_width_max(),
            getter=mcts_pool.leaf_width_max,
        ))
    if scheduler is not None:
        acts.append(Actuator(
            name="tenant_weights",
            setter=scheduler.set_tenant_weights,
            lo=0.25, hi=4.0, default={},
            getter=scheduler.tenant_weights,
        ))
    if az_plane is not None:
        spec_default = az_plane.speculation_budget()

        def set_speculation(value) -> None:
            # None restores the bind-time budget; like prefetch_budget
            # the knob has no getter, so snapshot()/knobs reflect the
            # pinned state (non-None only while a rule holds it).
            az_plane.set_speculation_budget(
                spec_default if value is None else int(value)
            )

        acts.append(Actuator(
            name="speculation_budget",
            setter=set_speculation,
            lo=0, hi=64, default=None,
        ))
    return acts


def build_controller(
    service=None, shed_policy=None, mcts_pool=None, scheduler=None,
    slo_engine=None, policy: Optional[Policy] = None,
    margin: float = 0.10, hold: int = 2, az_plane=None,
) -> Controller:
    """Wire the stock control plane over the given subsystems: a
    collector attached to the stage-observer hook, a registry holding
    :func:`standard_actuators`, and a :class:`Controller` around the
    chosen policy. Call ``shutdown_controller()`` when done."""
    collector = SignalCollector(
        service=service, slo_engine=slo_engine, scheduler=scheduler,
        margin=margin, hold=hold, az_plane=az_plane,
    ).attach()
    registry = ActuatorRegistry()
    registry.register_all(standard_actuators(
        service=service, shed_policy=shed_policy,
        mcts_pool=mcts_pool, scheduler=scheduler, az_plane=az_plane,
    ))
    return Controller(collector, registry, policy=policy)


def shutdown_controller(controller: Controller, revert: bool = True) -> None:
    """Stop pacing, restore defaults (unless told otherwise), detach
    the stage observer, and unhook the log collector."""
    controller.stop(revert=revert)
    controller.collector.detach()
    controller.registry.close()
