"""Declarative SLOs evaluated as multi-window burn rates over metric
family snapshots — the port of ``fishnet_tpu/telemetry/slo.py``, a
library: its evaluations equal the JAX engine's on the same snapshots.

An SLO here is "fraction of good events ≥ objective" (e.g. 99% of move
submissions complete under the latency threshold). Following the SRE
workbook's error-budget formulation, the engine does not alert on raw
percentiles; it tracks the **burn rate**

    burn(w) = (bad_events / total_events over window w) / (1 - objective)

— burn 1.0 means the error budget is being consumed exactly at the
sustainable rate; burn 10 means ten times too fast. Evaluating the SAME
objective over several windows at once (default 1 min and 5 min) is
what makes the signal actionable: a short-window spike with a calm long
window is a blip; both windows burning > 1 is a page. Status per SLO:

* ``ok``       — no window burning
* ``burning``  — some window's burn rate exceeds 1
* ``breach``   — EVERY window is burning (fast + slow agree)

Good/total counts come from cumulative counter and histogram families
— the engine snapshots them each poll (:meth:`SLOEngine.observe`) and differences snapshots at evaluation time, so restarts
that reset a counter are clamped to zero rather than read as negative
traffic. Latency SLOs count "good" straight from histogram buckets:
the smallest upper bound ≥ the threshold (thresholds therefore snap to
the instrument's bucket grid — 2s snaps to the 2.5s bound of
DEFAULT_TIME_BUCKETS; the evaluation records the snapped bound).

Read three ways: :meth:`SLOEngine.evaluate` (the full evaluation),
:meth:`SLOEngine.burn_snapshot` (one observe + evaluate of this
process's registry, for in-process consumers such as a control plane),
and :meth:`SLOEngine.families` (``fishnet_slo_burn_rate{slo,window}`` /
``fishnet_slo_status{slo}`` for an aggregator's own ``/metrics``). In
the JAX package the fleet aggregator and the control plane call it;
the port's own callers come with those modules.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple

from fishnet_tpu_torch.telemetry.registry import MetricFamily, Sample

#: Multi-window defaults (seconds). Short first; console shows both.
DEFAULT_WINDOWS: Tuple[float, ...] = (60.0, 300.0)


def _labels_match(labels: Mapping[str, str], want: Mapping[str, str]) -> bool:
    """Subset match: every wanted label present with the wanted value.
    Extra labels on the sample (``proc`` from federation, shard labels)
    are ignored — selectors written against single-process series apply
    unchanged to the federated ones."""
    return all(labels.get(k) == v for k, v in want.items())


@dataclass(frozen=True)
class Selector:
    """Sum of one family's samples matching a label subset.

    ``suffix`` picks the sample name within the family: ``""`` for the
    base samples (counters/gauges), ``"_count"``/``"_bucket"`` for
    histogram components."""

    family: str
    labels: Mapping[str, str] = field(default_factory=dict)
    suffix: str = ""

    def value(self, families: Mapping[str, MetricFamily]) -> float:
        fam = families.get(self.family)
        if fam is None:
            return 0.0
        name = self.family + self.suffix
        return sum(
            s.value for s in fam.samples
            if s.name == name and _labels_match(s.labels, self.labels)
        )


def _bucket_good(
    fam: Optional[MetricFamily],
    family: str,
    labels: Mapping[str, str],
    threshold: float,
) -> Tuple[float, Optional[float]]:
    """(good_count, snapped_bound): cumulative observations at or under
    the smallest histogram bound >= threshold, summed across matching
    series (each series keeps its own grid — mixed grids snap
    per-series)."""
    if fam is None:
        return 0.0, None
    series: Dict[Tuple[Tuple[str, str], ...], List[Tuple[float, float]]] = {}
    for s in fam.samples:
        if s.name != family + "_bucket":
            continue
        le = s.labels.get("le")
        if le is None or not _labels_match(s.labels, labels):
            continue
        key = tuple(sorted(
            (k, v) for k, v in s.labels.items() if k != "le"
        ))
        series.setdefault(key, []).append((float(le), s.value))
    good = 0.0
    snapped: Optional[float] = None
    for buckets in series.values():
        eligible = [b for b in buckets if b[0] >= threshold]
        if not eligible:
            continue
        bound, value = min(eligible, key=lambda b: b[0])
        good += value
        if math.isfinite(bound):
            snapped = bound if snapped is None else max(snapped, bound)
    return good, snapped


@dataclass(frozen=True)
class SLO:
    """One declarative objective. Exactly one of ``bad`` or
    ``threshold_s`` is set:

    * ratio form — ``bad``/``total`` selectors; good = total - bad;
    * latency form — ``total`` names a histogram family (selector
      labels apply), ``threshold_s`` is the good/bad boundary; good
      comes from the bucket at or above the threshold.
    """

    name: str
    description: str
    objective: float  # target good fraction, e.g. 0.99
    total: Selector
    bad: Optional[Selector] = None
    threshold_s: Optional[float] = None

    def good_total(
        self, families: Mapping[str, MetricFamily]
    ) -> Tuple[float, float, Optional[float]]:
        """(cumulative_good, cumulative_total, snapped_bound_or_None)
        from one families snapshot."""
        if self.threshold_s is not None:
            count = Selector(
                self.total.family, self.total.labels, "_count"
            ).value(families)
            good, snapped = _bucket_good(
                families.get(self.total.family), self.total.family,
                self.total.labels, self.threshold_s,
            )
            return good, count, snapped
        total = self.total.value(families)
        bad = self.bad.value(families) if self.bad is not None else 0.0
        return max(0.0, total - bad), total, None


def default_slos() -> List[SLO]:
    """The fleet's shipped objectives (doc/observability.md "Fleet
    SLOs" documents each). All are client-side series present on every
    worker's exporter, so they federate with no extra wiring."""
    return [
        SLO(
            name="move_latency",
            description="move submissions complete within ~2s (p99)",
            objective=0.99,
            total=Selector(
                "fishnet_api_request_seconds",
                {"endpoint": "submit_move"},
            ),
            threshold_s=2.0,
        ),
        SLO(
            name="analysis_ttfa",
            description="analysis submissions within ~2.5s (p95)",
            objective=0.95,
            total=Selector(
                "fishnet_api_request_seconds",
                {"endpoint": "submit_analysis"},
            ),
            threshold_s=2.5,
        ),
        SLO(
            name="api_success",
            description="API requests that do not error",
            objective=0.99,
            total=Selector("fishnet_api_requests_total"),
            bad=Selector("fishnet_api_requests_total", {"outcome": "error"}),
        ),
        SLO(
            name="shed_budget",
            description="admitted work units (shedding inside budget)",
            objective=0.90,
            total=Selector("fishnet_admission_total"),
            bad=Selector("fishnet_admission_total", {"decision": "shed"}),
        ),
        SLO(
            name="ledger_cleanliness",
            description="submissions durably recorded, never dropped",
            objective=0.999,
            total=Selector("fishnet_api_requests_total", {"outcome": "ok"}),
            bad=Selector("fishnet_api_submit_dropped_total"),
        ),
    ]


class SLOEngine:
    """Snapshots good/total counts per SLO each observe() and turns
    snapshot deltas into multi-window burn rates on evaluate().

    Single-threaded by contract: the fleet aggregator calls both from
    its poll loop (and from request handlers under the aggregator's
    lock). History is trimmed to the longest window plus slack, so
    memory is bounded by poll rate, not uptime."""

    def __init__(
        self,
        slos: Optional[Iterable[SLO]] = None,
        windows: Tuple[float, ...] = DEFAULT_WINDOWS,
    ) -> None:
        if not windows:
            raise ValueError("SLOEngine needs at least one window")
        self.slos = list(default_slos() if slos is None else slos)
        self.windows = tuple(sorted(windows))
        self._history: Deque[
            Tuple[float, Dict[str, Tuple[float, float]]]
        ] = deque()
        self._snapped: Dict[str, Optional[float]] = {}

    def observe(
        self,
        families: Mapping[str, MetricFamily],
        now: Optional[float] = None,
    ) -> None:
        """Record one snapshot of every SLO's cumulative good/total."""
        now = time.time() if now is None else now
        row: Dict[str, Tuple[float, float]] = {}
        for slo in self.slos:
            good, total, snapped = slo.good_total(families)
            row[slo.name] = (good, total)
            if snapped is not None:
                self._snapped[slo.name] = snapped
        self._history.append((now, row))
        horizon = now - self.windows[-1] * 1.5 - 10.0
        while len(self._history) > 2 and self._history[1][0] < horizon:
            self._history.popleft()

    def _delta(
        self, slo_name: str, window: float, now: float
    ) -> Tuple[float, float]:
        """(Δbad, Δtotal) over the trailing window: newest snapshot
        minus the newest snapshot at or before the window start (the
        oldest held, when history is still shorter than the window).
        Counter resets (a restarted aggregator feeding a fresh engine
        doesn't hit this; a reset FEED series can) clamp to zero."""
        if not self._history:
            return 0.0, 0.0
        cutoff = now - window
        base = self._history[0][1]
        for t, row in self._history:
            if t <= cutoff:
                base = row
            else:
                break
        latest = self._history[-1][1]
        g0, t0 = base.get(slo_name, (0.0, 0.0))
        g1, t1 = latest.get(slo_name, (0.0, 0.0))
        d_total = max(0.0, t1 - t0)
        d_good = max(0.0, g1 - g0)
        return max(0.0, d_total - d_good), d_total

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Burn rates for every SLO over every window. No traffic in a
        window means burn 0 for it (nothing burned the budget)."""
        now = (
            self._history[-1][0] if self._history else time.time()
        ) if now is None else now
        out = []
        for slo in self.slos:
            budget = 1.0 - slo.objective
            burns: Dict[str, float] = {}
            burning = []
            for w in self.windows:
                bad, total = self._delta(slo.name, w, now)
                if total <= 0.0 or budget <= 0.0:
                    burn = 0.0
                else:
                    burn = (bad / total) / budget
                burns[f"{int(w)}s"] = round(burn, 4)
                burning.append(burn > 1.0)
            status = (
                "breach" if all(burning)
                else "burning" if any(burning)
                else "ok"
            )
            entry = {
                "slo": slo.name,
                "description": slo.description,
                "objective": slo.objective,
                "windows": burns,
                "status": status,
            }
            if slo.threshold_s is not None:
                entry["threshold_s"] = slo.threshold_s
                if self._snapped.get(slo.name) is not None:
                    entry["snapped_bound_s"] = self._snapped[slo.name]
            out.append(entry)
        return out

    def burn_snapshot(
        self,
        families: Optional[Mapping[str, MetricFamily]] = None,
        now: Optional[float] = None,
    ) -> Dict[str, dict]:
        """Programmatic burn view for IN-PROCESS consumers (the control
        plane's SignalCollector) — one observe + evaluate, returned as
        ``{slo_name: evaluate() entry}``, so nothing ever scrapes its
        own process over HTTP to learn its burn state.

        ``families`` defaults to the local process registry's live
        collect(); pass an explicit mapping when feeding federated
        families (the fleet aggregator's per-proc engines do)."""
        if families is None:
            from fishnet_tpu_torch.telemetry.registry import REGISTRY

            families = {fam.name: fam for fam in REGISTRY.collect()}
        self.observe(families, now)
        return {entry["slo"]: entry for entry in self.evaluate(now)}

    def families(self, now: Optional[float] = None) -> List[MetricFamily]:
        """``fishnet_slo_burn_rate{slo,window}`` +
        ``fishnet_slo_status{slo}`` (0 ok / 1 burning / 2 breach) for
        the aggregator's own /metrics exposition."""
        rank = {"ok": 0.0, "burning": 1.0, "breach": 2.0}
        burn = MetricFamily(
            name="fishnet_slo_burn_rate",
            type="gauge",
            help="Error-budget burn rate per SLO and trailing window "
                 "(1.0 = burning exactly at the sustainable rate).",
        )
        status = MetricFamily(
            name="fishnet_slo_status",
            type="gauge",
            help="SLO status: 0 ok, 1 burning (some window), 2 breach "
                 "(every window burning).",
        )
        for entry in self.evaluate(now):
            for window, value in entry["windows"].items():
                burn.samples.append(Sample(
                    name="fishnet_slo_burn_rate",
                    value=value,
                    labels={"slo": entry["slo"], "window": window},
                ))
            status.samples.append(Sample(
                name="fishnet_slo_status",
                value=rank[entry["status"]],
                labels={"slo": entry["slo"]},
            ))
        return [burn, status]
