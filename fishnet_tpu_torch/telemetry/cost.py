"""Per-tenant / per-workload cost attribution (the accounting half of
the profiling plane; see telemetry/profiler.py) — the port of
``fishnet_tpu/telemetry/cost.py``, with its arithmetic and its families.

Every device dispatch already knows, per row, which search slot it
serves; the driver knows which tenant and workload family submitted
that slot. This module closes the loop: dispatch walls, wire bytes,
and eval-cache hits are apportioned to ``(tenant, family)`` owners and
exported as monotonic counters —

* ``fishnet_tenant_device_ms_total{tenant}`` — dispatch wall
  apportioned to the tenant whose rows rode the dispatch. Fused
  multi-owner dispatches split the measured wall **by row count**
  (a 3-row ticket in a 48-row fusion owes 1/16 of the wall).
* ``fishnet_tenant_wire_bytes_total{tenant}`` — bytes staged onto the
  wire on the tenant's behalf.
* ``fishnet_tenant_cache_hits_total{tenant}`` — pre-dispatch eval-
  cache hits: work the tenant did NOT pay device time for.
* ``fishnet_workload_device_ms_total{family}`` — same wall, keyed by
  workload family: ``analysis`` (throughput lane), ``best-move``
  (latency lane), ``selfplay`` (AZ-MCTS leaf traffic).
* ``fishnet_cost_device_ms_total`` / ``fishnet_cost_dispatches_total``
  — unlabelled totals, so "attributed == measured" is checkable from
  one scrape (the tests gate the sum within 2%).

Gate discipline: ``enabled()`` is one module-attribute read; when off,
the driver builds no owner table and the dispatch path takes no
timestamp beyond what telemetry already takes. ``enable()`` is called
by ``telemetry.start_exporter`` under ``FISHNET_PROFILE=1`` or directly
by a caller; it registers the collector once a process.

What the walls are, as in the JAX package. The wall of ONE physical
dispatch is measured once and split across its tickets by row count:

* the sync path (``FISHNET_NO_ASYNC=1``, or no async pipeline) records
  inline in ``_DispatchCoalescer._execute``: the wall there is the
  issue time (staging and queueing the launch; on CUDA the launch
  returns before the kernel ends, and no device sync is added);
* the async pipeline (the default) stamps the issue timestamp on the
  tickets and records from the decode worker after materialization, so
  its wall runs from issue to the results on the host;
* a solo dispatch without a coalescer records its issue wall inline on
  the driver.

``dispatches`` (``fishnet_cost_dispatches_total``) counts ONE PER
TICKET, not one per physical dispatch: ``note_tickets`` calls
``note_dispatch`` for each ticket of a fused dispatch, as the JAX
ledger does. The device-ms totals are exact either way.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

from fishnet_tpu_torch.telemetry.registry import (
    REGISTRY,
    MetricFamily,
    Sample,
)

__all__ = [
    "LEDGER",
    "CostLedger",
    "disable",
    "enable",
    "enabled",
    "note_cache_hits",
    "note_dispatch",
    "note_tickets",
    "reset",
]

#: Owner tuple for rows whose slot is unknown (e.g. raced slot retire).
UNKNOWN_OWNER: Tuple[str, str] = ("unknown", "unknown")

#: Tenant label used when the submitter supplied no tenant (single-
#: tenant deployments, direct service.search callers, tests).
DEFAULT_TENANT = "default"


class CostLedger:
    """Thread-safe accumulation of attributed cost. One lock, taken at
    dispatch rate (tens of Hz) for a handful of dict updates — far off
    every hot path (the per-row work happens on the driver only when
    the plane is enabled, and is plain numpy/dict counting)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.tenant_device_ms: Dict[str, float] = {}
        self.tenant_wire_bytes: Dict[str, float] = {}
        self.tenant_cache_hits: Dict[str, float] = {}
        self.family_device_ms: Dict[str, float] = {}
        self.total_device_ms = 0.0
        self.dispatches = 0

    # -- recording --------------------------------------------------------

    def note_dispatch(
        self,
        owners: Optional[Iterable[Tuple[Tuple[str, str], int]]],
        rows: int,
        wire_bytes: int,
        duration_s: float,
    ) -> None:
        """Attribute one physical dispatch.

        ``owners`` is ``[((tenant, family), row_count), ...]`` covering
        the dispatch's rows (None or empty → everything lands on
        :data:`UNKNOWN_OWNER`). The measured wall and wire bytes split
        across owners proportionally to ``row_count``; rounding keeps
        the unlabelled total exact (it accumulates the measured wall
        directly, never the re-summed shares).
        """
        ms = duration_s * 1000.0
        pairs: List[Tuple[Tuple[str, str], int]] = (
            [(o, int(n)) for o, n in owners if n > 0] if owners else []
        )
        covered = sum(n for _, n in pairs)
        short = max(0, int(rows) - covered)
        if short or not pairs:
            pairs.append((UNKNOWN_OWNER, short or max(1, int(rows))))
        denom = sum(n for _, n in pairs) or 1
        with self._lock:
            self.total_device_ms += ms
            self.dispatches += 1
            for (tenant, family), n in pairs:
                tenant = tenant or DEFAULT_TENANT
                share = n / denom
                self.tenant_device_ms[tenant] = (
                    self.tenant_device_ms.get(tenant, 0.0) + ms * share
                )
                self.tenant_wire_bytes[tenant] = (
                    self.tenant_wire_bytes.get(tenant, 0.0)
                    + wire_bytes * share
                )
                self.family_device_ms[family] = (
                    self.family_device_ms.get(family, 0.0) + ms * share
                )

    def note_cache_hits(
        self, owners: Iterable[Tuple[Tuple[str, str], int]]
    ) -> None:
        """Credit pre-dispatch eval-cache hits to their owners."""
        with self._lock:
            for (tenant, _family), n in owners:
                if n <= 0:
                    continue
                tenant = tenant or DEFAULT_TENANT
                self.tenant_cache_hits[tenant] = (
                    self.tenant_cache_hits.get(tenant, 0.0) + n
                )

    # -- reading ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tenant_device_ms": dict(self.tenant_device_ms),
                "tenant_wire_bytes": dict(self.tenant_wire_bytes),
                "tenant_cache_hits": dict(self.tenant_cache_hits),
                "family_device_ms": dict(self.family_device_ms),
                "total_device_ms": self.total_device_ms,
                "dispatches": self.dispatches,
            }

    def collect(self) -> List[MetricFamily]:
        """Registry collector: build the five families straight from
        the ledger (multi-sample families, one sample per label)."""
        snap = self.snapshot()

        def fam(name: str, help_: str, values: Dict[str, float],
                label: str) -> MetricFamily:
            return MetricFamily(
                name=name, type="counter", help=help_,
                samples=[
                    Sample(name=name, value=v, labels={label: k})
                    for k, v in sorted(values.items())
                ],
            )

        return [
            fam(
                "fishnet_tenant_device_ms_total",
                "Device compute wall (ms) attributed to the tenant "
                "whose rows rode each dispatch; fused dispatches "
                "split by row count.",
                snap["tenant_device_ms"], "tenant",
            ),
            fam(
                "fishnet_tenant_wire_bytes_total",
                "Wire bytes staged on the tenant's behalf.",
                snap["tenant_wire_bytes"], "tenant",
            ),
            fam(
                "fishnet_tenant_cache_hits_total",
                "Pre-dispatch eval-cache hits credited to the tenant "
                "(device work avoided).",
                snap["tenant_cache_hits"], "tenant",
            ),
            fam(
                "fishnet_workload_device_ms_total",
                "Device compute wall (ms) by workload family: "
                "analysis / best-move / selfplay.",
                snap["family_device_ms"], "family",
            ),
            MetricFamily(
                name="fishnet_cost_device_ms_total", type="counter",
                help="Total measured dispatch wall (ms); the "
                     "attributed per-tenant series sum to this.",
                samples=[Sample(
                    name="fishnet_cost_device_ms_total",
                    value=snap["total_device_ms"], labels={},
                )],
            ),
            MetricFamily(
                name="fishnet_cost_dispatches_total", type="counter",
                help="Physical device dispatches attributed.",
                samples=[Sample(
                    name="fishnet_cost_dispatches_total",
                    value=float(snap["dispatches"]), labels={},
                )],
            ),
        ]


#: Process-wide ledger (mirrors the process-wide eval cache / span
#: recorder: cost is a per-process notion, not per-service).
LEDGER = CostLedger()

#: The gate — one module-attribute read on every hot-path check.
_enabled = False
_collector_registered = False


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm cost attribution and (once a process) register the exporter
    collector."""
    global _enabled, _collector_registered
    _enabled = True
    if not _collector_registered:
        REGISTRY.register_collector(
            lambda: LEDGER.collect(), name="cost-attribution"
        )
        _collector_registered = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Zero the ledger (tests; counters are per-process otherwise)."""
    global LEDGER
    with LEDGER._lock:
        LEDGER.tenant_device_ms.clear()
        LEDGER.tenant_wire_bytes.clear()
        LEDGER.tenant_cache_hits.clear()
        LEDGER.family_device_ms.clear()
        LEDGER.total_device_ms = 0.0
        LEDGER.dispatches = 0


# -- module-level conveniences (what the dispatch path calls) -----------------


def note_dispatch(owners, rows: int, wire_bytes: int,
                  duration_s: float) -> None:
    LEDGER.note_dispatch(owners, rows, wire_bytes, duration_s)


def note_cache_hits(owners) -> None:
    LEDGER.note_cache_hits(owners)


def _acct_wire_bytes(acct) -> int:
    """Wire bytes out of a dispatch accounting record: the NNUE path
    returns ``(size, feature_bytes, material_bytes)`` tuples, the AZ
    plane dict accts carrying ``wire_bytes``."""
    if isinstance(acct, tuple) and len(acct) >= 3:
        return int(acct[1]) + int(acct[2])
    if isinstance(acct, dict):
        return int(acct.get("wire_bytes", 0))
    return 0


def note_tickets(tickets, duration_s: float) -> None:
    """Attribute one physical (possibly fused) dispatch from its
    coalescer tickets. The wall splits across tickets by row count;
    each ticket's share splits across its ``owners`` table (stamped by
    the driver at submit when the plane is on)."""
    total_rows = sum(int(tk.rows) for tk in tickets) or 1
    for tk in tickets:
        share = int(tk.rows) / total_rows
        LEDGER.note_dispatch(
            getattr(tk, "owners", None),
            int(tk.n),
            _acct_wire_bytes(tk.acct),
            duration_s * share,
        )
