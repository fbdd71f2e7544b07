"""Exactly-once batch accounting: the ledger that proves no acquired
batch is lost or double-submitted across faults, requeues, degradations,
and restarts.

The port's copy of ``fishnet_tpu/resilience/accounting.py``.

Lifecycle tracked per batch (work id)::

    acquired ──> scheduled ──> stepped ──> SUBMITTED      (the good path)
        │            │            │
        │            │            ├──> requeued (bounded generations,
        │            │            │    back to stepped)
        │            │            └──> FLUSHED + SUBMITTED (deadline
        │            │                 budget: partial analysis)
        │            ├──> INVALID  (trust-boundary reject; the server
        │            │    reassigns by timeout — accounted, not lost)
        │            └──> ABANDONED (requeue cap, shutdown abort,
        │                 submit-retry exhaustion; server reassigns)
        └──> ABANDONED (acquire callback dropped)

Terminal states are SUBMITTED / ABANDONED / INVALID. A batch with no
terminal state at report time is **lost** — a bug. A batch whose
confirmed-submit count exceeds 1 is **duplicated** — a bug. ``submitted``
is recorded by the API actor on *server confirmation* (2xx), not on
enqueue, so a submission dropped on the wire is visible.

Like the fault plane, the ledger is **off by default**: call sites gate
on :func:`enabled` or :func:`get` (one module-attribute read). Tests and
fault drills install one; production serving pays nothing.

Recording sites of the port: the API actor (net/api.py: acquired,
submitted on the server's 2xx, abandoned on a dropped callback, a
fenced 404, a rejected move, spent submit retries and submissions
parked behind an open breaker at shutdown) and the queue
(sched/queue.py: scheduled, stepped, requeued, flushed, invalid,
abandoned at the requeue cap, the deadline, shutdown, and for an
acquire that lands after shutdown).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

TERMINAL_STATES = ("submitted", "abandoned", "invalid")


class LedgerViolation(AssertionError):
    """The exactly-once invariant failed (lost or duplicated batches)."""


@dataclass
class BatchRecord:
    batch_id: str
    acquired_at: float
    acquires: int = 0
    scheduled: bool = False
    stepped: bool = False
    requeues: int = 0
    submits: int = 0  # server-confirmed submissions
    flushed: bool = False
    terminal: Optional[str] = None
    reason: Optional[str] = None
    events: List[str] = field(default_factory=list)


class BatchLedger:
    """Thread-safe batch lifecycle ledger (event loop + driver threads +
    the API actor all record into it; rates are per-batch, not per-eval,
    so one lock is fine)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: Dict[str, BatchRecord] = {}

    # -- recording --------------------------------------------------------

    def _rec(self, batch_id: str) -> BatchRecord:
        rec = self._records.get(batch_id)
        if rec is None:
            rec = BatchRecord(batch_id=batch_id, acquired_at=time.monotonic())
            self._records[batch_id] = rec
        return rec

    def record_acquired(self, batch_id: str) -> None:
        with self._lock:
            rec = self._rec(batch_id)
            if rec.terminal == "abandoned":
                # The server reassigned an abandoned batch to us again:
                # a fresh lifecycle for the same id. Confirmed submits
                # stay cumulative so duplicates remain detectable.
                rec.terminal = None
                rec.reason = None
                rec.scheduled = rec.stepped = False
            rec.acquires += 1
            rec.events.append("acquired")

    def record_scheduled(self, batch_id: str) -> None:
        with self._lock:
            rec = self._rec(batch_id)
            rec.scheduled = True
            rec.events.append("scheduled")

    def record_stepped(self, batch_id: str) -> None:
        with self._lock:
            rec = self._records.get(batch_id)
            if rec is not None and not rec.stepped:
                rec.stepped = True
                rec.events.append("stepped")

    def record_requeued(self, batch_id: str, generation: int) -> None:
        with self._lock:
            rec = self._rec(batch_id)
            rec.requeues = max(rec.requeues, generation)
            rec.events.append(f"requeued:{generation}")

    def record_flushed(self, batch_id: str) -> None:
        with self._lock:
            rec = self._rec(batch_id)
            rec.flushed = True
            rec.events.append("flushed")

    def record_invalid(self, batch_id: str, reason: str = "") -> None:
        with self._lock:
            rec = self._rec(batch_id)
            rec.terminal = "invalid"
            rec.reason = reason or rec.reason
            rec.events.append("invalid")

    def record_abandoned(self, batch_id: str, reason: str = "") -> None:
        with self._lock:
            rec = self._rec(batch_id)
            if rec.terminal != "submitted":
                rec.terminal = "abandoned"
                rec.reason = reason or rec.reason
            rec.events.append(f"abandoned:{reason}")

    def record_submitted(self, batch_id: str) -> None:
        """A SERVER-CONFIRMED submission (2xx on the final analysis or
        the move). Called by the API actor, not at enqueue time."""
        with self._lock:
            rec = self._rec(batch_id)
            rec.submits += 1
            rec.terminal = "submitted"
            rec.events.append("submitted")

    # -- reporting --------------------------------------------------------

    def report(self) -> Dict[str, object]:
        with self._lock:
            records = list(self._records.values())
        lost = sorted(r.batch_id for r in records if r.terminal is None)
        duplicated = sorted(r.batch_id for r in records if r.submits > 1)
        return {
            "batches": len(records),
            "submitted": sum(1 for r in records if r.terminal == "submitted"),
            "abandoned": sum(1 for r in records if r.terminal == "abandoned"),
            "invalid": sum(1 for r in records if r.terminal == "invalid"),
            "flushed": sum(1 for r in records if r.flushed),
            "requeues": sum(r.requeues for r in records),
            "lost": lost,
            "duplicated": duplicated,
        }

    def record(self, batch_id: str) -> Optional[BatchRecord]:
        with self._lock:
            return self._records.get(batch_id)

    def assert_clean(self) -> Dict[str, object]:
        """Raise :class:`LedgerViolation` unless 0 lost and 0 duplicated;
        returns the report."""
        rep = self.report()
        if rep["lost"] or rep["duplicated"]:
            raise LedgerViolation(
                f"ledger not clean: lost={rep['lost']} "
                f"duplicated={rep['duplicated']}"
            )
        return rep


#: Installed ledger; None = accounting off (the production state).
_LEDGER: Optional[BatchLedger] = None


def enabled() -> bool:
    return _LEDGER is not None


def get() -> Optional[BatchLedger]:
    return _LEDGER


def install(ledger: Optional[BatchLedger] = None) -> BatchLedger:
    global _LEDGER
    _LEDGER = ledger if ledger is not None else BatchLedger()
    return _LEDGER


def clear() -> None:
    global _LEDGER
    _LEDGER = None
