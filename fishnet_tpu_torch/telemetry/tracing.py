"""Causal trace contexts for the span flight recorder (Dapper-style).

The port's copy of ``fishnet_tpu/telemetry/tracing.py``: the same ids,
so a batch traced by either package carries the same trace id.

A *trace* is one batch's (or one eval step's) causal tree through the
serving pipeline; a *span* is one recorded stage of it. Contexts are
plain value objects — ``(trace_id, span_id, parent_id)`` — that travel
with the work they describe: across asyncio actors on the batch id,
across the coalescer's thread handoffs ON THE TICKET (thread-locals
would lose the chain at the pack/decode worker boundary), and into the
flight recorder as three additive fields on the flat span record
(``fishnet-spans/2``, doc/observability.md).

Two id disciplines coexist:

* **Batch traces** (server work): the trace id is a *deterministic*
  digest of the batch id (:func:`trace_id_for_batch`), and the root
  span — ``acquire`` — uses ``span_id == trace_id``. Any stage that
  knows the batch id can therefore parent itself into the tree with no
  shared registry or cross-actor plumbing: ``schedule`` and the final
  ``submit`` each derive the same ids independently.
* **Step traces** (one group eval microbatch): a fresh unique trace per
  ``pack`` (:func:`new_trace`); children chain explicitly via
  :meth:`TraceContext.child` and ride the coalesce ticket.

A FUSED dispatch belongs to K step traces at once. Convention
(OpenTelemetry span links): the shared ``dispatch_issue`` /
``dispatch_wait`` / ``coalesce`` span parents into the FIRST ticket's
trace and carries every other ticket's ``(trace_id, span_id)`` in its
``links`` field; a critical-path analyzer re-attaches it to each
linked trace.

Id generation is lock-free: a per-thread counter prefixed with a
process-unique thread ordinal (claimed once per thread lifetime) —
unique within a process, cheap enough for the gated hot path (one
attribute read when telemetry is off; one string format when on).
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from typing import List, Optional, Tuple

__all__ = [
    "TraceContext",
    "new_trace",
    "next_span_id",
    "trace_id_for_batch",
    "batch_root",
    "batch_child",
    "links_for",
]

_local = threading.local()

#: Each thread claims a process-unique ordinal on first use. NOT the OS
#: thread id: idents are recycled after a thread exits, and a recycled
#: ident would restart the per-thread counter into colliding ids.
#: count().__next__ is atomic under the GIL, and it runs once per
#: thread lifetime — the per-span path stays lock-free.
_thread_ordinal = itertools.count(1)


def next_span_id() -> str:
    """A process-unique span id: per-thread counter + thread ordinal."""
    tid = getattr(_local, "tid", None)
    if tid is None:
        tid = _local.tid = next(_thread_ordinal)
    n = getattr(_local, "n", 0) + 1
    _local.n = n
    return f"{tid:x}.{n:x}"


class TraceContext:
    """One span's position in a trace: ``span_id`` under ``parent_id``
    (None = root) inside ``trace_id``. Immutable by convention."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str] = None,
    ) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        """A fresh child context under this span, same trace."""
        return TraceContext(self.trace_id, next_span_id(), self.span_id)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
            f"{self.parent_id!r})"
        )


def new_trace() -> TraceContext:
    """A fresh root context (step traces: the driver's ``pack``)."""
    tid = next_span_id()
    return TraceContext(tid, tid, None)


def trace_id_for_batch(batch_id: str) -> str:
    """Deterministic trace id for a server batch: every stage that
    knows the batch id derives the same tree with no shared state."""
    return hashlib.blake2b(batch_id.encode(), digest_size=8).hexdigest()


def batch_root(batch_id: str) -> TraceContext:
    """The batch trace's root context (the ``acquire`` span):
    ``span_id == trace_id`` so children can parent to it by digest."""
    tid = trace_id_for_batch(batch_id)
    return TraceContext(tid, tid, None)


def batch_child(batch_id: str) -> TraceContext:
    """A child of the batch root, derived from the batch id alone."""
    tid = trace_id_for_batch(batch_id)
    return TraceContext(tid, next_span_id(), tid)


def links_for(contexts: List[TraceContext]) -> List[Tuple[str, str]]:
    """Span links for a shared (fan-in) span: the ``(trace_id,
    span_id)`` of every OTHER owner it also belongs to."""
    return [(c.trace_id, c.span_id) for c in contexts]
