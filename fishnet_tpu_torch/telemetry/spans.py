"""Span flight recorder: monotonic-clock spans around the pipeline
stages, kept in fixed-size per-thread ring buffers, dumped as JSONL for
crash forensics.

The port's copy of ``fishnet_tpu/telemetry/spans.py``: the same stage
names, record shape, dump and journal formats and dump locations, so a
consumer of the JAX worker's spans reads the port's.

The six pipeline stage names are a stable contract
(doc/observability.md):

* ``acquire``     — server round-trip acquiring work (net/api.py)
* ``schedule``    — validate + expand an acquired batch (sched/queue.py)
* ``pack``        — native fiber step + batch emission (fc_pool_step)
* ``device_step`` — device dispatch of one eval microbatch (on the GPU
  the host-side issue: a launch is asynchronous)
* ``wire_decode`` — blocking on the dispatched values (wire + decode)
* ``postprocess`` — provide values to fibers + harvest finished slots

plus *event* stages outside the pipeline (each appears only when the
named machinery actually runs):

* ``recover``     — a supervised service rebuild: respawn and/or
  degradation-ladder step (resilience/supervisor.py)
* ``coalesce``    — a FUSED device dispatch: several pipeline groups'
  microbatches shipped as one segmented eval (search/coalesce.py
  _DispatchCoalescer; fields: width, groups, n)
* ``dispatch_issue`` — async pack worker staged + issued one device
  dispatch (search/coalesce.py _AsyncDispatchPipeline; fields: seq,
  width, n). The span covers host-side pack through the launch.
* ``dispatch_wait``  — async decode worker blocked materializing that
  dispatch's values (fields: seq, width). [dispatch_issue.t,
  dispatch_wait.t + dur] brackets one dispatch's in-flight interval.
* ``mcts_collect`` — one MctsPool step's tree-side leaf collection:
  every live PUCT search's selection walks, run before the pooled
  microbatch rides the shared AZ dispatch plane (search/mcts.py;
  fields: n, trees, collisions)
* ``queue_wait``  — one position's dwell in the scheduler's incoming
  queue, from batch enqueue to worker pull (sched/queue.py; fields:
  batch, position_id)
* ``submit``      — the final analysis submission round-trip for a
  completed batch (net/api.py; fields: batch)
* ``admit``       — the multi-tenant front end's admission decision
  (sched/frontend.py; fields: batch, tenant, lane, decision, positions)
* ``cache_probe`` — the pre-dispatch eval-cache probe (search/service.py)
* ``drain``       — the process entered graceful drain: stop acquiring,
  flush in-flight, abort the rest upstream (resilience/drain.py;
  fields: reason, deadline_s)
* ``control``     — the JAX package's control plane (not ported; the
  name stays in the contract)

Recording is OFF by default: every instrumentation site is gated on
``fishnet_tpu_torch.telemetry.enabled()``, so with telemetry disabled
the device-dispatch critical path pays one attribute read per step and
the rings stay empty. When enabled, ``record()`` is one
``time.monotonic()`` call plus a slot store into a preallocated
per-thread ring — no lock, single writer per ring. (One site records
without the gate, as in the JAX package: the split plane's
``rpc_wait``, rpc/client.py.)

Causal tracing (``fishnet-spans/2``, additive): ``record()`` optionally
takes a :class:`fishnet_tpu_torch.telemetry.tracing.TraceContext`,
adding ``trace_id``/``span_id``/``parent_id`` fields to the flat
record, plus ``links`` — a list of ``(trace_id, span_id)`` pairs naming
the OTHER owners of a shared fan-in span (one fused dispatch serving K
segment traces). Consumers that only know ``fishnet-spans/1`` still
parse every line: the flat shape is unchanged, the fields are extra.

Dump location: ``FISHNET_SPANS_FILE`` names the exact file when set;
otherwise dumps land as ``fishnet-spans-<pid>.jsonl`` inside
``FISHNET_SPANS_DIR`` (``--spans-dir``), defaulting to a
``fishnet-spans/`` directory under the system tempdir — never the
process CWD. One header object per dump then one object per span.
Dumps fire on SIGUSR2 (when installed via :func:`install_signal_dump`),
on ``SearchService`` driver-crash teardown (``_fail_all``), on clean
service close and on a drained ``run``'s exit. Rings are not cleared
by a dump, so successive dumps overlap — dedupe on the ``seq`` field
if that matters to a consumer.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, List, Optional

#: The pipeline stage-name contract, in pipeline order. (A healthy
#: serve records exactly these; see EVENT_STAGES for the rest.)
STAGES = (
    "acquire", "schedule", "pack", "device_step", "wire_decode", "postprocess",
)

#: Event stages: recorded only when the named machinery runs.
EVENT_STAGES = (
    "recover", "coalesce", "dispatch_issue", "dispatch_wait",
    "mcts_collect", "queue_wait", "submit", "admit", "cache_probe",
    "drain", "control",
)

#: Span-dump header format. /2 added the additive causal-trace fields
#: (trace_id/span_id/parent_id/links) — /1 consumers parse it unchanged.
FORMAT = "fishnet-spans/2"

DEFAULT_CAPACITY = 4096  # spans kept per thread

#: Journal header format (one header per process incarnation, then one
#: span object per line — only batch-trace spans are journaled).
JOURNAL_FORMAT = "fishnet-spans-journal/1"

#: Batch trace ids (blake2b digest, tracing.trace_id_for_batch): the
#: globally-joinable traces worth journaling. Step-trace ids
#: (``<tid>.<n>``) never match — they are process-local and orders of
#: magnitude hotter, so they stay ring-only.
_GLOBAL_TRACE = re.compile(r"^[0-9a-f]{16}$")

#: Stage-duration observer (telemetry/profiler.py installs one feeding
#: ``fishnet_stage_duration_seconds{stage}``). None by default, so a
#: ``record()`` call pays exactly one module-attribute read for it —
#: the same gate discipline as ``telemetry.enabled()``; with the
#: profiling plane off there is zero extra hot-path work.
STAGE_OBSERVER = None


def set_stage_observer(fn) -> None:
    """Install (or clear, with None) the per-span stage-duration
    observer: ``fn(stage, duration_seconds)`` runs inside ``record()``
    on the recording thread, so it must be lock-free on its own hot
    path (the profiler's histogram uses per-thread cells)."""
    global STAGE_OBSERVER
    STAGE_OBSERVER = fn


class _Ring:
    """Single-writer fixed ring. The writer thread owns all mutation;
    readers (dump) take a racy snapshot, which can at worst see one
    half-updated slot — acceptable for forensics, free for the writer."""

    __slots__ = ("items", "n", "thread")

    def __init__(self, capacity: int, thread: str) -> None:
        self.items: List[Optional[tuple]] = [None] * capacity
        self.n = 0
        self.thread = thread

    def append(self, item: tuple) -> None:
        self.items[self.n % len(self.items)] = item
        self.n += 1

    def snapshot(self) -> List[tuple]:
        n = self.n
        cap = len(self.items)
        if n <= cap:
            return [s for s in self.items[:n] if s is not None]
        start = n % cap
        return [
            s for s in self.items[start:] + self.items[:start] if s is not None
        ]


class SpanRecorder:
    """Per-thread span rings plus the JSONL dump machinery."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._capacity = capacity
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._lock = threading.Lock()  # ring creation + dump serialization
        self._seq = 0
        self._journal = None
        self._journal_lock = threading.Lock()
        # Monotonic->epoch anchor so dump consumers can place spans on a
        # wall clock.
        self._epoch_offset = time.time() - time.monotonic()

    @property
    def epoch_offset(self) -> float:
        """Monotonic->epoch anchor (``t + epoch_offset`` is wall time).
        The fleet aggregator rebases every process's spans onto this
        common clock before stitching cross-process traces."""
        return self._epoch_offset

    # -- hot path ---------------------------------------------------------

    def record(
        self,
        stage: str,
        started: float,
        trace=None,
        links=None,
        **fields,
    ) -> None:
        """Record a span that began at monotonic time ``started`` and
        ends now. Call sites gate on ``telemetry.enabled()``.

        ``trace`` (a tracing.TraceContext) adds the causal-tree fields;
        ``links`` adds the shared-span fan-in list — both additive on
        the flat record (fishnet-spans/2)."""
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self._capacity, threading.current_thread().name)
            with self._lock:
                self._rings.append(ring)
            self._local.ring = ring
        if trace is not None:
            fields["trace_id"] = trace.trace_id
            fields["span_id"] = trace.span_id
            if trace.parent_id is not None:
                fields["parent_id"] = trace.parent_id
        if links:
            fields["links"] = [list(lk) for lk in links]
        dur = time.monotonic() - started
        ring.append((stage, started, dur, fields))
        obs = STAGE_OBSERVER
        if obs is not None:
            obs(stage, dur)
        if (
            self._journal is not None
            and trace is not None
            and _GLOBAL_TRACE.match(trace.trace_id)
        ):
            self._journal_write(stage, started, dur, ring.thread, fields)

    # -- journaling -------------------------------------------------------

    def journal_to(self, path: str) -> None:
        """Start (or restart) the batch-span journal: every subsequent
        batch-trace span — acquire/schedule/queue_wait/submit, the
        low-rate per-work-unit lifecycle — is appended to ``path`` and
        flushed line-by-line, so a SIGKILLed process's last spans
        survive for the fleet stitcher even when they were recorded
        after the aggregator's final scrape. Step traces (the kHz
        device-dispatch path) are never journaled. Appends one header
        line identifying this incarnation (pid + clock anchor); a
        restarted process appends a fresh header to the same file."""
        header = {
            "format": JOURNAL_FORMAT,
            "pid": os.getpid(),
            "started_at": time.time(),
            "monotonic_to_epoch": round(self._epoch_offset, 6),
        }
        with self._journal_lock:
            self._journal_stop_locked()
            try:
                parent = os.path.dirname(path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                fp = open(path, "a")
                fp.write(json.dumps(header) + "\n")
                fp.flush()
            except OSError:
                return
            self._journal = fp

    def journal_close(self) -> None:
        with self._journal_lock:
            self._journal_stop_locked()

    def _journal_stop_locked(self) -> None:
        if self._journal is not None:
            try:
                self._journal.close()
            except OSError:
                pass
            self._journal = None

    def _journal_write(
        self, stage: str, started: float, dur: float, thread: str, fields: dict
    ) -> None:
        # EXACTLY the spans() record shape (same rounding), so the
        # aggregator's per-incarnation dedup collapses a span seen via
        # both the /spans scrape and the journal into one.
        rec = {
            "stage": stage,
            "t": round(started, 6),
            "dur_ms": round(dur * 1e3, 3),
            "thread": thread,
        }
        if fields:
            rec.update(fields)
        with self._journal_lock:
            if self._journal is None:
                return
            try:
                self._journal.write(json.dumps(rec) + "\n")
                self._journal.flush()
            except (OSError, ValueError):
                self._journal = None

    # -- dumping ----------------------------------------------------------

    def spans(self) -> List[dict]:
        """All recorded spans, oldest first, as dump-shaped dicts."""
        with self._lock:
            rings = list(self._rings)
        out = []
        for ring in rings:
            for stage, started, dur, fields in ring.snapshot():
                rec = {
                    "stage": stage,
                    "t": round(started, 6),
                    "dur_ms": round(dur * 1e3, 3),
                    "thread": ring.thread,
                }
                if fields:
                    rec.update(fields)
                out.append(rec)
        out.sort(key=lambda r: r["t"])
        return out

    def stages_seen(self) -> set:
        return {r["stage"] for r in self.spans()}

    def default_path(self) -> str:
        """Where dumps land: ``FISHNET_SPANS_FILE`` wins outright;
        otherwise ``fishnet-spans-<pid>.jsonl`` inside
        ``FISHNET_SPANS_DIR`` or, unset, a ``fishnet-spans/`` directory
        under the system tempdir — never the process CWD (nine stray
        root dumps taught that lesson)."""
        explicit = os.environ.get("FISHNET_SPANS_FILE")
        if explicit:
            return explicit
        import tempfile

        base = os.environ.get("FISHNET_SPANS_DIR") or os.path.join(
            tempfile.gettempdir(), "fishnet-spans"
        )
        return os.path.join(base, f"fishnet-spans-{os.getpid()}.jsonl")

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Append one header line + all spans (JSONL) to ``path``;
        returns the path written. Never raises on I/O problems — the
        dump is a forensic aid, not a liveness dependency."""
        path = path or self.default_path()
        spans = self.spans()
        with self._lock:
            self._seq += 1
            seq = self._seq
        header = {
            "format": FORMAT,
            "seq": seq,
            "reason": reason,
            "pid": os.getpid(),
            "dumped_at": time.time(),
            "monotonic_to_epoch": round(self._epoch_offset, 6),
            "spans": len(spans),
        }
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "a") as fp:
                fp.write(json.dumps(header) + "\n")
                for rec in spans:
                    fp.write(json.dumps(rec) + "\n")
        except OSError:
            pass
        return path


#: Process-wide recorder (one flight recorder per process, like the
#: registry: every subsystem's spans land in the same dump).
RECORDER = SpanRecorder()

_signal_installed = False


def install_signal_dump(path: Optional[str] = None) -> bool:
    """Install the SIGUSR2 -> dump handler (main thread only; no-op on
    platforms without SIGUSR2, e.g. Windows). Returns True if armed."""
    global _signal_installed
    import signal

    if not hasattr(signal, "SIGUSR2"):
        return False
    if _signal_installed:
        return True

    def _dump(signum, frame):  # pragma: no cover - exercised via os.kill
        RECORDER.dump(path, reason="SIGUSR2")

    try:
        signal.signal(signal.SIGUSR2, _dump)
    except (ValueError, OSError):
        # Not the main thread, or the platform refused: stay unarmed.
        return False
    _signal_installed = True
    return True
