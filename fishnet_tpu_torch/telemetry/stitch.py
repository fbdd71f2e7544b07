"""Cross-process trace stitching: join every process's span dumps into
fleet traces — the port of ``fishnet_tpu/telemetry/stitch.py``, pure
Python over ``fishnet-spans/2`` dumps and journals.

Batch trace ids are *deterministic* (blake2b of the batch id,
telemetry/tracing.py), so when a work unit is handed to process A,
A is SIGKILLed, and the server's reassignment sweep re-hands the unit
to process B, both processes independently record spans under the SAME
trace id. This module merges the per-process span dumps the fleet
aggregator scrapes into one coherent span set:

* **Actors.** Each process *incarnation* (one pid of one supervised
  proc — a restart is a new incarnation) is an actor. Span ids are only
  unique within a process, so every ``span_id``/``parent_id``/link is
  namespaced ``<actor>/<id>``; batch trace ids (16 hex chars) stay
  global — they are the join key — while step-trace ids (process-local
  ``<tid>.<n>`` format) are namespaced too, so two processes' step
  traces never merge by id collision.
* **Clock rebasing.** Span ``t`` is per-process ``time.monotonic()``;
  each dump's ``monotonic_to_epoch`` anchor (the /spans endpoint ships
  it) rebases every span onto the shared wall clock before any
  cross-process comparison.
* **Reassignment joins.** A global trace with spans from several actors
  is joined into ONE tree: the earliest actor's root stays root; every
  later actor's subtree is parented under a synthesized
  ``reassignment`` span covering the dead time between the previous
  actor's last pre-handoff span and the next actor's first span, with
  an explicit link to the span where the previous actor went dark.
  Late work from a superseded actor (the fenced-late-submit case: A
  comes back from a partition and submits after B already completed)
  is marked ``fenced: true`` and linked from the reassignment span.
  Orphans inside a joined trace (a parent lost to a missed scrape on a
  killed process) are adopted under the trace root with
  ``adopted: true`` — counted, never silently dropped.

The stitched output feeds two consumers: the fleet Perfetto export
(``trace_export.chrome_trace`` renders one track group per process) and
the fleet critical-path report below (per-component attribution summing
to wall, including the ``reassignment`` component), both served by the
fleet aggregator (telemetry/fleet.py).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

#: Batch trace ids are blake2b(batch_id, digest_size=8).hexdigest():
#: exactly 16 lowercase hex chars. Anything else is process-local.
_GLOBAL_TRACE = re.compile(r"^[0-9a-f]{16}$")

#: Fleet batch-level attribution components, report order. ``compute``
#: is the engine working a unit between queue pull and submission —
#: synthesized per actor from the span timeline, since engine work
#: itself records no span.
FLEET_COMPONENTS = (
    "acquire", "schedule", "queue_wait", "compute", "submit",
    "reassignment", "other",
)

#: Sweep priorities (higher wins where intervals overlap).
_PRIORITY = {
    "submit": 60,
    "acquire": 50,
    "schedule": 45,
    "queue_wait": 30,
    "reassignment": 20,
    "compute": 10,
}

_STAGE_COMPONENT = {
    "acquire": "acquire",
    "schedule": "schedule",
    "queue_wait": "queue_wait",
    "submit": "submit",
    "reassignment": "reassignment",
}


def is_global_trace_id(trace_id: str) -> bool:
    """Whether a trace id joins across processes (batch digest)."""
    return bool(_GLOBAL_TRACE.match(trace_id))


def _end(span: dict) -> float:
    return span["t"] + span.get("dur_ms", 0.0) / 1e3


def tag_actor_spans(
    actor: str,
    proc: str,
    spans: Iterable[dict],
    epoch_offset: float = 0.0,
) -> List[dict]:
    """Namespace one incarnation's spans for fleet merging: rebase
    ``t`` onto the wall clock, stamp ``proc`` (the supervised process
    name — the Perfetto track group) and ``actor`` (the incarnation),
    and prefix every process-local id with ``<actor>/``. Batch trace
    ids stay global; step trace ids are namespaced like span ids."""
    prefix = f"{actor}/"
    out = []
    for s in spans:
        s = dict(s)
        s["t"] = s["t"] + epoch_offset
        s["proc"] = proc
        s["actor"] = actor
        tid = s.get("trace_id")
        if tid is not None and not is_global_trace_id(tid):
            s["trace_id"] = prefix + tid
        if s.get("span_id") is not None:
            s["span_id"] = prefix + s["span_id"]
        if s.get("parent_id") is not None:
            s["parent_id"] = prefix + s["parent_id"]
        if s.get("links"):
            s["links"] = [
                [
                    lt if is_global_trace_id(lt) else prefix + lt,
                    prefix + ls,
                ]
                for lt, ls in s["links"]
            ]
        out.append(s)
    return out


def _join_trace(trace_id: str, spans: List[dict], report: dict) -> List[dict]:
    """Join one global trace's spans (possibly from several actors)
    into a single tree; mutates ``report`` counters."""
    by_actor: Dict[str, List[dict]] = {}
    for s in spans:
        by_actor.setdefault(s["actor"], []).append(s)
    for seg in by_actor.values():
        seg.sort(key=lambda s: s["t"])
    actors = sorted(by_actor, key=lambda a: by_actor[a][0]["t"])

    def _roots(seg: List[dict]) -> List[dict]:
        ids = {s.get("span_id") for s in seg}
        return [
            s for s in seg
            if s.get("parent_id") is None or s["parent_id"] not in ids
        ]

    primary = by_actor[actors[0]]
    primary_roots = _roots(primary)
    # The batch root (parent absent) if present, else the earliest span.
    root = next(
        (s for s in primary_roots if s.get("parent_id") is None), primary[0]
    )
    # Adopt the primary actor's true orphans (parent named but lost to
    # a missed scrape) under the root — counted, never dropped. A root
    # whose own parent was lost is promoted to a real root instead.
    if root.get("parent_id") is not None:
        root["parent_id"] = None
        root["adopted"] = True
        report["orphans_adopted"] += 1
    for s in primary_roots:
        if s is root:
            continue
        if s.get("parent_id") is not None:
            s["parent_id"] = root["span_id"]
            s["adopted"] = True
            report["orphans_adopted"] += 1

    if len(actors) > 1:
        report["cross_proc"].append(trace_id)
    out = list(spans)
    prev = actors[0]
    for actor in actors[1:]:
        seg = by_actor[actor]
        prev_seg = by_actor[prev]
        handoff_t = seg[0]["t"]
        # Where the previous actor went dark: its last span ENDING
        # before the handoff (falling back to its first span when the
        # whole segment is late — fully-fenced duplicates).
        before = [s for s in prev_seg if _end(s) <= handoff_t]
        prev_last = max(before, key=_end) if before else prev_seg[0]
        gap_start = min(_end(prev_last), handoff_t)
        reassign = {
            "stage": "reassignment",
            "t": gap_start,
            "dur_ms": round(max(0.0, handoff_t - gap_start) * 1e3, 3),
            "thread": "fleet",
            "proc": seg[0]["proc"],
            "actor": actor,
            "trace_id": trace_id,
            "span_id": f"{actor}/reassign",
            "parent_id": root["span_id"],
            "links": [[trace_id, prev_last["span_id"]]],
            "from_actor": prev,
            "to_actor": actor,
        }
        # Fenced late work: the superseded actor recording spans after
        # the successor took over (late submit after a partition).
        fenced = [s for s in prev_seg if s["t"] >= handoff_t]
        for s in fenced:
            s["fenced"] = True
            reassign["links"].append([trace_id, s["span_id"]])
        reassign["fenced"] = bool(fenced)
        report["fenced"] += len(fenced)
        # Re-parent the successor's subtree roots (and its orphans)
        # under the reassignment span.
        for s in _roots(seg):
            s["parent_id"] = reassign["span_id"]
        out.append(reassign)
        report["reassignments"] += 1
        prev = actor
    return out


def stitch(incarnations: Iterable[dict]) -> dict:
    """Merge per-incarnation span dumps into fleet traces.

    ``incarnations``: dicts with keys ``proc`` (supervised process
    name), ``actor`` (unique incarnation label, e.g. ``PROC0@1234``),
    ``spans`` (the flat /spans list), and ``epoch_offset``
    (``monotonic_to_epoch`` from the same scrape).

    Returns ``{"spans": [...], "traces": n, "cross_proc": [tids],
    "reassignments": n, "fenced": n, "orphans_adopted": n}`` — the
    spans globally sorted by rebased time."""
    tagged: List[dict] = []
    for inc in incarnations:
        tagged.extend(
            tag_actor_spans(
                inc["actor"], inc["proc"], inc["spans"],
                inc.get("epoch_offset", 0.0),
            )
        )
    traces: Dict[str, List[dict]] = {}
    rest: List[dict] = []
    for s in tagged:
        tid = s.get("trace_id")
        if tid is not None and is_global_trace_id(tid):
            traces.setdefault(tid, []).append(s)
        else:
            rest.append(s)
    report = {
        "traces": len(traces),
        "cross_proc": [],
        "reassignments": 0,
        "fenced": 0,
        "orphans_adopted": 0,
    }
    out: List[dict] = list(rest)
    for tid, spans in traces.items():
        out.extend(_join_trace(tid, spans, report))
    out.sort(key=lambda s: s["t"])
    report["spans"] = out
    return report


# -- fleet critical path ------------------------------------------------------


def attribute_fleet_trace(trace_spans: List[dict]) -> dict:
    """Attribute one stitched BATCH trace's wall window across
    FLEET_COMPONENTS (ms), plus per-proc attribution of the same
    window. Components (``other`` included) sum exactly to
    ``wall_ms``; ``coverage`` is the non-``other`` fraction. The
    ``compute`` component is synthesized per actor: the window between
    its last queue/schedule activity and its submit — the engine
    working the unit, which records no span of its own."""
    zero = {c: 0.0 for c in FLEET_COMPONENTS}
    if not trace_spans:
        return {**zero, "wall_ms": 0.0, "coverage": 0.0, "per_proc": {}}
    intervals: List[Tuple[int, float, float, str, Optional[str]]] = []
    per_actor: Dict[str, Dict[str, Optional[float]]] = {}
    for s in trace_spans:
        comp = _STAGE_COMPONENT.get(s["stage"])
        start, end = s["t"], _end(s)
        if comp is not None and end > start:
            intervals.append(
                (_PRIORITY[comp], start, end, comp, s.get("proc"))
            )
        acc = per_actor.setdefault(
            s.get("actor") or s.get("proc") or "?",
            {"work_end": None, "submit_start": None, "proc": s.get("proc")},
        )
        if s["stage"] in ("schedule", "queue_wait"):
            acc["work_end"] = (
                end if acc["work_end"] is None else max(acc["work_end"], end)
            )
        elif s["stage"] == "submit":
            acc["submit_start"] = (
                start if acc["submit_start"] is None
                else min(acc["submit_start"], start)
            )
    for acc in per_actor.values():
        if (
            acc["work_end"] is not None
            and acc["submit_start"] is not None
            and acc["submit_start"] > acc["work_end"]
        ):
            intervals.append((
                _PRIORITY["compute"], acc["work_end"], acc["submit_start"],
                "compute", acc["proc"],
            ))
    lo = min(s["t"] for s in trace_spans)
    hi = max(_end(s) for s in trace_spans)
    out = dict(zero)
    per_proc: Dict[str, float] = {}
    points = sorted(
        {p for (_, a, b, _, _) in intervals for p in (a, b)} | {lo, hi}
    )
    for a, b in zip(points, points[1:]):
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        best = None
        for prio, s0, s1, comp, proc in intervals:
            if s0 <= a and s1 >= b and (best is None or prio > best[0]):
                best = (prio, comp, proc)
        ms = (b - a) * 1e3
        if best is None:
            out["other"] += ms
        else:
            out[best[1]] += ms
            if best[2]:
                per_proc[best[2]] = per_proc.get(best[2], 0.0) + ms
    wall = (hi - lo) * 1e3
    out["other"] += max(0.0, wall - sum(out.values()))
    out["wall_ms"] = wall
    out["coverage"] = (wall - out["other"]) / wall if wall > 0 else 0.0
    out["per_proc"] = per_proc
    return out


def fleet_report(stitched_spans: List[dict]) -> dict:
    """Aggregate :func:`attribute_fleet_trace` over every stitched
    batch trace: mean per-component milliseconds (keys ``<comp>_ms``),
    overall coverage (attributed wall over total wall), and per-proc
    attributed milliseconds summed across traces — the ``critical_path``
    of the aggregator's ``/fleet`` document."""
    traces: Dict[str, List[dict]] = {}
    for s in stitched_spans:
        tid = s.get("trace_id")
        if tid is not None and is_global_trace_id(tid):
            traces.setdefault(tid, []).append(s)
    n = len(traces)
    out = {f"{c}_ms": 0.0 for c in FLEET_COMPONENTS}
    out.update({"wall_ms": 0.0, "coverage": 0.0, "traces": n, "per_proc": {}})
    if n == 0:
        return out
    total_wall = total_other = 0.0
    per_proc: Dict[str, float] = {}
    for sp in traces.values():
        attr = attribute_fleet_trace(sp)
        for c in FLEET_COMPONENTS:
            out[f"{c}_ms"] += attr[c] / n
        out["wall_ms"] += attr["wall_ms"] / n
        total_wall += attr["wall_ms"]
        total_other += attr["other"]
        for proc, ms in attr["per_proc"].items():
            per_proc[proc] = per_proc.get(proc, 0.0) + ms
    for key in [f"{c}_ms" for c in FLEET_COMPONENTS] + ["wall_ms"]:
        out[key] = round(out[key], 3)
    out["coverage"] = round(
        (total_wall - total_other) / total_wall if total_wall > 0 else 0.0, 4
    )
    out["per_proc"] = {p: round(ms, 3) for p, ms in sorted(per_proc.items())}
    return out
