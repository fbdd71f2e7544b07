"""Critical-path analysis over causal span trees (fishnet-spans/2) — the
port of ``fishnet_tpu/telemetry/critical_path.py``; its results equal the
JAX module's on the same spans.

Input is the flat span list the flight recorder produces
(``RECORDER.spans()`` or a parsed JSONL dump): dicts with ``stage``,
``t`` (monotonic seconds), ``dur_ms``, ``thread``, and — when recorded
under a trace context — ``trace_id``/``span_id``/``parent_id`` plus
optional ``links`` (the fan-in convention, telemetry/tracing.py).

Three consumers:

* :func:`group_traces` / :func:`orphan_spans` — span-tree
  reconstruction and the completeness check (a healthy gated run has
  ZERO orphans: every non-root span's parent is present in its trace).
  A shared fan-in span (one fused dispatch serving K segment owners) is
  re-attached to every linked trace, re-parented under the linked span.
* :func:`critical_path` — the root→leaf chain ending at a trace's
  last-ending span.
* :func:`attribute_trace` / :func:`report` — wall-time attribution:
  each instant of a trace's wall window is charged to exactly one named
  component by a priority interval sweep, so the components sum to the
  window (residual = ``other``). ``report`` aggregates step traces
  (root stage ``pack``) into a ``critical_path`` summary dict (the keys
  of the JAX package's bench summary); ``batch_report`` does the
  per-request (acquire→submit) view.

Attribution semantics, highest priority first:

* ``pack``          — driver host work: ``pack`` + ``device_step``
* ``submit``        — post-eval host work: ``postprocess`` (step
  traces) / the final ``submit`` round-trip (batch traces)
* ``transport``     — ``dispatch_issue``/``coalesce`` (host staging
  through the launch), plus the probe-measured fixed transport
  slice of the in-flight interval when ``fixed_transport_ms`` is given
  (DispatchProbe.fixed_ms — the per-dispatch cost the coalescer
  exists to amortize)
* ``device_compute``— the dispatch's in-flight interval
  [issue end, dispatch_wait end] net of the fixed-transport slice
* ``decode_wait``   — driver blocked in ``wire_decode`` (outranked by
  device_compute: a driver waiting while the dispatch is in flight is
  waiting on the DEVICE, not on decode)
* ``queue_wait``    — explicit ``queue_wait`` spans (scheduler dwell),
  plus the residue of the [``device_step`` end, ``wire_decode`` start]
  window not claimed by a higher-priority interval (the coalescer
  holding a ticket for siblings; a materialized result waiting for the
  driver to come back)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: Component names in report order. ``reassignment`` is fleet-only: the
#: dead time between a process dying with a unit in flight and another
#: process re-acquiring it (a fleet stitcher synthesizes the span);
#: single-process traces never contain it.
COMPONENTS = (
    "queue_wait", "pack", "transport", "device_compute", "decode_wait",
    "submit", "reassignment", "other",
)

#: Sweep priority per component (higher wins where intervals overlap).
#: ``reassignment`` outranks queue_wait (the unit is not queued anywhere
#: during the gap — it is lost until the server's sweep re-hands it)
#: but yields to every live-work component.
_PRIORITY = {
    "pack": 60,
    "submit": 50,
    "transport": 40,
    "device_compute": 30,
    "decode_wait": 20,
    "reassignment": 15,
    "queue_wait": 10,
}

#: stage -> attributed component (intervals taken from the span as-is).
_STAGE_COMPONENT = {
    "pack": "pack",
    "device_step": "pack",
    "postprocess": "submit",
    "submit": "submit",
    "dispatch_issue": "transport",
    "coalesce": "transport",
    "wire_decode": "decode_wait",
    "queue_wait": "queue_wait",
    "acquire": "pack",
    "schedule": "pack",
    "reassignment": "reassignment",
}


def _end(span: dict) -> float:
    return span["t"] + span.get("dur_ms", 0.0) / 1e3


def group_traces(spans: List[dict]) -> Dict[str, List[dict]]:
    """Reconstruct traces: ``trace_id`` -> its spans. A span carrying
    ``links`` is COPIED into each linked trace, re-parented under the
    linked span — the fused-dispatch fan-in becomes an ordinary child
    in every owner's tree."""
    traces: Dict[str, List[dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid is None:
            continue
        traces.setdefault(tid, []).append(s)
        for link in s.get("links") or ():
            ltid, lsid = link[0], link[1]
            if ltid == tid:
                continue
            shared = dict(s)
            shared["trace_id"] = ltid
            shared["parent_id"] = lsid
            shared.pop("links", None)
            traces.setdefault(ltid, []).append(shared)
    for sp in traces.values():
        sp.sort(key=lambda s: s["t"])
    return traces


def orphan_spans(spans: List[dict]) -> List[dict]:
    """Spans whose ``parent_id`` names a span absent from their trace —
    empty on a healthy gated run (the completeness acceptance check)."""
    orphans = []
    for sp in group_traces(spans).values():
        ids = {s.get("span_id") for s in sp}
        for s in sp:
            parent = s.get("parent_id")
            if parent is not None and parent not in ids:
                orphans.append(s)
    return orphans


def critical_path(trace_spans: List[dict]) -> List[dict]:
    """The root→leaf parent chain ending at the trace's LAST-ENDING
    span — the dependency chain that bounded this trace's wall time."""
    if not trace_spans:
        return []
    by_id = {
        s["span_id"]: s for s in trace_spans if s.get("span_id") is not None
    }
    cur = max(trace_spans, key=_end)
    chain = [cur]
    seen = {cur.get("span_id")}
    while True:
        parent = by_id.get(cur.get("parent_id"))
        if parent is None or parent.get("span_id") in seen:
            break
        chain.append(parent)
        seen.add(parent.get("span_id"))
        cur = parent
    return list(reversed(chain))


def attribute_trace(
    trace_spans: List[dict],
    fixed_transport_ms: Optional[float] = None,
) -> Dict[str, float]:
    """Attribute one trace's wall window into named components (ms).
    Returns ``{component: ms, ..., "wall_ms": ..., "coverage": ...}``;
    the components (``other`` included) sum to ``wall_ms`` exactly, and
    ``coverage`` is the attributed (non-``other``) fraction."""
    if not trace_spans:
        return {**{c: 0.0 for c in COMPONENTS}, "wall_ms": 0.0, "coverage": 0.0}

    intervals: List[Tuple[int, float, float, str]] = []
    issue_end: Optional[float] = None
    wait_end: Optional[float] = None
    dstep_end: Optional[float] = None
    decode_start: Optional[float] = None
    for s in trace_spans:
        comp = _STAGE_COMPONENT.get(s["stage"])
        start, end = s["t"], _end(s)
        if comp is not None and end > start:
            intervals.append((_PRIORITY[comp], start, end, comp))
        if s["stage"] in ("dispatch_issue", "coalesce"):
            issue_end = end if issue_end is None else max(issue_end, end)
        elif s["stage"] == "dispatch_wait":
            wait_end = end if wait_end is None else max(wait_end, end)
        elif s["stage"] == "device_step":
            dstep_end = end if dstep_end is None else max(dstep_end, end)
        elif s["stage"] == "wire_decode":
            decode_start = (
                start if decode_start is None else min(decode_start, start)
            )

    # The dispatch's in-flight interval (issue done -> values
    # materialized) is the device working + the wire: charge the
    # probe-measured fixed transport slice to transport, the rest to
    # device_compute.
    if issue_end is not None and wait_end is not None and wait_end > issue_end:
        split = issue_end
        if fixed_transport_ms:
            split = min(wait_end, issue_end + fixed_transport_ms / 1e3)
            if split > issue_end:
                intervals.append(
                    (_PRIORITY["transport"], issue_end, split, "transport")
                )
        intervals.append(
            (_PRIORITY["device_compute"], split, wait_end, "device_compute")
        )
    # Parked between device submission and host resolution: the whole
    # [device_step end, wire_decode start] window at queue_wait
    # priority. Higher-priority intervals inside it (dispatch staging,
    # the in-flight transport/compute split above) carve out their
    # parts; the residue — ticket waiting for siblings in the
    # coalescer, or a materialized result waiting for the driver to
    # come back — is genuinely queueing.
    if (
        dstep_end is not None
        and decode_start is not None
        and decode_start > dstep_end
    ):
        intervals.append(
            (_PRIORITY["queue_wait"], dstep_end, decode_start, "queue_wait")
        )

    lo = min(s["t"] for s in trace_spans)
    hi = max(_end(s) for s in trace_spans)
    out = {c: 0.0 for c in COMPONENTS}
    points = sorted({p for (_, a, b, _) in intervals for p in (a, b)} | {lo, hi})
    for a, b in zip(points, points[1:]):
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        best = None
        for prio, s0, s1, comp in intervals:
            if s0 <= a and s1 >= b and (best is None or prio > best[0]):
                best = (prio, comp)
        out[best[1] if best else "other"] += (b - a) * 1e3
    wall = (hi - lo) * 1e3
    out["other"] += max(0.0, wall - sum(out.values()))
    out["wall_ms"] = wall
    out["coverage"] = (
        (wall - out["other"]) / wall if wall > 0 else 0.0
    )
    return out


def _is_step_trace(trace_spans: List[dict]) -> bool:
    return any(s["stage"] == "pack" for s in trace_spans)


def report(
    spans: List[dict],
    fixed_transport_ms: Optional[float] = None,
    skip_warmup: bool = True,
) -> dict:
    """Aggregate attribution over STEP traces (one per group eval
    microbatch): mean per-component milliseconds of steady-state
    per-batch wall time — the ``critical_path`` summary dict. ``skip_warmup`` drops the earliest 20% of traces (max 5):
    first-dispatch compiles and probe traffic are not steady state."""
    traces = [
        sp for sp in group_traces(spans).values() if _is_step_trace(sp)
    ]
    traces.sort(key=lambda sp: sp[0]["t"])
    if skip_warmup and len(traces) >= 5:
        traces = traces[min(len(traces) // 5, 5):]
    n = len(traces)
    keys = {
        "queue_wait": "queue_wait_ms", "pack": "pack_ms",
        "transport": "transport_ms", "device_compute": "compute_ms",
        "decode_wait": "decode_wait_ms", "submit": "submit_ms",
        "reassignment": "reassignment_ms", "other": "other_ms",
    }
    out = {v: 0.0 for v in keys.values()}
    out.update({"wall_ms": 0.0, "coverage": 0.0, "traces": n})
    if n == 0:
        return out
    total_wall = total_other = 0.0
    for sp in traces:
        attr = attribute_trace(sp, fixed_transport_ms=fixed_transport_ms)
        for comp, key in keys.items():
            out[key] += attr[comp] / n
        out["wall_ms"] += attr["wall_ms"] / n
        total_wall += attr["wall_ms"]
        total_other += attr["other"]
    for key in [*keys.values(), "wall_ms"]:
        out[key] = round(out[key], 3)
    out["coverage"] = round(
        (total_wall - total_other) / total_wall if total_wall > 0 else 0.0, 4
    )
    return out


def batch_report(spans: List[dict]) -> dict:
    """Per-REQUEST view: aggregate attribution over batch traces
    (acquire → schedule → queue_wait → submit), keyed like
    :func:`report` but measuring the server-batch lifecycle."""
    traces = [
        sp for sp in group_traces(spans).values() if not _is_step_trace(sp)
    ]
    n = len(traces)
    out = {
        "queue_wait_ms": 0.0, "schedule_ms": 0.0, "submit_ms": 0.0,
        "wall_ms": 0.0, "batches": n,
    }
    if n == 0:
        return out
    comp_of = {"queue_wait": "queue_wait_ms", "schedule": "schedule_ms",
               "submit": "submit_ms", "acquire": "schedule_ms"}
    for sp in traces:
        lo = min(s["t"] for s in sp)
        hi = max(_end(s) for s in sp)
        out["wall_ms"] += (hi - lo) * 1e3 / n
        for s in sp:
            key = comp_of.get(s["stage"])
            if key:
                out[key] += s.get("dur_ms", 0.0) / n
    for key in ("queue_wait_ms", "schedule_ms", "submit_ms", "wall_ms"):
        out[key] = round(out[key], 3)
    return out
