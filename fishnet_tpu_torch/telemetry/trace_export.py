"""Perfetto / Chrome Trace Event export for fishnet-spans dumps — the
port of ``fishnet_tpu/telemetry/trace_export.py``.

Turns the flight recorder's flat span list (``RECORDER.spans()`` or a
``fishnet-spans-*.jsonl`` dump) into Chrome Trace Event Format [1] that
loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``:

* one track per recording thread (``M`` thread_name metadata events,
  named after the span's ``thread`` field);
* one ``X`` complete event per span (``ts``/``dur`` in microseconds,
  extra span fields under ``args``);
* ``s``/``f`` flow arrows for every CROSS-THREAD causal edge — the
  driver's ``device_step`` → pack worker's ``dispatch_issue`` → decode
  worker's ``dispatch_wait`` handoff renders as arrows across tracks,
  fused fan-in included (one arrow per linked owner).

Two entry points:

* ``GET /trace`` on the metrics exporter (live ring contents);
* ``python -m fishnet_tpu_torch.telemetry.trace_export spans.jsonl -o
  trace.json`` for post-mortem dumps (multiple inputs are merged and
  de-duplicated — successive dumps of the same ring overlap).

The output equals the JAX package's on the same spans.

[1] https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

_FLOW_CAT = "flow"


def _us(t: float) -> float:
    return round(t * 1e6, 1)


def chrome_trace(spans: List[dict], pid: int = 1) -> dict:
    """Build a Chrome Trace Event Format object from flat spans.

    A span carrying a ``proc`` field (a fleet aggregator's stitched
    output) lands in that process's own track
    group: one Chrome ``pid`` per distinct ``proc`` with a
    ``process_name`` metadata event, so a fleet export renders one
    track group per client process. Spans without ``proc`` all share
    the default ``pid`` — single-process exports are unchanged."""
    events: List[dict] = []
    tids: Dict[tuple, int] = {}
    pids: Dict[str, int] = {}

    def pid_of(proc: Optional[str]) -> int:
        if proc is None:
            return pid
        p = pids.get(proc)
        if p is None:
            p = pids[proc] = pid + 1 + len(pids)
            events.append({
                "ph": "M", "name": "process_name", "pid": p, "tid": 0,
                "args": {"name": proc},
            })
        return p

    def tid_of(proc: Optional[str], thread: Optional[str]) -> tuple:
        name = thread or "unknown"
        key = (proc, name)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid_of(proc),
                "tid": tid, "args": {"name": name},
            })
        return tid

    by_id: Dict[str, dict] = {}
    for s in spans:
        sid = s.get("span_id")
        if sid is not None:
            by_id[sid] = s

    def track_of(s: dict):
        proc = s.get("proc")
        return pid_of(proc), tid_of(proc, s.get("thread"))

    flow_n = 0
    for s in spans:
        s_pid, tid = track_of(s)
        args = {
            k: v for k, v in s.items()
            if k not in ("stage", "t", "dur_ms", "thread")
        }
        events.append({
            "ph": "X", "name": s["stage"], "cat": "fishnet", "pid": s_pid,
            "tid": tid, "ts": _us(s["t"]),
            "dur": round(s.get("dur_ms", 0.0) * 1e3, 1), "args": args,
        })
        # Flow arrows: one per cross-track causal edge (parent link or
        # fan-in link) whose source span is present in the dump — the
        # cross-PROCESS edges of a stitched fleet trace render exactly
        # like cross-thread handoffs, arrows across track groups.
        sources = []
        parent = by_id.get(s.get("parent_id"))
        if parent is not None:
            sources.append(parent)
        for link in s.get("links") or ():
            src = by_id.get(link[1])
            if src is not None:
                sources.append(src)
        for src in sources:
            if src.get("thread") == s.get("thread") and (
                src.get("proc") == s.get("proc")
            ):
                continue
            flow_n += 1
            fid = f"flow{flow_n}"
            src_pid, src_tid = track_of(src)
            events.append({
                "ph": "s", "id": fid, "name": "handoff", "cat": _FLOW_CAT,
                "pid": src_pid, "tid": src_tid,
                "ts": _us(src["t"] + src.get("dur_ms", 0.0) / 1e3),
            })
            events.append({
                "ph": "f", "bp": "e", "id": fid, "name": "handoff",
                "cat": _FLOW_CAT, "pid": s_pid, "tid": tid, "ts": _us(s["t"]),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj: dict) -> None:
    """Structural validation of a Chrome Trace Event object; raises
    ``ValueError`` on the first violation. Used by the CLI, the tests
    and the card's smoke, so a malformed export fails loudly rather
    than rendering as an empty Perfetto page."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("top level must be a dict with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    open_flows = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "M", "s", "f"):
            raise ValueError(f"event {i}: unknown ph {ph!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"event {i}: {key} must be an int")
        if ph == "M":
            if ev.get("name") not in (
                "thread_name", "process_name"
            ) or "name" not in ev.get("args", {}):
                raise ValueError(f"event {i}: malformed metadata event")
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"event {i}: ts must be a number")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i}: X event needs dur >= 0")
        elif ph == "s":
            open_flows[ev.get("id")] = i
        elif ph == "f":
            if ev.get("bp") != "e":
                raise ValueError(f"event {i}: flow finish needs bp='e'")
            if ev.get("id") not in open_flows:
                raise ValueError(f"event {i}: flow finish without start")
            del open_flows[ev["id"]]
    if open_flows:
        raise ValueError(
            f"{len(open_flows)} flow start(s) without a finish"
        )


def read_spans(paths: List[str]) -> List[dict]:
    """Parse one or more fishnet-spans JSONL dumps into a flat span
    list: header lines (objects with a ``format`` key) are skipped and
    spans repeated across dumps of the same ring are de-duplicated."""
    seen = set()
    out: List[dict] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if not isinstance(rec, dict) or "format" in rec:
                    continue
                key = json.dumps(rec, sort_keys=True)
                if key in seen:
                    continue
                seen.add(key)
                out.append(rec)
    out.sort(key=lambda s: s.get("t", 0.0))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch.telemetry.trace_export",
        description=(
            "Convert fishnet-spans JSONL dumps to a Chrome/Perfetto "
            "trace (load the output at https://ui.perfetto.dev)."
        ),
    )
    parser.add_argument(
        "inputs", nargs="+", metavar="SPANS_JSONL",
        help="one or more fishnet-spans-*.jsonl dump files",
    )
    parser.add_argument(
        "-o", "--output", default="trace.json",
        help="output Chrome trace path (default: trace.json)",
    )
    args = parser.parse_args(argv)
    spans = read_spans(args.inputs)
    trace = chrome_trace(spans)
    validate_chrome_trace(trace)
    with open(args.output, "w", encoding="utf-8") as fh:
        json.dump(trace, fh)
    n_spans = sum(1 for ev in trace["traceEvents"] if ev["ph"] == "X")
    n_flows = sum(1 for ev in trace["traceEvents"] if ev["ph"] == "s")
    print(
        f"wrote {args.output}: {n_spans} spans, {n_flows} flow arrows "
        f"from {len(args.inputs)} dump(s)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
