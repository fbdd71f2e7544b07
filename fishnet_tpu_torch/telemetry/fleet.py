"""Fleet observability plane: federate every process's metrics, stitch
their traces, evaluate SLOs, and serve one ops surface — the port of
``fishnet_tpu/telemetry/fleet.py``, on the standard library.

Processes keep their pull-style exporters; the :class:`FleetAggregator`
discovers them (static targets, or the port files that ``run
--metrics-port-file`` writes into one directory), scrapes ``/json`` and
``/spans`` on a poll loop, and exposes:

* ``/metrics``, ``/json`` — the **federated registry**: every process's
  families merged, each sample relabeled with ``proc=<name>``, plus the
  aggregator's meta-series (``fishnet_fleet_proc_up{proc}``,
  ``fishnet_fleet_scrape_age_seconds{proc}``, scrape and error
  counters) and the SLO families. **Staleness-aware**: a process that
  stops answering (SIGKILL, hang) keeps its last-known series in the
  exposition, marked stale by up=0 and a growing age, because a dead
  process's final counters are what a postmortem needs. A scrape racing
  a kill is an error counter, never a crash.
* ``/fleet`` — the fleet state document: per-proc liveness and
  staleness, incarnations, SLO evaluation, stitch summary, fleet
  critical path.
* ``/fleet/slo`` — the SLO burn-rate evaluation alone (telemetry/slo.py).
* ``/fleet/trace`` — the stitched fleet trace as a Chrome/Perfetto
  export, one track group per process (telemetry/stitch.py and
  trace_export.py).
* ``/fleet/spans`` — the stitched span list as JSON.

Span dumps are archived **per process incarnation** (pid): a restarted
process is a new actor, and archives of dead incarnations are kept, so a
unit handed to proc A, killed, and completed by proc B stitches into one
fleet trace with an explicit ``reassignment`` span. The batch-span
journals (``--spans-journal``) are tailed too, so spans a killed process
recorded after the last scrape still reach the stitcher.

``python -m fishnet_tpu_torch.telemetry.fleet`` runs the live ops
console on any terminal: per-proc liveness, lane depths, drain, shed and
breaker state, and SLO status, refreshed in place (``--profiles`` adds
the hottest stacks, ``--control`` the control plane's actuations).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from fishnet_tpu_torch.telemetry.registry import (
    MetricFamily,
    MetricsRegistry,
    Sample,
    histogram_quantiles,
)
from fishnet_tpu_torch.telemetry.slo import SLOEngine
from fishnet_tpu_torch.telemetry.stitch import fleet_report, stitch


class _Incarnation:
    """Span archive for one (proc, pid): spans deduped across scrapes
    (the ring is not cleared by a dump, and early spans survive here
    even after the ring evicts them)."""

    __slots__ = ("pid", "epoch_offset", "spans", "first_seen")

    def __init__(self, pid: int, epoch_offset: float, now: float) -> None:
        self.pid = pid
        self.epoch_offset = epoch_offset
        self.spans: Dict[str, dict] = {}
        self.first_seen = now

    def merge(self, spans: List[dict]) -> None:
        for s in spans:
            key = json.dumps(s, sort_keys=True)
            self.spans.setdefault(key, s)


class _ProcState:
    """Everything the aggregator knows about one supervised process."""

    __slots__ = (
        "name", "url", "up", "first_seen", "last_ok", "last_error",
        "scrapes", "errors", "families", "incarnations", "profile",
    )

    def __init__(self, name: str, url: str, now: float) -> None:
        self.name = name
        self.url = url
        self.up = False
        self.first_seen = now
        self.last_ok: Optional[float] = None
        self.last_error: Optional[str] = None
        self.scrapes = 0
        self.errors = 0
        self.families: Dict[str, MetricFamily] = {}
        # pid -> _Incarnation, insertion-ordered (dict preserves it).
        self.incarnations: Dict[int, _Incarnation] = {}
        # Latest /profile snapshot (only with profiles=True; None when
        # the target's profiling plane is off — its /profile 503s).
        self.profile: Optional[dict] = None

    def age_s(self, now: float) -> float:
        return now - (self.last_ok if self.last_ok is not None
                      else self.first_seen)


def port_dir_targets(dirpath: str) -> Callable[[], Dict[str, str]]:
    """Target resolver over a directory of ``<name>.port`` files (each
    process writes its bound exporter port there through ``run
    --metrics-port-file``). Re-read every poll: a restarted process
    rebinds an ephemeral port and rewrites its file, and the aggregator
    follows without any registration protocol."""

    def resolve() -> Dict[str, str]:
        targets: Dict[str, str] = {}
        for path in sorted(glob.glob(os.path.join(dirpath, "*.port"))):
            name = os.path.splitext(os.path.basename(path))[0]
            try:
                port = int(open(path, encoding="utf-8").read().strip())
            except (OSError, ValueError):
                continue  # mid-write or stale file: next poll catches up
            if port > 0:
                targets[name] = f"http://127.0.0.1:{port}"
        return targets

    return resolve


class FleetAggregator:
    """Scrapes a set of process exporters into one federated registry,
    span-archives their incarnations, and evaluates fleet SLOs.

    ``targets`` is a static ``{name: base_url}`` map; ``targets_fn`` is
    re-resolved each poll (see :func:`port_dir_targets`). Both may be
    given; ``targets_fn`` entries win on name collision."""

    def __init__(
        self,
        targets: Optional[Mapping[str, str]] = None,
        targets_fn: Optional[Callable[[], Dict[str, str]]] = None,
        poll_interval: float = 0.5,
        scrape_timeout: float = 2.0,
        slo_engine: Optional[SLOEngine] = None,
        registry: Optional[MetricsRegistry] = None,
        journal_dir: Optional[str] = None,
        profiles: bool = False,
    ) -> None:
        self._static = dict(targets or {})
        self._targets_fn = targets_fn
        self.poll_interval = poll_interval
        self.scrape_timeout = scrape_timeout
        # With profiles=True each poll also pulls /profile per target
        # (hottest-stacks console panel). Kept opt-in: profile bodies
        # are larger than /json and most targets run unprofiled (their
        # /profile 503s, which is recorded as "off", never an error).
        self.profiles = profiles
        # Batch-span journals (<name>.journal.jsonl, written by the
        # children via --spans-journal): tailed every poll so the spans
        # a SIGKILLed process recorded AFTER the last scrape still
        # reach the stitcher. offsets/heads persist across polls.
        self.journal_dir = journal_dir
        self._journal_offsets: Dict[str, int] = {}
        self._journal_heads: Dict[str, Tuple[int, float]] = {}
        self.slo = slo_engine if slo_engine is not None else SLOEngine()
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._procs: Dict[str, _ProcState] = {}
        self._polls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exporter = None
        # The aggregator's own /metrics is its registry plus this
        # collector: federated + meta + SLO families, all pull-style.
        self.registry.register_collector(
            self._collect_fleet, name="fleet-federation"
        )

    # -- scraping ---------------------------------------------------------

    def _get_json(self, url: str) -> dict:
        with urllib.request.urlopen(url, timeout=self.scrape_timeout) as resp:
            if resp.status != 200:
                raise OSError(f"HTTP {resp.status} from {url}")
            return json.loads(resp.read().decode("utf-8"))

    @staticmethod
    def _parse_families(doc: dict) -> Dict[str, MetricFamily]:
        out: Dict[str, MetricFamily] = {}
        for name, entry in doc.get("metrics", {}).items():
            fam = MetricFamily(
                name=name,
                type=entry.get("type", "gauge"),
                help=entry.get("help", ""),
            )
            for s in entry.get("samples", ()):
                fam.samples.append(Sample(
                    name=s.get("name", name),
                    value=float(s.get("value", 0.0)),
                    labels=dict(s.get("labels", {})),
                ))
            out[name] = fam
        return out

    def poll_once(self) -> None:
        """One scrape sweep over the current targets. Every failure is
        per-target and recorded (up=0, error counter, last_error) —
        a target dying mid-scrape must never take the aggregator down."""
        targets = dict(self._static)
        if self._targets_fn is not None:
            try:
                targets.update(self._targets_fn())
            except Exception:  # noqa: BLE001 - resolver races dir teardown
                pass
        now = time.time()
        results: Dict[str, Tuple[Optional[dict], Optional[dict], str]] = {}
        profiles: Dict[str, Optional[dict]] = {}
        for name, url in targets.items():
            metrics = spans = None
            err = ""
            try:
                metrics = self._get_json(url + "/json")
                spans = self._get_json(url + "/spans")
            except Exception as exc:  # noqa: BLE001 - scrape races SIGKILL
                err = f"{type(exc).__name__}: {exc}"
            results[name] = (metrics, spans, err)
            if self.profiles and metrics is not None:
                try:
                    profiles[name] = self._get_json(url + "/profile")
                except Exception:  # noqa: BLE001 - 503 = plane off
                    profiles[name] = None
        journal_batches = self._read_journals()
        with self._lock:
            self._polls += 1
            for name, url in targets.items():
                st = self._procs.get(name)
                if st is None:
                    st = self._procs[name] = _ProcState(name, url, now)
                st.url = url
                metrics, spans, err = results[name]
                if metrics is None:
                    st.up = False
                    st.errors += 1
                    st.last_error = err
                    continue
                st.up = True
                st.scrapes += 1
                st.last_ok = now
                st.last_error = None
                st.families = self._parse_families(metrics)
                if self.profiles:
                    st.profile = profiles.get(name)
                if spans is not None and "pid" in spans:
                    pid = int(spans["pid"])
                    inc = st.incarnations.get(pid)
                    if inc is None:
                        inc = st.incarnations[pid] = _Incarnation(
                            pid, float(spans.get("monotonic_to_epoch", 0.0)),
                            now,
                        )
                    inc.merge(spans.get("spans", []))
            # Targets that vanished from the resolver (port file gone)
            # are kept and marked down — staleness, not amnesia.
            for name, st in self._procs.items():
                if name not in targets and st.up:
                    st.up = False
                    st.last_error = "target disappeared"
            for name, pid, epoch, spans in journal_batches:
                st = self._procs.get(name)
                if st is None:
                    st = self._procs[name] = _ProcState(
                        name, targets.get(name, ""), now
                    )
                inc = st.incarnations.get(pid)
                if inc is None:
                    inc = st.incarnations[pid] = _Incarnation(
                        pid, epoch, now
                    )
                inc.merge(spans)
            self.slo.observe(
                {f.name: f for f in self._federated_locked()}, now
            )

    def _read_journals(self) -> List[Tuple[str, int, float, List[dict]]]:
        """Tail every ``<name>.journal.jsonl`` under ``journal_dir``
        from its last-read offset: header lines switch the current
        incarnation (pid + clock anchor), span lines accumulate under
        it. Returns ``(proc_name, pid, epoch_offset, spans)`` batches.
        All I/O errors are swallowed — the journal is a recovery aid,
        never a liveness dependency."""
        if self.journal_dir is None:
            return []
        batches: List[Tuple[str, int, float, List[dict]]] = []
        pattern = os.path.join(self.journal_dir, "*.journal.jsonl")
        for path in sorted(glob.glob(pattern)):
            name = os.path.basename(path)[: -len(".journal.jsonl")]
            offset = self._journal_offsets.get(path, 0)
            try:
                if offset and os.path.getsize(path) < offset:
                    # Rotation/truncation between polls: the file shrank
                    # below our cursor, so the journal restarted (crash
                    # dump rewrote it, or logrotate). Seeking past EOF
                    # would read b"" forever — restart from the top; the
                    # journal's header line re-establishes the
                    # incarnation, and duplicate spans are impossible
                    # because the old content is gone.
                    offset = 0
                    self._journal_offsets[path] = 0
                    self._journal_heads.pop(path, None)
                with open(path, "rb") as fp:
                    fp.seek(offset)
                    chunk = fp.read()
            except OSError:
                continue
            # Only consume complete lines; a mid-write tail is re-read
            # next poll from the same offset.
            cut = chunk.rfind(b"\n")
            if cut < 0:
                continue
            self._journal_offsets[path] = (
                self._journal_offsets.get(path, 0) + cut + 1
            )
            head = self._journal_heads.get(path)
            spans: List[dict] = []
            for line in chunk[: cut + 1].splitlines():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if str(rec.get("format", "")).startswith(
                    "fishnet-spans-journal/"
                ):
                    if spans and head is not None:
                        batches.append((name, head[0], head[1], spans))
                        spans = []
                    head = (
                        int(rec.get("pid", 0)),
                        float(rec.get("monotonic_to_epoch", 0.0)),
                    )
                elif head is not None:
                    spans.append(rec)
            if spans and head is not None:
                batches.append((name, head[0], head[1], spans))
            if head is not None:
                self._journal_heads[path] = head
        return batches

    # -- federation -------------------------------------------------------

    def _federated_locked(self) -> List[MetricFamily]:
        """Per-proc families merged with proc relabeling; caller holds
        the lock. Dead procs' last-known families are INCLUDED — the
        up/age meta-series mark them stale instead."""
        merged: Dict[str, MetricFamily] = {}
        for name, st in sorted(self._procs.items()):
            for fam in st.families.values():
                tgt = merged.get(fam.name)
                if tgt is None:
                    tgt = merged[fam.name] = MetricFamily(
                        fam.name, fam.type, fam.help
                    )
                for s in fam.samples:
                    labels = dict(s.labels)
                    labels.setdefault("proc", name)
                    tgt.samples.append(Sample(s.name, s.value, labels))
        return list(merged.values())

    def _meta_locked(self, now: float) -> List[MetricFamily]:
        up = MetricFamily(
            "fishnet_fleet_proc_up", "gauge",
            "1 if the proc answered the last scrape, 0 if stale/dead "
            "(its series stay exported either way).",
        )
        age = MetricFamily(
            "fishnet_fleet_scrape_age_seconds", "gauge",
            "Seconds since the proc's last successful scrape (grows "
            "without bound for a dead proc).",
        )
        scrapes = MetricFamily(
            "fishnet_fleet_scrapes_total", "counter",
            "Successful scrapes per proc.",
        )
        errors = MetricFamily(
            "fishnet_fleet_scrape_errors_total", "counter",
            "Failed scrapes per proc (connection refused, timeout, "
            "scrape racing a kill).",
        )
        for name, st in sorted(self._procs.items()):
            lbl = {"proc": name}
            up.samples.append(Sample(up.name, 1.0 if st.up else 0.0, lbl))
            age.samples.append(
                Sample(age.name, round(st.age_s(now), 3), dict(lbl))
            )
            scrapes.samples.append(
                Sample(scrapes.name, float(st.scrapes), dict(lbl))
            )
            errors.samples.append(
                Sample(errors.name, float(st.errors), dict(lbl))
            )
        procs = MetricFamily(
            "fishnet_fleet_procs", "gauge",
            "Processes the aggregator has ever discovered.",
        )
        procs.samples.append(Sample(procs.name, float(len(self._procs)), {}))
        return [up, age, scrapes, errors, procs]

    def _collect_fleet(self) -> List[MetricFamily]:
        now = time.time()
        with self._lock:
            fams = self._federated_locked()
            fams.extend(self._meta_locked(now))
            fams.extend(self.slo.families(now))
        return fams

    def federated_families(self) -> Dict[str, MetricFamily]:
        """Snapshot of the federated + meta + SLO families by name."""
        return {f.name: f for f in self._collect_fleet()}

    # -- stitched traces --------------------------------------------------

    def stitched(self) -> dict:
        """Run the cross-process stitcher over every archived
        incarnation; returns the stitch report (spans included)."""
        incs = []
        with self._lock:
            for name, st in sorted(self._procs.items()):
                for pid, inc in st.incarnations.items():
                    incs.append({
                        "proc": name,
                        "actor": f"{name}@{pid}",
                        "spans": list(inc.spans.values()),
                        "epoch_offset": inc.epoch_offset,
                    })
        return stitch(incs)

    def fleet_doc(self) -> dict:
        """The /fleet state document."""
        now = time.time()
        stitched = self.stitched()
        report = fleet_report(stitched["spans"])
        with self._lock:
            procs = {
                name: {
                    "url": st.url,
                    "up": st.up,
                    "age_s": round(st.age_s(now), 3),
                    "scrapes": st.scrapes,
                    "errors": st.errors,
                    "last_error": st.last_error,
                    "pids": list(st.incarnations),
                }
                for name, st in sorted(self._procs.items())
            }
            slo = self.slo.evaluate(now)
            polls = self._polls
        stitched_summary = {
            k: v for k, v in stitched.items() if k != "spans"
        }
        stitched_summary["spans"] = len(stitched["spans"])
        return {
            "time": now,
            "polls": polls,
            "procs": procs,
            "slo": slo,
            "stitch": stitched_summary,
            "critical_path": report,
        }

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FleetAggregator":
        """Start the background poll loop (daemon thread)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="fleet-aggregator", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the loop must survive anything
                pass
            self._stop.wait(self.poll_interval)

    def serve(self, port: int = 0, host: str = "127.0.0.1"):
        """Expose the aggregator itself: federated /metrics + /json on
        its own registry, plus the /fleet* routes. Returns the
        exporter (``.url``, ``.port``)."""
        from fishnet_tpu_torch.telemetry.exporter import MetricsExporter

        def _json_route(fn: Callable[[], dict]):
            def route() -> Tuple[int, str, bytes]:
                return 200, "application/json", json.dumps(fn()).encode()
            return route

        def _trace() -> Tuple[int, str, bytes]:
            from fishnet_tpu_torch.telemetry.trace_export import chrome_trace

            body = json.dumps(chrome_trace(self.stitched()["spans"]))
            return 200, "application/json", body.encode()

        self._exporter = MetricsExporter(
            port=port, host=host, registry=self.registry,
            extra_routes={
                "/fleet": _json_route(self.fleet_doc),
                "/fleet/slo": _json_route(
                    lambda: {"time": time.time(), "slo": self.slo.evaluate()}
                ),
                "/fleet/spans": _json_route(
                    lambda: {"spans": self.stitched()["spans"]}
                ),
                "/fleet/trace": _trace,
            },
        )
        return self._exporter

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None


# -- ops console --------------------------------------------------------------


def _sum_samples(
    st: _ProcState, family: str, suffix: str = "", **labels: str
) -> Optional[float]:
    fam = st.families.get(family)
    if fam is None:
        return None
    name = family + suffix
    vals = [
        s.value for s in fam.samples
        if s.name == name
        and all(s.labels.get(k) == v for k, v in labels.items())
    ]
    return sum(vals) if vals else None


def _fmt(v: Optional[float], fmt: str = "{:.0f}") -> str:
    return "-" if v is None else fmt.format(v)


def _profile_panel(procs) -> List[str]:
    """Per-proc top-5 hottest stacks from the latest /profile scrape
    (--profiles). Shows each stack's role, share of samples, and leaf
    frame — the deepest frame is where self time accrues; the full
    stacks stay on /profile?format=collapsed."""
    lines: List[str] = ["", "HOT STACKS (top 5 per proc, /profile)"]
    for name, st in procs:
        prof = st.profile
        if prof is None or not prof.get("enabled"):
            lines.append(f"{name:<10} profiling off")
            continue
        lines.append(
            f"{name:<10} {prof.get('samples', 0)} samples @ "
            f"{prof.get('hz', 0):g} Hz  duty "
            f"{prof.get('duty_cycle', 0.0):.2%}"
        )
        for row in (prof.get("stacks") or [])[:5]:
            stack = row.get("stack") or ["?"]
            lines.append(
                f"  {row.get('share', 0.0):>6.1%} {row.get('role', '?'):<9} "
                f"{stack[-1]}"
            )
    return lines


def _control_panel(procs) -> List[str]:
    """Per-proc control-plane view (--control): total actuations from
    ``fishnet_control_actuations_total`` plus the last few entries of
    each proc's ``fishnet_control_actuation_log`` ring (newest last,
    ordered by the per-proc actuation seq; the log's value is the
    signal window that decided it)."""
    lines: List[str] = ["", "CONTROL PLANE (last actuations per proc)"]
    for name, st in procs:
        total = _sum_samples(st, "fishnet_control_actuations_total")
        if total is None:
            lines.append(f"{name:<10} control plane off")
            continue
        lines.append(f"{name:<10} {total:.0f} actuations")
        fam = st.families.get("fishnet_control_actuation_log")
        rows = sorted(
            fam.samples, key=lambda s: int(s.labels.get("seq", "0"))
        ) if fam is not None else []
        for s in rows:
            lines.append(
                f"  #{s.labels.get('seq', '?'):>3} w{s.value:<5.0f} "
                f"{s.labels.get('knob', '?'):<16} "
                f"{s.labels.get('direction', '?'):<6} "
                f"-> {s.labels.get('to', '?')}"
            )
    return lines


def _role_of(st: _ProcState) -> str:
    """The proc's split-plane role from its ``fishnet_rpc_role`` gauge;
    a monolith exposes no rpc family at all."""
    fam = st.families.get("fishnet_rpc_role")
    if fam is not None:
        for s in fam.samples:
            if s.value:
                return s.labels.get("role", "?")
    return "mono"


def _ring_panel(procs) -> List[str]:
    """Per-link ring-depth view for split fleets: every attached link's
    submit/result queue depth as the owning proc reports it
    (``fishnet_rpc_ring_depth``). Only rendered when some proc exposes
    the family — a monolith fleet keeps its console unchanged."""
    rows: List[str] = []
    for name, st in procs:
        fam = st.families.get("fishnet_rpc_ring_depth")
        if fam is None:
            continue
        depths: Dict[str, Dict[str, float]] = {}
        for s in fam.samples:
            link = s.labels.get("link", "?")
            depths.setdefault(link, {})[s.labels.get("ring", "?")] = s.value
        for link in sorted(depths):
            d = depths[link]
            rows.append(
                f"{name:<10} {link:<24} "
                f"submit {d.get('submit', 0.0):>4.0f}  "
                f"result {d.get('result', 0.0):>4.0f}"
            )
    if not rows:
        return []
    return ["", "RPC LINKS (ring depth per link)"] + rows


def render_console(
    agg: FleetAggregator, profiles: bool = False, control: bool = False
) -> str:
    """One console frame: per-proc serving state + SLO table (+ the
    hottest-stacks panel with ``profiles=True``, + the control-plane
    actuation panel with ``control=True``)."""
    now = time.time()
    lines: List[str] = []
    with agg._lock:
        procs = list(sorted(agg._procs.items()))
        n_up = sum(1 for _, st in procs if st.up)
        lines.append(
            f"fishnet fleet  {len(procs)} procs  {n_up} up  "
            f"poll #{agg._polls}  {time.strftime('%H:%M:%S', time.localtime(now))}"
        )
        lines.append(
            f"{'PROC':<10} {'UP':<3} {'ROLE':<9} {'AGE':>6} {'PIDS':>4} "
            f"{'REQS':>7} {'LANES':>5} {'SHED':>4} {'DRAIN':>5} {'BRKR':>4} "
            f"{'ACQ_P99':>8}"
        )
        for name, st in procs:
            reqs = _sum_samples(st, "fishnet_api_requests_total")
            lanes = _sum_samples(st, "fishnet_lane_depth")
            shed = _sum_samples(st, "fishnet_shed_active")
            drain = _sum_samples(st, "fishnet_drain_state")
            brkr = _sum_samples(st, "fishnet_breaker_state")
            p99 = None
            fam = st.families.get("fishnet_api_request_seconds")
            if fam is not None:
                rows = [
                    r for r in histogram_quantiles(fam)
                    if r["labels"].get("endpoint") == "acquire" and r["count"]
                ]
                if rows:
                    p99 = max(r["p99"] for r in rows if r["p99"] is not None)
            lines.append(
                f"{name:<10} {'y' if st.up else 'N':<3} "
                f"{_role_of(st):<9} "
                f"{st.age_s(now):>5.1f}s {len(st.incarnations):>4} "
                f"{_fmt(reqs):>7} {_fmt(lanes):>5} {_fmt(shed):>4} "
                f"{_fmt(drain):>5} {_fmt(brkr):>4} "
                f"{_fmt(p99, '{:.3f}'):>8}"
            )
            if not st.up and st.last_error:
                lines.append(f"  !! {name}: {st.last_error}")
        slo_rows = agg.slo.evaluate(now)
        lines.extend(_ring_panel(procs))
        if profiles:
            lines.extend(_profile_panel(procs))
        if control:
            lines.extend(_control_panel(procs))
    lines.append("")
    lines.append(f"{'SLO':<20} {'OBJ':>6} {'STATUS':<8} WINDOWS")
    for row in slo_rows:
        windows = "  ".join(
            f"{w}={b:.2f}" for w, b in row["windows"].items()
        )
        lines.append(
            f"{row['slo']:<20} {row['objective']:>6.3f} "
            f"{row['status']:<8} {windows}"
        )
    return "\n".join(lines)


def run_console(
    agg: FleetAggregator,
    interval: float = 1.0,
    once: bool = False,
    out=sys.stdout,
    profiles: bool = False,
    control: bool = False,
) -> None:
    """Render the console in place until interrupted (or once)."""
    while True:
        frame = render_console(agg, profiles=profiles, control=control)
        if once:
            out.write(frame + "\n")
            return
        out.write("\x1b[2J\x1b[H" + frame + "\n")
        out.flush()
        time.sleep(interval)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch.telemetry.fleet",
        description=(
            "Fleet observability: scrape every process exporter into "
            "one federated registry and show the live ops console."
        ),
    )
    parser.add_argument(
        "targets", nargs="*", metavar="NAME=URL",
        help="static scrape targets (bare URLs get proc0, proc1, ...)",
    )
    parser.add_argument(
        "--port-dir", metavar="DIR",
        help="directory of <name>.port files (run --metrics-port-file); "
             "re-scanned every poll so restarts are followed",
    )
    parser.add_argument(
        "--interval", type=float, default=0.5,
        help="scrape interval in seconds (default 0.5)",
    )
    parser.add_argument(
        "--serve", type=int, metavar="PORT",
        help="also expose the federated registry + /fleet routes on "
             "this port (0 = ephemeral; the bound URL is printed)",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="poll once, print one console frame, exit",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="with --once: print the /fleet JSON document instead",
    )
    parser.add_argument(
        "--profiles", action="store_true",
        help="also scrape each target's /profile and show a per-proc "
             "top-5 hottest-stacks panel (targets with the profiling "
             "plane off show 'profiling off'); default table unchanged",
    )
    parser.add_argument(
        "--control", action="store_true",
        help="also show the control-plane panel: per-proc actuation "
             "totals and the last few fishnet_control_actuation_log "
             "entries (targets without the control plane show "
             "'control plane off'); default table unchanged",
    )
    args = parser.parse_args(argv)
    static: Dict[str, str] = {}
    for i, t in enumerate(args.targets):
        if "=" in t:
            name, url = t.split("=", 1)
        else:
            name, url = f"proc{i}", t
        static[name] = url
    if not static and not args.port_dir:
        parser.error("no targets: pass NAME=URL args or --port-dir")
    agg = FleetAggregator(
        targets=static,
        targets_fn=port_dir_targets(args.port_dir) if args.port_dir else None,
        poll_interval=args.interval,
        profiles=args.profiles,
    )
    if args.serve is not None:
        exporter = agg.serve(args.serve)
        print(f"fleet exporter on {exporter.url}", file=sys.stderr)
    try:
        if args.once:
            agg.poll_once()
            if args.json:
                print(json.dumps(agg.fleet_doc(), indent=2))
            else:
                run_console(
                    agg, once=True, profiles=args.profiles,
                    control=args.control,
                )
            return 0
        agg.start()
        run_console(
            agg, interval=max(0.2, args.interval), profiles=args.profiles,
            control=args.control,
        )
    except KeyboardInterrupt:
        pass
    finally:
        agg.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
