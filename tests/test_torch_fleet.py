"""The port's fleet plane (fishnet_tpu_torch.telemetry.{stitch,fleet})
against the JAX package's, on the CPU: the stitch and aggregator tests of
tests/test_fleet_obs.py.

Stitching: the same incarnation dumps give equal reports from both
packages (``tag_actor_spans``, ``stitch`` with its reassignment joins and
fenced late submits, ``attribute_fleet_trace``, ``fleet_report``), and the
port's Chrome export renders one track group a process. The aggregator:
the port's ``FleetAggregator`` and the JAX one, polling the same port
exporters, agree on the federated families (``proc=`` on every sample,
the ``fishnet_fleet_*`` meta-series, the SLO families) and on the
``/fleet`` document; staleness after an exporter closes and after a
SIGKILLed process; the ``/fleet*`` routes; port-file discovery and its
rewrites; the span journal's recovery, a torn tail and a truncation
between polls; the MCTS families; profiles and the control panel in the
console; the ``python -m fishnet_tpu_torch.telemetry.fleet`` entry point.

(tests/test_fleet_obs.py's SIGKILL restart churn drives the JAX cluster
supervisor, which the port does not have yet.)"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from fishnet_tpu.telemetry import critical_path as jax_cp
from fishnet_tpu.telemetry import fleet as jax_fleet
from fishnet_tpu.telemetry import stitch as jax_stitch
from fishnet_tpu.telemetry.tracing import trace_id_for_batch as jax_trace_id
from fishnet_tpu_torch import telemetry
from fishnet_tpu_torch.telemetry import fleet, profiler, stitch
from fishnet_tpu_torch.telemetry.critical_path import group_traces, orphan_spans
from fishnet_tpu_torch.telemetry.exporter import MetricsExporter
from fishnet_tpu_torch.telemetry.registry import MetricsRegistry
from fishnet_tpu_torch.telemetry.slo import default_slos
from fishnet_tpu_torch.telemetry.spans import SpanRecorder
from fishnet_tpu_torch.telemetry.trace_export import (
    chrome_trace,
    validate_chrome_trace,
)
from fishnet_tpu_torch.telemetry.tracing import (
    batch_root,
    new_trace,
    trace_id_for_batch,
)

ROOT = Path(__file__).resolve().parent.parent
FLEETS = {"jax": jax_fleet, "torch": fleet}
STITCHES = {"jax": jax_stitch, "torch": stitch}


@pytest.fixture(autouse=True)
def profiler_off():
    profiler.stop()
    yield
    profiler.stop()


def both(fn, mods=STITCHES):
    out = {name: fn(mod) for name, mod in mods.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _get(url: str, timeout: float = 3.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        assert resp.status == 200
        return resp.read()


# -- cross-process stitching ---------------------------------------------------


def _span(stage, t, dur_ms, tid=None, sid=None, parent=None, **fields):
    s = {"stage": stage, "t": t, "dur_ms": dur_ms, "thread": "w0"}
    if tid is not None:
        s["trace_id"] = tid
    if sid is not None:
        s["span_id"] = sid
    if parent is not None:
        s["parent_id"] = parent
    s.update(fields)
    return s


def test_global_trace_id_is_the_batch_digest_shape():
    tid = trace_id_for_batch("workunit-1")
    assert tid == jax_trace_id("workunit-1")
    assert both(lambda m: (m.is_global_trace_id(tid),
                           m.is_global_trace_id("3.7"),
                           m.is_global_trace_id("ABCDEF0123456789"))) \
        == (True, False, False)


def test_tag_actor_spans_namespaces_and_rebases():
    tid = trace_id_for_batch("B")

    def run(m):
        spans = [
            _span("acquire", 1.0, 100.0, tid=tid, sid=tid),
            _span("pack", 2.0, 5.0, tid="3.7", sid="3.8", parent="3.7",
                  links=[["3.7", "3.9"]]),
        ]
        out = m.tag_actor_spans("A@1", "PROC0", spans, epoch_offset=1000.0)
        return out, spans[0]["t"]

    out, untouched = both(run)
    assert out[0]["t"] == 1001.0 and out[0]["proc"] == "PROC0"
    assert out[0]["trace_id"] == tid
    assert out[0]["span_id"] == f"A@1/{tid}"
    assert out[1]["trace_id"] == "A@1/3.7"
    assert out[1]["links"] == [["A@1/3.7", "A@1/3.9"]]
    assert untouched == 1.0


def _two_proc_dump(fenced_submit=False):
    """PROC0 acquires a unit and dies; PROC1 takes it over after the
    server's reassignment and completes; with ``fenced_submit`` PROC0
    also submits late and is fenced."""
    tid = trace_id_for_batch("game42")
    a = [
        _span("acquire", 10.0, 50.0, tid=tid, sid=tid),
        _span("schedule", 10.1, 5.0, tid=tid, sid="1.1", parent=tid),
        _span("queue_wait", 10.15, 200.0, tid=tid, sid="1.2", parent="1.1"),
    ]
    if fenced_submit:
        a.append(_span("submit", 13.5, 40.0, tid=tid, sid="1.3", parent=tid))
    b = [
        _span("acquire", 12.5, 60.0, tid=tid, sid=tid),
        _span("schedule", 12.6, 4.0, tid=tid, sid="2.1", parent=tid),
        _span("queue_wait", 12.65, 150.0, tid=tid, sid="2.2", parent="2.1"),
        _span("submit", 13.0, 30.0, tid=tid, sid="2.3", parent=tid),
    ]
    return tid, [
        {"proc": "PROC0", "actor": "PROC0@100", "spans": a,
         "epoch_offset": 0.0},
        {"proc": "PROC1", "actor": "PROC1@200", "spans": b,
         "epoch_offset": 0.0},
    ]


def test_stitch_joins_reassigned_unit_into_one_tree():
    tid, _ = _two_proc_dump()
    report = both(lambda m: m.stitch(_two_proc_dump()[1]))
    assert report["traces"] == 1
    assert report["cross_proc"] == [tid]
    assert report["reassignments"] == 1 and report["fenced"] == 0
    spans = [s for s in report["spans"] if s.get("trace_id") == tid]
    r = [s for s in spans if s["stage"] == "reassignment"]
    assert len(r) == 1
    r = r[0]
    assert r["from_actor"] == "PROC0@100" and r["to_actor"] == "PROC1@200"
    assert [tid, "PROC0@100/1.2"] in r["links"]
    b_root = next(s for s in spans if s["span_id"] == f"PROC1@200/{tid}")
    assert b_root["parent_id"] == r["span_id"]
    assert r["parent_id"] == f"PROC0@100/{tid}"
    roots = [s for s in spans if s.get("parent_id") is None]
    assert len(roots) == 1 and roots[0]["span_id"] == f"PROC0@100/{tid}"
    # No orphan under either package's single-process grouper.
    for trace in group_traces(report["spans"]).values():
        assert orphan_spans(trace) == []
    for trace in jax_cp.group_traces(report["spans"]).values():
        assert jax_cp.orphan_spans(trace) == []


def test_stitch_marks_fenced_late_submit():
    tid, _ = _two_proc_dump(fenced_submit=True)
    report = both(lambda m: m.stitch(_two_proc_dump(fenced_submit=True)[1]))
    assert report["fenced"] == 1
    spans = [s for s in report["spans"] if s.get("trace_id") == tid]
    r = next(s for s in spans if s["stage"] == "reassignment")
    late = next(s for s in spans if s["span_id"] == "PROC0@100/1.3")
    assert late.get("fenced") is True
    assert [tid, "PROC0@100/1.3"] in r["links"]
    assert r["fenced"] is True
    for trace in group_traces(report["spans"]).values():
        assert orphan_spans(trace) == []


def test_stitch_keeps_step_traces_per_process():
    def run(m):
        a = [_span("pack", 1.0, 5.0, tid="3.1", sid="3.2", parent="3.1")]
        b = [_span("pack", 1.0, 5.0, tid="3.1", sid="3.2", parent="3.1")]
        return m.stitch([
            {"proc": "P0", "actor": "P0@1", "spans": a, "epoch_offset": 0.0},
            {"proc": "P1", "actor": "P1@2", "spans": b, "epoch_offset": 0.0},
        ])

    report = both(run)
    assert {s["trace_id"] for s in report["spans"]} == {"P0@1/3.1", "P1@2/3.1"}


def test_fleet_attribution_sums_to_wall_with_reassignment():
    tid, _ = _two_proc_dump()

    def run(m):
        spans = m.stitch(_two_proc_dump()[1])["spans"]
        attr = m.attribute_fleet_trace(
            [s for s in spans if s.get("trace_id") == tid])
        return attr, m.fleet_report(spans), m.FLEET_COMPONENTS

    attr, report, comps = both(run)
    total = sum(attr[c] for c in comps)
    assert attr["wall_ms"] > 0
    assert abs(total - attr["wall_ms"]) < 1e-6
    assert attr["reassignment"] > 0 and attr["coverage"] > 0.9
    assert set(attr["per_proc"]) == {"PROC0", "PROC1"}
    assert report["traces"] == 1 and report["reassignment_ms"] > 0
    assert set(report["per_proc"]) == {"PROC0", "PROC1"}


def test_fleet_chrome_export_one_track_group_per_proc():
    _, incs = _two_proc_dump()
    trace = chrome_trace(stitch.stitch(incs)["spans"])
    validate_chrome_trace(trace)
    proc_meta = {
        ev["args"]["name"] for ev in trace["traceEvents"]
        if ev["ph"] == "M" and ev["name"] == "process_name"
    }
    assert proc_meta == {"PROC0", "PROC1"}
    assert len({ev["pid"] for ev in trace["traceEvents"]
                if ev["ph"] == "X"}) == 2
    assert any(ev["ph"] == "s" for ev in trace["traceEvents"])


def test_stitch_of_a_port_recorders_dumps_equals_jax():
    """Real ``fishnet-spans/2`` records from the port's recorder — a batch
    tree in two incarnations and step traces — stitch alike in both
    packages."""
    def dump(unit, extra):
        rec = SpanRecorder()
        root = batch_root(unit)
        t = time.monotonic()
        rec.record("acquire", t, trace=root, batch=unit)
        child = root.child()
        rec.record("schedule", t, trace=child, batch=unit)
        rec.record("queue_wait", t, trace=child.child(), batch=unit)
        step = new_trace()
        rec.record("pack", t, trace=step)
        rec.record("device_step", t, trace=step.child())
        if extra:
            rec.record("submit", t, trace=root.child(), batch=unit)
        return {"spans": rec.spans(), "epoch_offset": rec.epoch_offset}

    first, second = dump("unit-9", False), dump("unit-9", True)
    incs = [dict(first, proc="P0", actor="P0@1"),
            dict(second, proc="P1", actor="P1@2")]
    report = both(lambda m: m.stitch([dict(i) for i in incs]))
    assert report["traces"] == 1 and report["reassignments"] == 1
    assert both(lambda m: m.fleet_report(report["spans"]))["traces"] == 1


# -- the aggregator ------------------------------------------------------------


def _proc_exporter(reqs_ok: int):
    registry = MetricsRegistry()
    counter = registry.counter(
        "fishnet_api_requests_total", "h", labelnames=("endpoint", "outcome"))
    for _ in range(reqs_ok):
        counter.inc(endpoint="acquire", outcome="ok")
    return MetricsExporter(port=0, registry=registry)


def _fams_doc(agg):
    """The federated families as plain data, but the scrape ages (they
    grow with the clock)."""
    return {
        name: sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                     for s in fam.samples)
        for name, fam in agg.federated_families().items()
        if name != "fishnet_fleet_scrape_age_seconds"
    }


def _fleet_doc(agg):
    doc = agg.fleet_doc()
    doc.pop("time")
    for st in doc["procs"].values():
        st.pop("age_s")
    return doc


def test_aggregator_federates_with_proc_labels_and_meta():
    e0, e1 = _proc_exporter(3), _proc_exporter(5)
    aggs = {name: mod.FleetAggregator(targets={"PROC0": e0.url,
                                               "PROC1": e1.url})
            for name, mod in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()
        fams = both(lambda agg: _fams_doc(agg), aggs)
        by_proc = {dict(lb)["proc"]: v
                   for _, lb, v in fams["fishnet_api_requests_total"]}
        assert by_proc == {"PROC0": 3.0, "PROC1": 5.0}
        assert {dict(lb)["proc"]: v
                for _, lb, v in fams["fishnet_fleet_proc_up"]} == {
            "PROC0": 1.0, "PROC1": 1.0}
        assert {dict(lb)["proc"] for _, lb, _ in fams["fishnet_build_info"]} \
            == {"PROC0", "PROC1"}
        assert "fishnet_slo_burn_rate" in fams
        assert all("proc" in dict(lb) for name, rows in fams.items()
                   if not name.startswith(("fishnet_slo_", "fishnet_fleet_procs"))
                   for _, lb, _ in rows)
    finally:
        for agg in aggs.values():
            agg.close()
        e0.close()
        e1.close()


def test_aggregator_keeps_dead_proc_series_marked_stale():
    e0, e1 = _proc_exporter(3), _proc_exporter(5)
    aggs = {name: mod.FleetAggregator(targets={"PROC0": e0.url,
                                               "PROC1": e1.url})
            for name, mod in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()
        e1.close()  # the target stops answering
        for agg in aggs.values():
            agg.poll_once()
        fams = both(lambda agg: _fams_doc(agg), aggs)
        assert {dict(lb)["proc"]: v
                for _, lb, v in fams["fishnet_fleet_proc_up"]} == {
            "PROC0": 1.0, "PROC1": 0.0}
        assert {dict(lb)["proc"]: v
                for _, lb, v in fams["fishnet_api_requests_total"]}[
            "PROC1"] == 5.0
        assert {dict(lb)["proc"]: v for _, lb, v in
                fams["fishnet_fleet_scrape_errors_total"]}["PROC1"] >= 1.0
        docs = {name: _fleet_doc(agg) for name, agg in aggs.items()}
        for doc in docs.values():
            doc["procs"]["PROC1"].pop("last_error")  # the urllib text
        assert docs["torch"] == docs["jax"]
        assert docs["torch"]["procs"]["PROC1"]["up"] is False
        assert aggs["torch"].fleet_doc()["procs"]["PROC1"]["last_error"]
    finally:
        for agg in aggs.values():
            agg.close()
        e0.close()


def test_aggregator_serves_fleet_routes():
    e0 = _proc_exporter(2)
    agg = fleet.FleetAggregator(targets={"PROC0": e0.url})
    srv = agg.serve(0)
    try:
        agg.poll_once()
        doc = json.loads(_get(srv.url + "/fleet"))
        assert doc["procs"]["PROC0"]["up"] is True
        slo_doc = json.loads(_get(srv.url + "/fleet/slo"))
        assert {row["slo"] for row in slo_doc["slo"]} == {
            s.name for s in default_slos()}
        validate_chrome_trace(json.loads(_get(srv.url + "/fleet/trace")))
        # The exporter serves this process's recorder: whatever spans it
        # holds are stitched as PROC0's.
        stitched = json.loads(_get(srv.url + "/fleet/spans"))["spans"]
        assert all(s["proc"] == "PROC0" for s in stitched)
        text = _get(srv.url + "/metrics").decode()
        assert 'proc="PROC0"' in text
        assert "fishnet_fleet_proc_up" in text
        assert "fishnet_slo_burn_rate" in text
        assert "fishnet_fleet_proc_up" in json.loads(
            _get(srv.url + "/json"))["metrics"]
    finally:
        agg.close()
        e0.close()


def test_port_dir_discovery_follows_rewrites(tmp_path):
    e0, e1 = _proc_exporter(1), _proc_exporter(2)
    (tmp_path / "PROC0.port").write_text(f"{e0.port}\n")
    (tmp_path / "junk.port").write_text("not-a-port\n")
    resolvers = {n: m.port_dir_targets(str(tmp_path))
                 for n, m in FLEETS.items()}
    assert both(lambda r: r(), resolvers) == {
        "PROC0": f"http://127.0.0.1:{e0.port}"}
    aggs = {n: m.FleetAggregator(targets_fn=resolvers[n])
            for n, m in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()
        assert both(lambda a: a.fleet_doc()["procs"]["PROC0"]["up"], aggs)
        # A restart rebinds another port and rewrites the file.
        (tmp_path / "PROC0.port").write_text(f"{e1.port}\n")
        for agg in aggs.values():
            agg.poll_once()
        fams = both(lambda a: _fams_doc(a), aggs)
        assert {dict(lb)["proc"]: v
                for _, lb, v in fams["fishnet_api_requests_total"]} == {
            "PROC0": 2.0}
        # The port file disappears: stale, kept.
        (tmp_path / "PROC0.port").unlink()
        for agg in aggs.values():
            agg.poll_once()
        assert both(lambda a: a.fleet_doc()["procs"]["PROC0"]["up"],
                    aggs) is False
    finally:
        for agg in aggs.values():
            agg.close()
        e0.close()
        e1.close()


def test_journal_recovers_spans_lost_to_sigkill(tmp_path):
    """A batch span journaled by the port's recorder reaches the stitcher
    of either aggregator without a scrape, once; step traces are never
    journaled."""
    journal = tmp_path / "PROC0.journal.jsonl"
    rec = SpanRecorder()
    rec.journal_to(str(journal))
    t0 = time.monotonic()
    rec.record("acquire", t0, trace=batch_root("doomed-unit"),
               batch="doomed-unit")
    rec.record("pack", t0, trace=new_trace())
    rec.journal_close()
    lines = journal.read_text().strip().splitlines()
    header = json.loads(lines[0])
    assert header["format"].startswith("fishnet-spans-journal/")
    assert header["pid"] == os.getpid()
    recs = [json.loads(ln) for ln in lines[1:]]
    assert [r["stage"] for r in recs] == ["acquire"]
    assert recs[0] == [s for s in rec.spans() if s["stage"] == "acquire"][0]

    aggs = {n: m.FleetAggregator(targets={}, journal_dir=str(tmp_path))
            for n, m in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()
        stitched = both(lambda a: a.stitched(), aggs)
        acq = [s for s in stitched["spans"] if s["stage"] == "acquire"]
        assert len(acq) == 1
        assert acq[0]["proc"] == "PROC0"
        assert acq[0]["actor"] == f"PROC0@{os.getpid()}"
        assert both(lambda a: _fleet_doc(a), aggs)["procs"]["PROC0"][
            "up"] is False
    finally:
        for agg in aggs.values():
            agg.close()


def test_journal_tolerates_torn_partial_tail(tmp_path):
    journal = tmp_path / "PROC0.journal.jsonl"
    rec = SpanRecorder()
    rec.journal_to(str(journal))
    rec.record("acquire", time.monotonic(), trace=batch_root("unit-a"),
               batch="unit-a")
    rec.journal_close()
    full = journal.read_bytes()
    lines = full.splitlines(keepends=True)
    torn = lines[-1]
    journal.write_bytes(b"".join(lines[:-1]) + torn[: len(torn) // 2])
    aggs = {n: m.FleetAggregator(targets={}, journal_dir=str(tmp_path))
            for n, m in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()
        assert both(lambda a: [s for s in a.stitched()["spans"]
                               if s["stage"] == "acquire"], aggs) == []
        journal.write_bytes(full)
        for agg in aggs.values():
            agg.poll_once()
        assert len(both(lambda a: [s for s in a.stitched()["spans"]
                                   if s["stage"] == "acquire"], aggs)) == 1
    finally:
        for agg in aggs.values():
            agg.close()


def test_journal_truncation_between_polls_resets_cursor(tmp_path):
    journal = tmp_path / "PROC0.journal.jsonl"
    rec = SpanRecorder()
    rec.journal_to(str(journal))
    for i in range(3):
        rec.record("acquire", time.monotonic(), trace=batch_root(f"unit-{i}"),
                   batch=f"unit-{i}")
    rec.journal_close()
    aggs = {n: m.FleetAggregator(targets={}, journal_dir=str(tmp_path))
            for n, m in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()
        assert len(both(lambda a: [s for s in a.stitched()["spans"]
                                   if s["stage"] == "acquire"], aggs)) == 3
        journal.unlink()
        rec2 = SpanRecorder()
        rec2.journal_to(str(journal))
        rec2.record("acquire", time.monotonic(), trace=batch_root("unit-x"),
                    batch="unit-x")
        rec2.journal_close()
        assert journal.stat().st_size < \
            aggs["torch"]._journal_offsets[str(journal)]
        for agg in aggs.values():
            agg.poll_once()
        batches = both(lambda a: sorted(
            s.get("batch") for s in a.stitched()["spans"]
            if s["stage"] == "acquire"), aggs)
        assert "unit-x" in batches
    finally:
        for agg in aggs.values():
            agg.close()


def test_mcts_tree_families_federate_with_proc_labels():
    from fishnet_tpu_torch.models.az_encoding import POLICY_SIZE
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    class _InstantEval:
        def warmup(self, cap):
            pass

        def evaluate(self, planes_u8, n, keys=None):
            return (np.zeros((n, POLICY_SIZE), np.float32),
                    np.zeros(n, np.float32))

        def close(self):
            pass

    start = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
    pool = MctsPool({}, MctsConfig(batch_capacity=32),
                    evaluator=_InstantEval())
    sids = [pool.submit(start, [], 20) for _ in range(2)]
    while pool.active() > 0:
        pool.step()
    for sid in sids:
        pool.harvest(sid)
    pool.close()

    exporter = MetricsExporter(port=0, registry=telemetry.REGISTRY)
    aggs = {n: m.FleetAggregator(targets={"PROC0": exporter.url})
            for n, m in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()
        for agg in aggs.values():
            fams = agg.federated_families()
            for name in ("fishnet_mcts_visits_total",
                         "fishnet_mcts_collisions_total",
                         "fishnet_mcts_subtree_reuse_total",
                         "fishnet_mcts_batch_fill_ratio",
                         "fishnet_mcts_trees_active"):
                assert name in fams and fams[name].samples, name
                assert all(s.labels.get("proc") == "PROC0"
                           for s in fams[name].samples)
            assert sum(s.value for s in
                       fams["fishnet_mcts_visits_total"].samples) >= 40
    finally:
        for agg in aggs.values():
            agg.close()
        exporter.close()


def test_poll_collects_profiles_and_console_renders_hot_stacks():
    e0 = _proc_exporter(1)
    agg = fleet.FleetAggregator(targets={"PROC0": e0.url}, profiles=True)
    try:
        agg.poll_once()
        assert agg.fleet_doc()["procs"]["PROC0"]["up"] is True
        frame = fleet.render_console(agg, profiles=True)
        assert "HOT STACKS" in frame and "profiling off" in frame
        prof = profiler.start(hz=200)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and prof.samples < 5:
            time.sleep(0.02)
        agg.poll_once()
        frame = fleet.render_console(agg, profiles=True)
        assert "samples @" in frame and "profiling off" not in frame
        assert "HOT STACKS" not in fleet.render_console(agg)
    finally:
        profiler.stop()
        agg.close()
        e0.close()


def test_console_frames_equal_jax_and_show_the_control_panel():
    """Both packages' consoles over the same exporter render the same
    frame, clock and age columns aside, control panel included."""
    from fishnet_tpu_torch.control import actuators

    reg = actuators.ActuatorRegistry()
    reg.register(actuators.Actuator("t_console_knob", lambda v: None, lo=1,
                                    hi=8, default=2))
    reg.apply("t_console_knob", 8, window=4)
    exporter = MetricsExporter(port=0, registry=telemetry.REGISTRY)
    aggs = {n: m.FleetAggregator(targets={"PROC0": exporter.url})
            for n, m in FLEETS.items()}
    try:
        for agg in aggs.values():
            agg.poll_once()

        def frame(name):
            lines = FLEETS[name].render_console(
                aggs[name], control=True).splitlines()
            return [" ".join(ln.split()[:2]) if i < 3 else ln
                    for i, ln in enumerate(lines)]

        assert frame("torch") == frame("jax")
        text = "\n".join(frame("torch"))
        assert "CONTROL PLANE" in text and "t_console_knob" in text
        assert "-> 8" in text
    finally:
        for agg in aggs.values():
            agg.close()
        exporter.close()
        reg.close()


def test_fleet_main_once_json_and_console():
    """``python -m fishnet_tpu_torch.telemetry.fleet``: one poll printed
    as the /fleet document, and as a console frame with the control
    panel."""
    e0 = _proc_exporter(4)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "fishnet_tpu_torch.telemetry.fleet"]
    try:
        doc = json.loads(subprocess.run(
            cmd + [f"PROC0={e0.url}", "--once", "--json"], env=env,
            capture_output=True, text=True, timeout=120, check=True).stdout)
        assert doc["procs"]["PROC0"]["up"] is True
        out = subprocess.run(
            cmd + [e0.url, "--once", "--control"], env=env,
            capture_output=True, text=True, timeout=120, check=True).stdout
        assert "proc0" in out and "control plane off" in out
    finally:
        e0.close()


_CHILD = """
import os, sys, time
from fishnet_tpu_torch import telemetry
c = telemetry.REGISTRY.counter("fishnet_api_requests_total", "h",
                               labelnames=("endpoint", "outcome"))
c.inc(7, endpoint="acquire", outcome="ok")
exporter = telemetry.start_exporter(0)
with open(sys.argv[1] + ".tmp", "w") as fp:
    fp.write(str(exporter.port))
os.replace(sys.argv[1] + ".tmp", sys.argv[1])
time.sleep(120)
"""


def test_a_sigkilled_port_process_stays_in_the_federation(tmp_path):
    """A real port process, found through its port file, SIGKILLed: it
    reads up=0 with its last series kept, its scrape age grows, its pid
    is its incarnation, and the aggregator keeps polling."""
    port_file = tmp_path / "CHILD.port"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    child = subprocess.Popen([sys.executable, "-c", _CHILD, str(port_file)],
                             env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    agg = fleet.FleetAggregator(
        targets_fn=fleet.port_dir_targets(str(tmp_path)),
        poll_interval=0.05).start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = agg.fleet_doc()["procs"].get("CHILD")
            if st is not None and st["up"] and st["pids"]:
                break
            time.sleep(0.05)
        st = agg.fleet_doc()["procs"]["CHILD"]
        assert st["up"] and st["pids"] == [child.pid]
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=10)
        deadline = time.monotonic() + 10
        while agg.fleet_doc()["procs"]["CHILD"]["up"] and \
                time.monotonic() < deadline:
            time.sleep(0.05)

        def ages():
            return {s.labels["proc"]: s.value for s in agg.federated_families()[
                "fishnet_fleet_scrape_age_seconds"].samples}

        age0 = ages()["CHILD"]
        time.sleep(0.3)
        fams = agg.federated_families()
        assert {s.labels["proc"]: s.value
                for s in fams["fishnet_fleet_proc_up"].samples} == {
            "CHILD": 0.0}
        assert [s.value for s in fams["fishnet_api_requests_total"].samples
                if s.labels.get("proc") == "CHILD"] == [7.0]
        assert ages()["CHILD"] > age0
        doc = agg.fleet_doc()
        assert doc["procs"]["CHILD"]["errors"] >= 1
        assert doc["procs"]["CHILD"]["pids"] == [child.pid]
    finally:
        agg.close()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
