"""The port's trace export and critical-path analysis
(fishnet_tpu_torch.telemetry.trace_export and .critical_path) against
the JAX package's modules, on the CPU: tests/test_tracing.py's analyzer
and exporter tests, held as equality with the JAX functions.

On the same span lists — synthetic ones (a step trace, fused fan-in
links, orphans, batch traces, fleet ``proc`` fields, seeded random
mixes) and the spans the port's own gated service records — both
packages return equal values from ``chrome_trace``, ``group_traces``,
``orphan_spans``, ``critical_path``, ``attribute_trace``, ``report``
and ``batch_report``; ``validate_chrome_trace`` rejects the same
malformed inputs with the same message; and the CLI writes the JAX
CLI's file from the same dumps."""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fishnet_tpu.telemetry import critical_path as jax_cp
from fishnet_tpu.telemetry import trace_export as jax_te
from fishnet_tpu_torch import telemetry
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.telemetry import critical_path as cp
from fishnet_tpu_torch.telemetry import trace_export as te
from fishnet_tpu_torch.telemetry.spans import FORMAT, RECORDER
from fishnet_tpu_torch.telemetry.tracing import trace_id_for_batch
from tests.test_async_dispatch import _SMOKE_FENS

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def fresh_port_cache():
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


def _mk(stage, t, dur_ms, trace_id=None, span_id=None, parent_id=None,
        thread="t", **extra):
    s = {"stage": stage, "t": t, "dur_ms": dur_ms, "thread": thread}
    if trace_id:
        s["trace_id"] = trace_id
        s["span_id"] = span_id
        if parent_id:
            s["parent_id"] = parent_id
    s.update(extra)
    return s


def _step_trace(base=100.0, tid="T1", durs=(10.0, 2.0, 2.0, 15.0, 15.0,
                                            4.0)):
    """An async step trace: pack -> device_step -> dispatch_issue ->
    dispatch_wait -> wire_decode -> postprocess
    (tests/test_tracing.py's ``_synthetic_step_trace``)."""
    pk, ds, di, dw, wd, pp = durs
    return [
        _mk("pack", base, pk, tid, tid),
        _mk("device_step", base + 0.010, ds, tid, f"{tid}d", tid),
        _mk("dispatch_issue", base + 0.013, di, tid, f"{tid}i", f"{tid}d",
            thread="dispatch-pack"),
        _mk("dispatch_wait", base + 0.015, dw, tid, f"{tid}w", f"{tid}i",
            thread="dispatch-decode"),
        _mk("wire_decode", base + 0.016, wd, tid, f"{tid}wd", f"{tid}w"),
        _mk("postprocess", base + 0.031, pp, tid, f"{tid}pp", f"{tid}wd"),
    ]


def _batch_trace(batch, base, queue_ms=200.0):
    tid = trace_id_for_batch(batch)
    return [
        _mk("acquire", base, 50.0, tid, tid),
        _mk("schedule", base + 0.051, 2.0, tid, f"{tid}s", tid),
        _mk("queue_wait", base + 0.053, queue_ms, tid, f"{tid}q",
            f"{tid}s"),
        _mk("submit", base + 0.3, 40.0, tid, f"{tid}sub", tid),
    ]


def _fan_in():
    """A fused dispatch shared by two step traces: parented under T1,
    linked to T2, plus a coalesce span linking both."""
    return [
        _mk("pack", 0.0, 1.0, "T1", "T1"),
        _mk("pack", 0.0, 1.0, "T2", "T2"),
        _mk("device_step", 0.001, 1.0, "T1", "d1", "T1"),
        _mk("device_step", 0.001, 1.0, "T2", "d2", "T2"),
        _mk("coalesce", 0.0015, 0.5, "T1", "c", "d1", links=[["T2", "d2"]],
            width=2, groups=[0, 1]),
        _mk("dispatch_issue", 0.002, 1.0, "T1", "i", "d1",
            links=[["T2", "d2"]], thread="dispatch-pack"),
        _mk("dispatch_wait", 0.003, 3.0, "T1", "w", "i",
            links=[["T2", "d2"]], thread="dispatch-decode"),
        _mk("wire_decode", 0.0045, 2.0, "T1", "wd1", "d1"),
        _mk("wire_decode", 0.0047, 2.0, "T2", "wd2", "d2"),
    ]


def _orphans():
    return [
        _mk("pack", 0.0, 1.0, "T1", "T1"),
        _mk("device_step", 0.001, 1.0, "T1", "d", "missing-parent"),
        _mk("dispatch_issue", 0.002, 1.0, "T1", "i", "d",
            links=[["T9", "gone"]], thread="dispatch-pack"),
        _mk("cache_probe", 0.0011, 0.1),  # no trace at all
    ]


def _fleet():
    """Spans carrying ``proc`` (a stitched fleet trace): one track group
    a process, and cross-process edges render as flow arrows."""
    tid = trace_id_for_batch("wkfleet")
    return [
        _mk("acquire", 1.0, 50.0, tid, tid, proc="P0"),
        _mk("reassignment", 1.05, 100.0, tid, "r", tid, proc="P1"),
        _mk("queue_wait", 1.16, 30.0, tid, "q", "r", proc="P1"),
        _mk("submit", 1.2, 30.0, tid, "s", tid, proc="P1", thread="u"),
    ]


def _random_spans(seed: int):
    """Seeded mixes: step traces with random durations (some without a
    dispatch pair, some fused with a neighbour), batch traces, and now
    and then an orphan or a span without a trace."""
    rng = np.random.default_rng(seed)
    spans = []
    n = int(rng.integers(3, 12))
    for k in range(n):
        base = 10.0 * k + float(rng.random())
        durs = tuple(float(x) for x in rng.uniform(0.05, 20.0, 6).round(3))
        sp = _step_trace(base, f"S{seed}_{k}", durs)
        if rng.random() < 0.3:
            sp = [s for s in sp if s["stage"] not in ("dispatch_issue",
                                                       "dispatch_wait")]
            sp[-1]["parent_id"] = f"S{seed}_{k}d"
            sp[-2]["parent_id"] = f"S{seed}_{k}d"
        if k and rng.random() < 0.4:
            for s in sp:
                if s["stage"] == "dispatch_issue":
                    s["links"] = [[f"S{seed}_{k - 1}", f"S{seed}_{k - 1}d"]]
        if rng.random() < 0.1:
            sp[1]["parent_id"] = "lost"
        spans += sp
    for k in range(int(rng.integers(0, 4))):
        spans += _batch_trace(f"wk{seed:03d}{k:03d}", 200.0 + k,
                              float(rng.uniform(1, 400)))
    if rng.random() < 0.5:
        spans.append(_mk("cache_probe", 5.0, 0.2))
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


SYNTHETIC = {
    "step": lambda: _step_trace(),
    "two_steps": lambda: _step_trace(100.0, "T1") + _step_trace(200.0, "T2"),
    "fan_in": _fan_in,
    "orphans": _orphans,
    "batch": lambda: _batch_trace("wkA", 0.0),
    "fleet": _fleet,
    "empty": lambda: [],
    **{f"random{seed}": (lambda seed=seed: _random_spans(seed))
       for seed in range(8)},
}


def _equal_everywhere(spans):
    """Every analysis of both packages on (copies of) ``spans``."""
    def both(name, *args, **kw):
        got = getattr(cp if name in dir(cp) else te, name)(
            *copy.deepcopy(args), **kw)
        ref = getattr(jax_cp if name in dir(jax_cp) else jax_te, name)(
            *copy.deepcopy(args), **kw)
        assert got == ref, name
        return got

    trace = both("chrome_trace", spans)
    te.validate_chrome_trace(trace)
    jax_te.validate_chrome_trace(trace)
    both("chrome_trace", spans, pid=7)
    traces = both("group_traces", spans)
    both("orphan_spans", spans)
    for sp in traces.values():
        both("critical_path", sp)
        both("attribute_trace", sp)
        both("attribute_trace", sp, fixed_transport_ms=5.0)
    for kw in ({}, {"skip_warmup": False}, {"fixed_transport_ms": 3.0}):
        both("report", spans, **kw)
    both("batch_report", spans)
    return traces


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_spans_analyse_as_in_jax(case):
    spans = SYNTHETIC[case]()
    traces = _equal_everywhere(spans)
    if case == "fan_in":
        # group_traces re-attaches a copy of the shared spans under T2.
        t2 = {s["stage"]: s for s in traces["T2"]}
        assert t2["dispatch_issue"]["parent_id"] == "d2"
        assert "links" not in t2["dispatch_issue"]
        assert cp.orphan_spans(spans) == []
    if case == "orphans":
        # The lost parent, and the linked copy under a span absent
        # from its trace.
        assert [s["stage"] for s in cp.orphan_spans(spans)] == [
            "device_step", "dispatch_issue"]
    if case == "step":
        attr = cp.attribute_trace(spans, fixed_transport_ms=5.0)
        assert sum(attr[c] for c in cp.COMPONENTS) == pytest.approx(
            attr["wall_ms"], rel=1e-9)
        assert attr["coverage"] == pytest.approx(1.0)
        assert [s["stage"] for s in cp.critical_path(spans)] == [
            "pack", "device_step", "dispatch_issue", "dispatch_wait",
            "wire_decode", "postprocess"]


def test_constants_equal_the_jax_module():
    assert cp.COMPONENTS == jax_cp.COMPONENTS
    assert cp._PRIORITY == jax_cp._PRIORITY
    assert cp._STAGE_COMPONENT == jax_cp._STAGE_COMPONENT


@pytest.fixture(scope="module")
def port_spans():
    """The spans of a gated run of the port's CPU service (4 positions
    at 100 nodes, width pinned to 2 so fused dispatches and their fan-in
    links occur), recorded with telemetry on."""
    from tests.test_torch_tracing import _port_run

    mp = pytest.MonkeyPatch()
    mp.setenv("FISHNET_COALESCE_WIDTH", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.enable()
    try:
        t0 = time.monotonic()
        _port_run(_SMOKE_FENS[:4], 100)
    finally:
        telemetry.disable()
        torch.set_num_threads(threads)
        mp.undo()
    return [s for s in RECORDER.spans() if s["t"] >= t0 - 1e-4]


def test_the_port_service_spans_analyse_as_in_jax(port_spans):
    stages = {s["stage"] for s in port_spans}
    assert {"pack", "device_step", "dispatch_issue", "dispatch_wait",
            "coalesce"} <= stages
    assert any(s.get("links") for s in port_spans)
    traces = _equal_everywhere(port_spans)
    assert len(traces) > 3
    traced = [s for s in port_spans if "trace_id" in s]
    assert cp.orphan_spans(traced) == []
    assert cp.report(traced)["coverage"] >= 0.95
    flows = [e for e in te.chrome_trace(port_spans)["traceEvents"]
             if e["ph"] == "s"]
    assert flows, "no cross-thread flow arrow in the port's trace"


def _malformed(trace):
    """(name, a broken copy of ``trace``) for each rule of the
    validator."""
    def edit(fn):
        bad = json.loads(json.dumps(trace))
        fn(bad)
        return bad

    def first(ph):
        return lambda bad: next(e for e in bad["traceEvents"]
                                if e["ph"] == ph)

    return [
        ("not_a_dict", []),
        ("no_events", {"nope": []}),
        ("events_not_a_list", {"traceEvents": {}}),
        ("event_not_an_object", {"traceEvents": [1]}),
        ("unknown_ph", edit(lambda b: first("X")(b).update(ph="Q"))),
        ("no_tid", edit(lambda b: b["traceEvents"][1].pop("tid"))),
        ("pid_not_int", edit(lambda b: first("X")(b).update(pid="1"))),
        ("bad_metadata", edit(lambda b: first("M")(b).update(name="x"))),
        ("metadata_no_name", edit(lambda b: first("M")(b).update(args={}))),
        ("ts_not_number", edit(lambda b: first("X")(b).update(ts="0"))),
        ("negative_dur", edit(lambda b: first("X")(b).update(dur=-1))),
        ("finish_no_bp", edit(lambda b: first("f")(b).pop("bp"))),
        ("finish_without_start", edit(lambda b: b["traceEvents"].remove(
            first("s")(b)))),
        ("dangling_start", edit(lambda b: b["traceEvents"].remove(
            first("f")(b)))),
    ]


@pytest.mark.parametrize("which", range(14))
def test_validate_rejects_what_jax_rejects(which):
    trace = te.chrome_trace(_step_trace())
    name, bad = _malformed(trace)[which]
    with pytest.raises(ValueError) as ours:
        te.validate_chrome_trace(bad)
    with pytest.raises(ValueError) as theirs:
        jax_te.validate_chrome_trace(bad)
    assert str(ours.value) == str(theirs.value), name


def _write_dump(path, spans, seqs=(1, 2)):
    """Two dumps of the same ring into one file (one header each)."""
    with open(path, "w") as fp:
        for seq in seqs:
            fp.write(json.dumps({
                "format": FORMAT, "seq": seq, "reason": "test", "pid": 1,
                "dumped_at": 0.0, "monotonic_to_epoch": 0.0,
                "spans": len(spans)}) + "\n")
            for s in spans:
                fp.write(json.dumps(s) + "\n")


def test_cli_round_trips_a_dump_as_the_jax_cli(tmp_path, capsys):
    spans = _random_spans(3) + _fan_in()
    one, two = tmp_path / "fishnet-spans-1.jsonl", tmp_path / "b.jsonl"
    _write_dump(one, spans)
    _write_dump(two, spans[:5], seqs=(3,))
    paths = [str(one), str(two)]
    assert te.read_spans(paths) == jax_te.read_spans(paths)
    assert len(te.read_spans(paths)) == len(spans)
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert te.main([*paths, "-o", str(ours)]) == 0
    assert jax_te.main([*paths, "-o", str(theirs)]) == 0
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1].replace(str(theirs), str(ours))
    assert ours.read_text() == theirs.read_text()
    trace = json.loads(ours.read_text())
    te.validate_chrome_trace(trace)
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == len(spans)
    # As a module from the command line, beside nothing of the JAX
    # package.
    out = tmp_path / "cli.json"
    proc = subprocess.run(
        [sys.executable, "-m", "fishnet_tpu_torch.telemetry.trace_export",
         *paths, "-o", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert out.read_text() == theirs.read_text()
    assert proc.stderr.startswith(f"wrote {out}: {len(spans)} spans")
