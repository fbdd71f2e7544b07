"""The port's control plane (fishnet_tpu_torch.control) against the JAX
package's (fishnet_tpu.control), on the CPU.

Every test of tests/test_control.py, each run through both packages on
the same inputs and held equal: signal folding and hysteresis, the
bounded and revertible actuator registry with its escape hatch and its
families, the deterministic ladder probe and rule policy (the same window
sequences give the same actions), the degraded-shard skip, the SLO
engine's ``burn_snapshot`` seam, the subsystems' actuation seams and the
fleet console's control panel. Then what the port adds to check: every
signal source at once, the stage-observer slot shared with the profiler,
the ``control`` span, the speculation pin on the port's AZ plane, the
stock actuators over the port's real subsystems, the shard-scoped
coalesce width on two logical shards and the MCTS leaf-width ceiling
against the JAX service's and pool's, and a controller moving the port's
CPU service's width and depth mid-run: analyses equal the run without it
and the JAX service's, bit for bit.

Every test leaves both packages' process-global planes as it found them:
the stage-observer slot empty, the profiler stopped, the cost ledger off
and empty, the span gate off, the actuator registries closed."""

import asyncio
import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fishnet_tpu.control as jax_control_pkg
import fishnet_tpu_torch.control as control_pkg
from fishnet_tpu import telemetry as jax_telemetry
from fishnet_tpu.control import actuators as jax_actuators
from fishnet_tpu.control import controller as jax_controller
from fishnet_tpu.control import signals as jax_signals
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.resilience import shedding as jax_shedding
from fishnet_tpu.sched import queue as jax_queue
from fishnet_tpu.search import mcts as jax_mcts
from fishnet_tpu.search import service as jax_service
from fishnet_tpu.telemetry import cost as jax_cost
from fishnet_tpu.telemetry import fleet as jax_fleet
from fishnet_tpu.telemetry import profiler as jax_profiler
from fishnet_tpu.telemetry import registry as jax_registry
from fishnet_tpu.telemetry import slo as jax_slo
from fishnet_tpu.telemetry import spans as jax_spans
from fishnet_tpu_torch import telemetry
from fishnet_tpu_torch.control import actuators, controller, signals
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.resilience import shedding
from fishnet_tpu_torch.sched import queue as port_queue
from fishnet_tpu_torch.search import eval_cache, mcts
from fishnet_tpu_torch.search import service as port_service
from fishnet_tpu_torch.search.coalesce import _AsyncDispatchPipeline
from fishnet_tpu_torch.telemetry import cost, fleet, profiler, registry, slo, spans
from tests.test_async_dispatch import _SMOKE_FENS

PKGS = {
    "jax": SimpleNamespace(
        pkg=jax_control_pkg, act=jax_actuators, ctl=jax_controller,
        sig=jax_signals, tel=jax_telemetry, reg=jax_registry, slo=jax_slo,
        spans=jax_spans, cost=jax_cost, prof=jax_profiler, fleet=jax_fleet,
        shed=jax_shedding, queue=jax_queue, mcts=jax_mcts,
    ),
    "torch": SimpleNamespace(
        pkg=control_pkg, act=actuators, ctl=controller, sig=signals,
        tel=telemetry, reg=registry, slo=slo, spans=spans, cost=cost,
        prof=profiler, fleet=fleet, shed=shedding, queue=port_queue,
        mcts=mcts,
    ),
}


def both(fn):
    """``fn(ns)`` through each package; the port's result equals the JAX
    package's and is returned."""
    out = {name: fn(ns) for name, ns in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _planes_off():
    for ns in PKGS.values():
        ns.prof.stop()
        ns.cost.disable()
        ns.cost.reset()
        ns.spans.set_stage_observer(None)
        ns.tel.disable()


@pytest.fixture(autouse=True)
def planes_off(monkeypatch):
    monkeypatch.delenv("FISHNET_NO_CONTROL", raising=False)
    _planes_off()
    yield
    _planes_off()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fam(ns, name, rows, type="counter"):
    fam = ns.reg.MetricFamily(name=name, type=type, help="test fixture")
    for labels, value in rows:
        fam.samples.append(ns.reg.Sample(name=name, value=value, labels=labels))
    return fam


def _sig_doc(sig):
    return dataclasses.asdict(sig)


def _acts(actions):
    return [(a.knob, a.value, a.reason) for a in actions]


def _entry(e):
    if e is None:
        return None
    return (e.seq, e.window, e.knob, e.direction, e.value, e.reason)


# -- signal folding ------------------------------------------------------------


def test_stage_accum_folds_across_threads():
    def run(ns):
        accum = ns.sig._StageAccum()
        accum.observe("pack", 0.010)

        def worker():
            accum.observe("pack", 0.020)
            accum.observe("coalesce", 0.005)

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        return accum.fold()

    folded = both(run)
    assert folded["pack"][0] == pytest.approx(0.030)
    assert folded["pack"][1] == 2.0
    assert folded["coalesce"] == [pytest.approx(0.005), 1.0]


def test_hysteresis_switch_margin_and_hold():
    feed = [
        {"pack": 0.6, "transport": 0.4}, {"pack": 0.46, "transport": 0.54},
        {"pack": 0.3, "transport": 0.7}, {"pack": 0.3, "transport": 0.7},
        {"pack": 0.3, "compute": 0.7}, {"pack": 0.7, "compute": 0.3},
        {"pack": 0.3, "compute": 0.7}, {"pack": 0.3, "compute": 0.7},
    ]

    def run(ns):
        sw = ns.sig.HysteresisSwitch(margin=0.10, hold=2)
        return [sw.update(shares) for shares in feed]

    assert both(run) == [
        "pack", "pack", "pack", "transport",
        "transport", "transport", "transport", "compute",
    ]


def test_collector_window_deltas_and_dominant():
    def run(ns):
        state = {"eval_steps": 0, "evals_shipped": 0, "cache_prewire_hits": 0}
        col = ns.sig.SignalCollector(counters_fn=lambda: dict(state))
        col.feed("dispatch_issue", 0.200)
        col.feed("coalesce", 0.100)
        col.feed("wire_decode", 0.050)
        state.update(eval_steps=40, evals_shipped=10, cache_prewire_hits=8)
        out = [_sig_doc(col.sample())]
        col.feed("dispatch_issue", 0.010)
        state.update(eval_steps=55)
        out.append(_sig_doc(col.sample()))
        out.append(_sig_doc(col.sample()))
        return out

    sig, sig2, sig3 = both(run)
    assert sig["window"] == 1
    assert sig["components"]["transport"] == pytest.approx(300.0)
    assert sig["components"]["decode_wait"] == pytest.approx(50.0)
    assert sig["dominant"] == "transport"
    assert sig["counters"]["eval_steps"] == 40.0
    assert sig["cache_hit_rate"] == pytest.approx(0.8)
    assert sig2["window"] == 2
    assert sig2["components"]["transport"] == pytest.approx(10.0)
    assert sig2["components"]["decode_wait"] == 0.0
    assert sig2["counters"]["eval_steps"] == 15.0
    assert sig3["dominant"] == "transport"
    assert sig3["dominant_share"] == 0.0


def test_collector_baselines_shard_rungs():
    def run(ns):
        report = {"rung_index": [1, 1], "occupancy": [0.5, 0.5]}
        svc = SimpleNamespace(
            shard_report=lambda: {k: list(v) for k, v in report.items()},
            counters=lambda: {},
        )
        col = ns.sig.SignalCollector(service=svc)
        out = []
        for idx in ([1, 1], [1, 3], [0, 1], [1, 1]):
            report["rung_index"] = idx
            out.append(col.sample().shard_rungs)
        return out

    assert both(run) == [[0, 0], [0, 2], [0, 0], [1, 0]]


class _FeedSlo:
    """An SLO engine whose burn snapshots come from a fixed family feed
    (the collector calls ``burn_snapshot()`` with no arguments)."""

    def __init__(self, ns, feed):
        self._eng = ns.slo.SLOEngine(slos=[ns.slo.SLO(
            name="t_success", description="test", objective=0.99,
            total=ns.slo.Selector("t_requests_total"),
            bad=ns.slo.Selector("t_requests_total", {"outcome": "error"}),
        )], windows=(60.0, 300.0))
        self._feed = list(feed)
        self._now = 0.0

    def burn_snapshot(self):
        fams = self._feed.pop(0)
        self._now += 30.0
        return self._eng.burn_snapshot(families=fams, now=self._now)


class _AzCounters:
    def __init__(self, seq):
        self._seq = list(seq)

    def counters(self):
        return self._seq.pop(0)


def test_signals_equal_over_every_source():
    """Every source at once — stage feed, service counters and shard
    report, the AZ plane's fill, an SLO engine, the cost books, the
    lanes' depths — gives the same windows in both packages."""
    def run(ns):
        counters = [
            {"eval_steps": 10, "evals_shipped": 20, "tt_eval_hits": 4,
             "cache_prewire_hits": 2, "decode_queue": 3,
             "inflight_dispatches": 2, "dispatches": 5},
            {"eval_steps": 30, "evals_shipped": 50, "tt_eval_hits": 10,
             "cache_prewire_hits": 9, "decode_queue": 0,
             "inflight_dispatches": 1, "dispatches": 12},
            {"eval_steps": 31, "evals_shipped": 50, "tt_eval_hits": 10,
             "cache_prewire_hits": 9, "decode_queue": 1,
             "inflight_dispatches": 0, "dispatches": 12},
        ]
        reports = [
            {"occupancy": [0.25, 0.75], "rung_index": [0, 0]},
            {"occupancy": [0.5, 0.5], "rung_index": [0, 1]},
            {"occupancy": [1.0, 0.0], "rung_index": [0, 0]},
        ]
        svc = SimpleNamespace(
            counters=lambda: counters.pop(0),
            shard_report=lambda: reports.pop(0),
        )
        plane = _AzCounters([
            {"rows_dispatched": 90, "slots_dispatched": 100, "pad_rows": 10,
             "spec_rows": 4, "speculation_budget": 32},
            {"rows_dispatched": 90, "slots_dispatched": 100, "pad_rows": 10,
             "spec_rows": 4, "speculation_budget": 0},
            {"rows_dispatched": 130, "slots_dispatched": 200, "pad_rows": 70,
             "spec_rows": 6, "speculation_budget": 0},
        ])
        ok = lambda good, bad: {"t_requests_total": _fam(ns, "t_requests_total", [  # noqa: E731
            ({"outcome": "ok"}, good), ({"outcome": "error"}, bad)])}
        slo_eng = _FeedSlo(ns, [ok(100, 0), ok(150, 50), ok(400, 50)])
        sched = ns.queue.LaneScheduler(quantum=2)
        for i in range(3):
            sched.push(SimpleNamespace(work=SimpleNamespace(id="a"),
                                       position_id=i), "a",
                       ns.shed.LANE_THROUGHPUT)
        ns.cost.enable()
        col = ns.sig.SignalCollector(
            service=svc, slo_engine=slo_eng, scheduler=sched, az_plane=plane,
            margin=0.1, hold=1,
        )
        out = []
        books = [
            [((("hog", "analysis"), 3),), ((("meek", "analysis"), 1),)],
            [((("meek", "analysis"), 4),)],
            [],
        ]
        stages = [
            [("pack", 0.004), ("dispatch_issue", 0.002), ("wire_decode", 0.001)],
            [("dispatch_wait", 0.020), ("queue_wait", 0.001), ("submit", 0.003)],
            [("device_step", 0.001), ("coalesce", 0.030), ("other", 1.0)],
        ]
        for window in range(3):
            for owners in books[window]:
                ns.cost.LEDGER.note_dispatch(
                    list(owners), sum(c for _, c in owners), 64, 0.004)
            for stage, dur in stages[window]:
                col.feed(stage, dur)
            out.append(_sig_doc(col.sample()))
        return out

    w1, w2, w3 = both(run)
    assert w1["counters"]["dispatch_fill"] == pytest.approx(0.9)
    assert "dispatch_fill" not in w2["counters"]  # a quiet window
    assert w3["counters"]["dispatch_fill"] == pytest.approx(0.4)
    assert w1["counters"]["decode_queue"] == 3.0  # a level, not a delta
    assert w1["slo_status"] == {"t_success": "ok"}
    assert w2["slo_status"] == {"t_success": "breach"}
    assert set(w1["tenant_cost_share"]) == {"hog", "meek"}
    assert w2["tenant_cost_share"] == {"hog": 0.0, "meek": 1.0}
    assert w3["tenant_cost_share"] == {}
    assert w1["queue_depths"] and w2["shard_rungs"] == [0, 1]
    assert [w["dominant"] for w in (w1, w2, w3)] == [
        "pack", "compute", "transport"]


# -- the actuator registry -----------------------------------------------------


def test_registry_clamps_scalar_pair_and_map():
    def run(ns):
        calls = []
        reg = ns.act.ActuatorRegistry()
        try:
            reg.register_all([
                ns.act.Actuator("width", lambda v: calls.append(("width", v)),
                                lo=1, hi=8, default=2),
                ns.act.Actuator("marks", lambda v: calls.append(("marks", v)),
                                lo=32, hi=4096, default=(256, 128)),
                ns.act.Actuator("weights",
                                lambda v: calls.append(("weights", v)),
                                lo=0.25, hi=4.0, default={}),
            ])
            values = [
                reg.apply("width", 64).value, reg.apply("width", -3).value,
                reg.apply("marks", (8192, 8)).value,
                reg.apply("weights", {"a": 9.0, "b": 0.01}).value,
            ]
            noops = (reg.apply("nope", 1), reg.apply("width", 1))
            return values, calls, noops
        finally:
            reg.close()

    values, calls, noops = both(run)
    assert values == [8, 1, (4096, 32), {"a": 4.0, "b": 0.25}]
    assert calls == [
        ("width", 8), ("width", 1),
        ("marks", (4096, 32)), ("weights", {"a": 4.0, "b": 0.25}),
    ]
    assert noops == (None, None)


def test_registry_revert_restores_default():
    def run(ns):
        seen = []
        reg = ns.act.ActuatorRegistry()
        try:
            reg.register(ns.act.Actuator("depth", seen.append, lo=1, hi=4,
                                         default=2))
            first = reg.revert("depth")
            entry = _entry(reg.apply("depth", 4, reason="test", window=7))
            back = _entry(reg.revert("depth"))
            again = reg.revert("depth")
            return (first, entry, back, again, seen,
                    [e.knob for e in reg.recent()])
        finally:
            reg.close()

    first, entry, back, again, seen, recent = both(run)
    assert first is None and again is None
    assert (entry[3], entry[1]) == ("up", 7)
    assert back[3] == "revert"
    assert seen == [4, 2]
    assert recent == ["depth", "depth"]


def test_escape_hatch_refuses_apply_but_reverts(monkeypatch):
    def run(ns):
        seen = []
        reg = ns.act.ActuatorRegistry()
        try:
            reg.register(ns.act.Actuator("width", seen.append, lo=1, hi=8,
                                         default=2))
            monkeypatch.delenv("FISHNET_NO_CONTROL", raising=False)
            on = ns.pkg.control_enabled()
            reg.apply("width", 8)
            monkeypatch.setenv(ns.pkg.NO_CONTROL_ENV, "1")
            off = ns.pkg.control_enabled()
            refused = reg.apply("width", 4)
            after_refusal = list(seen)
            reverted = reg.revert_all()[0].value
            return on, off, refused, after_refusal, reverted, seen
        finally:
            monkeypatch.delenv("FISHNET_NO_CONTROL", raising=False)
            reg.close()

    assert both(run) == (True, False, None, [8], 2, [8, 2])


def test_actuation_log_rides_the_metrics_registry():
    def run(ns):
        reg = ns.act.ActuatorRegistry()
        reg.register(ns.act.Actuator("t_log_knob", lambda v: None, lo=1,
                                     hi=8, default=1))
        reg.apply("t_log_knob", 4, window=3)

        def log_samples():
            return [(s.value, dict(s.labels))
                    for fam in ns.tel.REGISTRY.collect()
                    if fam.name == "fishnet_control_actuation_log"
                    for s in fam.samples
                    if s.labels.get("knob") == "t_log_knob"]

        rows = log_samples()
        fams = {f.name: f for f in ns.tel.REGISTRY.collect()}
        counted = any(
            s.labels.get("knob") == "t_log_knob"
            and s.labels.get("direction") == "up" and s.value >= 1.0
            for s in fams["fishnet_control_actuations_total"].samples)
        knob = [s.value for s in fams["fishnet_control_knob_value"].samples
                if s.labels == {"knob": "t_log_knob"}]
        reg.close()
        return rows, counted, knob, log_samples()

    rows, counted, knob, after_close = both(run)
    assert len(rows) == 1
    value, labels = rows[0]
    assert value == 3.0  # the value carries the signal window
    assert labels["direction"] == "up" and labels["to"] == "4"
    assert counted and knob == [4.0]
    assert after_close == []  # close() unhooks the pull collector


def test_control_span_stage_registered():
    assert both(lambda ns: "control" in ns.spans.EVENT_STAGES)


def _spans_since(recorder, t0):
    return [s for s in recorder.spans() if s["t"] >= round(t0, 6) - 1e-6]


def test_an_actuation_records_a_control_span_when_telemetry_is_on(
        monkeypatch):
    """The ``control`` site: gated on the telemetry flag like every span
    site, one span an actuation (a revert too), with the JAX package's
    fields. Each package records into a recorder of its own here, so the
    process-wide recorders keep nothing of this test."""
    def run(ns):
        recorder = ns.spans.SpanRecorder()
        monkeypatch.setattr(ns.act, "_SPANS", recorder)
        reg = ns.act.ActuatorRegistry()
        try:
            reg.register(ns.act.Actuator("t_span_knob", lambda v: None, lo=1,
                                         hi=8, default=2))
            t0 = time.monotonic()
            reg.apply("t_span_knob", 4, reason="off", window=1)
            quiet = [s for s in _spans_since(recorder, t0)
                     if s["stage"] == "control"]
            ns.tel.enable()
            try:
                reg.apply("t_span_knob", 8, reason="why", window=2)
                reg.revert("t_span_knob")
            finally:
                ns.tel.disable()
            got = [s for s in _spans_since(recorder, t0)
                   if s["stage"] == "control"]
            drop = ("t", "dur_ms", "thread", "trace_id", "span_id", "seq")
            return quiet, [{k: v for k, v in s.items() if k not in drop}
                           for s in got], all("trace_id" in s for s in got)
        finally:
            reg.close()

    quiet, got, traced = both(run)
    assert quiet == [] and traced
    assert got == [
        {"stage": "control", "knob": "t_span_knob", "direction": "up",
         "value": "8", "window": 2, "reason": "why"},
        {"stage": "control", "knob": "t_span_knob", "direction": "revert",
         "value": "2", "window": 0, "reason": "revert"},
    ]


# -- the ladder probe ----------------------------------------------------------


def test_ladder_probe_index_of():
    def run(ns):
        probe = ns.ctl.LadderProbe()
        return (probe.ladder, ns.ctl.WIDTH_LADDER,
                [probe.index_of(v) for v in (1, 8, 3, 100)])

    ladder, width_ladder, idx = both(run)
    assert ladder == width_ladder == (1, 2, 4, 8)
    assert idx == [0, 3, 1, 3]


def _probe_feed(ns, feed, **kwargs):
    probe = ns.ctl.LadderProbe(**kwargs)
    return [probe.update(idx, score) for idx, score in feed]


def test_ladder_probe_keeps_improvements_and_narrows_first():
    feed = [(2, 10.0), (2, 10.0), (1, 12.0), (1, 12.0), (1, 12.0), (1, 12.0)]
    assert both(lambda ns: _probe_feed(ns, feed, settle=2, min_gain=0.05)) \
        == [None, (1, "trial"), None, None, None, (0, "trial")]


def test_ladder_probe_reverts_and_backs_off_on_regression():
    feed = [(1, 10.0), (0, 8.0), (1, 10.0), (1, 10.0), (2, 5.0), (1, 10.0),
            (1, 10.0), (1, 10.0)]
    assert both(lambda ns: _probe_feed(ns, feed, settle=1, min_gain=0.05,
                                       max_hold=4)) == [
        (0, "trial"), (1, "revert"), None, (2, "trial"), (1, "revert"),
        None, None, (0, "trial")]


def test_ladder_probe_edge_rungs_flip_direction():
    assert both(lambda ns: _probe_feed(ns, [(0, 10.0)], settle=1)) == [
        (1, "trial")]


# -- the rule policy: decision tables ------------------------------------------


def _sig(ns, window, dominant=None, share=0.0, counters=None, slo=None,
         cost=None, hit=0.0):
    sig = ns.sig.ControlSignals(window=window)
    sig.dominant = dominant
    sig.dominant_share = share
    sig.counters = dict(counters or {})
    sig.slo_status = dict(slo or {})
    sig.tenant_cost_share = dict(cost or {})
    sig.cache_hit_rate = hit
    return sig


def _width_schedule(ns):
    policy = ns.ctl.RuleProbePolicy()
    policy.width_probe = ns.ctl.LadderProbe(settle=2, min_gain=0.05)
    knobs = {"coalesce_width": 4, "pipeline_depth": None}
    out = []
    for w, score in enumerate([10.0, 10.0, 8.0, 8.0, 10.0, 10.0], start=1):
        sig = _sig(ns, w, dominant="transport", share=0.9,
                   counters={"eval_steps": score})
        actions = policy.decide(sig, dict(knobs))
        for a in actions:
            knobs[a.knob] = a.value
        out.append(tuple(_acts(actions)))
    return out


def test_policy_width_probe_decision_table():
    table = both(_width_schedule)
    assert table[0] == ()
    assert table[1] == (("coalesce_width", 2,
                         "transport-dominated (90%): probe trial"),)
    assert table[3] == ((
        "coalesce_width", 4,
        "transport-dominated (90%): trial regressed, step back"),)
    assert table[2] == table[4] == table[5] == ()
    assert table == both(_width_schedule)


def test_policy_decode_queue_deepens_pipeline():
    def run(ns):
        policy = ns.ctl.RuleProbePolicy()
        sig = _sig(ns, 1, counters={"decode_queue": 3.0, "eval_steps": 5.0})
        return (_acts(policy.decide(sig, {"pipeline_depth": 2})),
                _acts(policy.decide(sig, {"pipeline_depth": 4})))

    deepen, capped = both(run)
    assert deepen == [("pipeline_depth", 3,
                       "standing decode queue: deepen the async pipeline")]
    assert capped == []


def test_policy_slo_burn_tightens_and_downweights():
    def run(ns):
        policy = ns.ctl.RuleProbePolicy()
        hot = policy.decide(
            _sig(ns, 1, slo={"move_latency": "burning"},
                 cost={"hog": 0.8, "meek": 0.2}),
            {"shed_watermark": (256, 128), "tenant_weights": {}})
        calm = policy.decide(
            _sig(ns, 2, slo={"x": "breach"}, cost={"a": 0.5, "b": 0.5}),
            {"shed_watermark": (64, 32), "tenant_weights": {}})
        return _acts(hot), _acts(calm)

    hot, calm = both(run)
    moves = [(k, v) for k, v, _ in hot]
    assert ("shed_watermark", (128, 64)) in moves
    assert ("tenant_weights", {"hog": 0.5}) in moves
    assert calm == []


def test_policy_prefetch_pin_unpin():
    def run(ns):
        policy = ns.ctl.RuleProbePolicy()
        live = {"eval_steps": 10.0}
        return [_acts(policy.decide(_sig(ns, w, counters=live, hit=hit),
                                    {"prefetch_budget": pinned}))
                for w, hit, pinned in ((1, 0.7, None), (2, 0.1, 0),
                                       (3, 0.5, 0))]

    assert both(run) == [
        [("prefetch_budget", 0, "cache hot (70%): pin prefetch off")],
        [("prefetch_budget", None,
          "cache cold (10%): restore adaptive prefetch")],
        [],
    ]


def test_policy_calm_stepback_waits_for_quiescence():
    def run(ns):
        policy = ns.ctl.RuleProbePolicy(calm_hold=3)
        knobs = {"coalesce_width": 2, "pipeline_depth": None,
                 "prefetch_budget": 0}
        out = []
        for w in range(1, 7):
            counters = {"eval_steps": 4.0} if w == 3 else None
            out.append(_acts(policy.decide(
                _sig(ns, w, counters=counters, hit=0.5), knobs)))
        return out

    assert both(run) == [[], [], [], [], [], [
        ("coalesce_width", None, "calm for 3 windows: step back")]]


# -- the controller: the degraded-shard skip -----------------------------------


class _Feed:
    """A stub collector replaying crafted windows."""

    def __init__(self, sigs):
        self._sigs = list(sigs)

    def sample(self):
        return self._sigs.pop(0)


class _Fixed:
    def __init__(self, actions):
        self._actions = list(actions)

    def decide(self, sig, knobs):
        return list(self._actions)


def test_controller_skips_degraded_shards():
    def run(ns):
        calls = []

        def setter(value, shards=None):
            calls.append((value, shards))

        sigs = []
        for rungs in ([0, 0], [0, 1], [2, 1]):
            sig = ns.sig.ControlSignals(window=len(sigs) + 1)
            sig.shard_rungs = list(rungs)
            sigs.append(sig)
        reg = ns.act.ActuatorRegistry()
        try:
            reg.register(ns.act.Actuator("coalesce_width", setter, lo=1, hi=8,
                                         default=None, shard_scoped=True))
            ctrl = ns.ctl.Controller(_Feed(sigs), reg, policy=_Fixed(
                [ns.ctl.Action("coalesce_width", 8, "test")]))
            steps = [len(ctrl.step()) for _ in range(3)]
            return steps, calls, ctrl.last_signals.shard_rungs
        finally:
            reg.close()

    assert both(run) == ([1, 1, 0], [(8, None), (8, [0])], [2, 1])


# -- the SLO engine's burn_snapshot seam ---------------------------------------


def test_burn_snapshot_statuses_from_synthetic_families():
    def run(ns):
        eng = ns.slo.SLOEngine(slos=[ns.slo.SLO(
            name="t_success", description="test", objective=0.99,
            total=ns.slo.Selector("t_requests_total"),
            bad=ns.slo.Selector("t_requests_total", {"outcome": "error"}),
        )], windows=(60.0, 300.0))
        first = eng.burn_snapshot(families={"t_requests_total": _fam(
            ns, "t_requests_total", [({"outcome": "ok"}, 100.0)])}, now=0.0)
        hot = eng.burn_snapshot(families={"t_requests_total": _fam(
            ns, "t_requests_total", [({"outcome": "ok"}, 150.0),
                                     ({"outcome": "error"}, 50.0)])},
            now=30.0)
        return first, hot

    first, hot = both(run)
    assert set(first) == {"t_success"}
    assert first["t_success"]["status"] == "ok"
    assert hot["t_success"]["status"] == "breach"
    assert all(b > 1.0 for b in hot["t_success"]["windows"].values())


def test_burn_snapshot_defaults_to_local_registry():
    """Each package's engine reads its own process registry; the SLO
    names and statuses agree (no traffic: nothing burns)."""
    def run(ns):
        snap = ns.slo.SLOEngine().burn_snapshot()
        return {name: entry["status"] for name, entry in snap.items()}

    snap = both(run)
    assert "move_latency" in snap and "api_success" in snap
    assert set(snap.values()) <= {"ok", "burning", "breach"}


# -- the subsystems' actuation seams -------------------------------------------


def test_shed_policy_set_watermarks():
    def run(ns):
        shed = ns.shed.ShedPolicy(high_watermark=256)
        out = [(shed.high_watermark, shed.low_watermark)]
        for value in ((128, 64), 512, (100, 400)):
            shed.set_watermarks(value)
            out.append((shed.high_watermark, shed.low_watermark))
        return out

    assert both(run) == [(256, 128), (128, 64), (512, 256), (100, 100)]


def test_lane_scheduler_tenant_weights_reshape_refill():
    def drain_order(ns, weights):
        sched = ns.queue.LaneScheduler(quantum=2)
        for i in range(4):
            for tenant in ("a", "b"):
                sched.push(SimpleNamespace(work=SimpleNamespace(id=tenant),
                                           position_id=i),
                           tenant, ns.shed.LANE_THROUGHPUT)
        sched.set_tenant_weights(weights)
        assert sched.tenant_weights() == (weights or {})
        return [sched.pop().work.id for _ in range(8)]

    assert both(lambda ns: drain_order(ns, None)) == ["a", "a", "b", "b"] * 2
    assert both(lambda ns: drain_order(ns, {"a": 2.0})) == [
        "a", "a", "a", "a", "b", "b", "b", "b"]
    assert both(lambda ns: drain_order(ns, {"a": 0.5})) == [
        "a", "b", "b", "a", "b", "b", "a", "a"]


def test_standard_actuators_bind_fake_subsystems():
    def run(ns):
        svc = SimpleNamespace(
            set_coalesce_width=lambda v, shards=None: None,
            coalesce_width=lambda: 4,
            set_async_depth=lambda v: None, async_depth=lambda: 2,
            set_prefetch=lambda v, adaptive=True: None,
        )
        shed = SimpleNamespace(high_watermark=256, low_watermark=128,
                               set_watermarks=lambda pair: None)
        pool = SimpleNamespace(leaf_width_max=lambda: 16,
                               set_leaf_width_max=lambda v: None)
        sched = SimpleNamespace(set_tenant_weights=lambda w: None,
                                tenant_weights=lambda: {})
        acts = {a.name: a for a in ns.ctl.standard_actuators(
            service=svc, shed_policy=shed, mcts_pool=pool, scheduler=sched)}
        rows = {n: (a.lo, a.hi, a.default, a.shard_scoped)
                for n, a in acts.items()}
        reg = ns.act.ActuatorRegistry()
        try:
            reg.register_all(acts.values())
            return rows, reg.snapshot()
        finally:
            reg.close()

    rows, snap = both(run)
    assert set(rows) == {
        "coalesce_width", "pipeline_depth", "prefetch_budget",
        "shed_watermark", "mcts_leaf_max", "tenant_weights",
    }
    assert rows["coalesce_width"][3]
    assert rows["pipeline_depth"][2] == 2
    assert rows["shed_watermark"][2] == (256, 128)
    assert rows["mcts_leaf_max"][2] == 16
    assert snap["coalesce_width"] == 4  # the live getter, not the default
    assert snap["tenant_weights"] == {}


class _InstantEval:
    """An evaluator answering zeros at once (a uniform prior)."""

    def __init__(self, policy_size):
        self._size = policy_size

    def warmup(self, cap):
        pass

    def evaluate(self, planes_u8, n, keys=None):
        return (np.zeros((n, self._size), np.float32),
                np.zeros(n, np.float32))

    def close(self):
        pass


STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
OPENINGS = [[], ["e2e4"], ["d2d4"], ["g1f3"], ["e2e4", "c7c5"],
            ["e2e4", "e7e5"]]


def _pool(ns):
    from fishnet_tpu.models import az_encoding as jax_encoding
    from fishnet_tpu_torch.models import az_encoding

    enc = az_encoding if ns is PKGS["torch"] else jax_encoding
    cfg = ns.mcts.MctsConfig(batch_capacity=32, leaves_per_step=2,
                             leaves_per_step_max=32)
    return ns.mcts.MctsPool({}, cfg, evaluator=_InstantEval(enc.POLICY_SIZE))


def test_mcts_leaf_width_ceiling_equals_jax():
    """The seam the ``mcts_leaf_max`` actuator drives: on the same seeded
    roots, the pool's config and every live and reused tree's width
    after the same calls equal the JAX pool's."""
    def run(ns):
        pool = _pool(ns)
        try:
            out = [pool.leaf_width_max()]
            sids = [pool.submit(STARTPOS, list(m), 1000)
                    for m in OPENINGS[:4]]
            for _ in range(30):
                pool.step()

            def widths():
                return ([s.leaf_width for _, s in sorted(
                    pool._searches.items())],
                    [s.leaf_width for s in pool._reuse.values()])

            out.append(widths())
            pool.set_leaf_width_max(3)
            out.append((pool.leaf_width_max(), pool.cfg.leaves_per_step_max,
                        widths(), all(s.cfg is pool.cfg
                                      for s in pool._searches.values())))
            pool.set_leaf_width_max(1)  # below leaves_per_step: clamps there
            out.append((pool.leaf_width_max(), widths()))
            while pool.active() > 0:
                pool.step()
            results = [pool.harvest(sid) for sid in sids]
            out.append([(r.best_move, r.visits) for r in results])
            pool.set_leaf_width_max(0)  # the reused trees take it too
            out.append((pool.leaf_width_max(), widths()))
            pool.set_leaf_width_max(32)
            out.append(dataclasses.asdict(pool.cfg) == dataclasses.asdict(
                _pool(ns).cfg))
            return out
        finally:
            pool.close()

    out = both(run)
    assert out[0] == 32
    assert max(out[1][0]) > 3  # the AIMD had widened some trees
    assert out[2][0] == out[2][1] == 3 and out[2][3]
    assert all(w <= 3 for w in out[2][2][0])
    assert out[3][0] == 1 and all(w <= 2 for w in out[3][1][0])
    assert out[5][0] == 1 and out[5][1][1]
    assert all(w <= 2 for w in out[5][1][1])
    assert out[6]


def test_standard_actuators_over_the_ports_subsystems():
    """The stock set over each package's real shed policy, lane scheduler
    and MCTS pool: moves land in the subsystem, revert_all restores the
    bind-time values, and the log and snapshots agree."""
    def run(ns):
        shed = ns.shed.ShedPolicy(high_watermark=256)
        sched = ns.queue.LaneScheduler(quantum=2)
        pool = _pool(ns)
        reg = ns.act.ActuatorRegistry()
        try:
            reg.register_all(ns.ctl.standard_actuators(
                shed_policy=shed, mcts_pool=pool, scheduler=sched))
            snaps = [reg.snapshot()]
            log = [_entry(reg.apply("shed_watermark", (100000, 1), window=1)),
                   _entry(reg.apply("mcts_leaf_max", 4, window=2)),
                   _entry(reg.apply("tenant_weights", {"a": 9.0}, window=3))]
            snaps.append(reg.snapshot())
            moved = ((shed.high_watermark, shed.low_watermark),
                     pool.leaf_width_max(), sched.tenant_weights())
            log += [_entry(e) for e in reg.revert_all()]
            snaps.append(reg.snapshot())
            back = ((shed.high_watermark, shed.low_watermark),
                    pool.leaf_width_max(), sched.tenant_weights())
            return snaps, log, moved, back
        finally:
            reg.close()
            pool.close()

    snaps, log, moved, back = both(run)
    assert moved == ((4096, 32), 4, {"a": 4.0})
    assert back == ((256, 128), 32, {})
    assert snaps[0] == snaps[2]
    assert [e[3] for e in log] == ["up", "down", "up",
                                   "revert", "revert", "revert"]


class _FakePlane:
    """tests/test_bounds_plane.py's plane stand-in for the JAX side."""

    def __init__(self, budget):
        self._b = budget

    def speculation_budget(self):
        return self._b

    def set_speculation_budget(self, b):
        self._b = max(0, int(b))


def test_speculation_pin_unpin_on_the_ports_plane():
    """tests/test_bounds_plane.py's controller pin: dispatch fill above
    SPECULATION_PIN pins the budget to 0, back under SPECULATION_UNPIN
    restores the bind-time budget, and revert_all restores it from a pin
    too — on the port's real AZ plane, with the JAX package's actions on
    its stand-in."""
    from fishnet_tpu_torch.models.az import AzConfig, init_az_params
    from fishnet_tpu_torch.search.az_plane import AzDispatchPlane

    tiny = AzConfig(channels=16, blocks=2, value_hidden=16)
    port_plane = AzDispatchPlane(init_az_params(3, tiny),
                                 mcts.MctsConfig(batch_capacity=64, az=tiny),
                                 device="cpu")
    try:
        planes = {"jax": _FakePlane(port_plane.speculation_budget()),
                  "torch": port_plane}

        def run(ns):
            plane = planes["torch" if ns is PKGS["torch"] else "jax"]
            reg = ns.act.ActuatorRegistry()
            try:
                reg.register_all(ns.ctl.standard_actuators(az_plane=plane))
                pol = ns.ctl.RuleProbePolicy()

                def sig(fill):
                    s = ns.sig.ControlSignals(window=1)
                    s.counters = {"eval_steps": 5.0}
                    if fill is not None:
                        s.counters["dispatch_fill"] = fill
                    return s

                out = []
                for fill in (0.95, 0.7, None, 0.3):
                    acts = pol.decide(sig(fill), reg.snapshot())
                    out.append([(a.knob, a.value) for a in acts])
                    for a in acts:
                        if a.value is None:
                            reg.revert(a.knob)
                        else:
                            reg.apply(a.knob, a.value)
                    out.append(plane.speculation_budget())
                reg.apply("speculation_budget", 0)
                out.append(plane.speculation_budget())
                reg.revert_all()
                out.append(plane.speculation_budget())
                return out
            finally:
                reg.close()

        out = both(run)
    finally:
        port_plane.close()
    b0 = out[-1]
    assert b0 > 0
    assert out == [[("speculation_budget", 0)], 0, [], 0, [], 0,
                   [("speculation_budget", None)], b0, 0, b0]


def test_attach_chains_the_profilers_observer_and_detach_gives_it_back():
    """The span recorder has one stage-observer slot: a collector attached
    after the profiler chains it (both see every span), and its detach
    gives the slot back to the profiler's observer. The spans go to a
    recorder of the test's own (the slot is the module's, whichever
    recorder records)."""
    def run(ns):
        ns.prof.start(hz=5)
        try:
            prof_obs = ns.spans.STAGE_OBSERVER
            col = ns.sig.SignalCollector().attach()
            chained = ns.spans.STAGE_OBSERVER is not prof_obs
            recorder = ns.spans.SpanRecorder()
            recorder.record("dispatch_issue", time.monotonic())
            recorder.record("wire_decode", time.monotonic())
            folded = {k: v[1] for k, v in col._accum.fold().items()}
            hist = {q for q in ns.prof.stage_quantiles()}
            col.detach()
            restored = ns.spans.STAGE_OBSERVER is prof_obs
        finally:
            ns.prof.stop()
        return chained, folded, {"dispatch_issue", "wire_decode"} <= hist, \
            restored, ns.spans.STAGE_OBSERVER is None

    assert both(run) == (True, {"dispatch_issue": 1.0, "wire_decode": 1.0},
                         True, True, True)


# -- the fleet console's control panel -----------------------------------------


def test_fleet_control_panel_renders_log():
    def run(ns):
        st = SimpleNamespace(profile=None, families={
            "fishnet_control_actuations_total": _fam(
                ns, "fishnet_control_actuations_total",
                [({"knob": "coalesce_width", "direction": "down"}, 3.0),
                 ({"knob": "pipeline_depth", "direction": "up"}, 2.0)]),
            "fishnet_control_actuation_log": _fam(
                ns, "fishnet_control_actuation_log",
                [({"seq": "2", "knob": "pipeline_depth", "direction": "up",
                   "to": "3"}, 12.0),
                 ({"seq": "1", "knob": "coalesce_width", "direction": "down",
                   "to": "2"}, 9.0)], type="gauge"),
        })
        bare = SimpleNamespace(profile=None, families={})
        return ns.fleet._control_panel([("w0", st), ("w1", bare)])

    text = "\n".join(both(run))
    assert "w0" in text and "5 actuations" in text
    assert text.index("coalesce_width") < text.index("pipeline_depth")
    assert "w9" in text and "-> 2" in text
    assert "w1" in text and "control plane off" in text


# -- the real services -----------------------------------------------------------

_DEFAULT_DEPTH = _AsyncDispatchPipeline.DEPTH
SERVICE_KW = dict(pool_slots=8, batch_capacity=256, tt_bytes=8 << 20,
                  pipeline_depth=4, driver_threads=1)


def _wait_for_probe(svc):
    co = svc._coalescer
    if co is not None:
        deadline = time.monotonic() + 60.0
        while co._probe is None and time.monotonic() < deadline:
            time.sleep(0.05)


@pytest.fixture(scope="module")
def live_services():
    """One idle service of each package (tests/test_control.py's
    ``live_service``), past the warm-up's dispatch probe."""
    eval_cache.reset_cache()
    svcs = {
        "jax": jax_service.SearchService(
            weights=JaxWeights.random(seed=7), backend="jax", **SERVICE_KW),
        "torch": port_service.SearchService(
            weights=NnueWeights.random(seed=7), device="cpu", **SERVICE_KW),
    }
    try:
        for svc in svcs.values():
            _wait_for_probe(svc)
        yield svcs
    finally:
        for svc in svcs.values():
            svc.close()
        eval_cache.reset_cache()


def _svc(live_services, ns):
    return live_services["torch" if ns is PKGS["torch"] else "jax"]


def test_service_knob_seams(live_services):
    """The depth and width setters move each package's service and None
    restores the default. (The bind-time width is each service's own
    dispatch probe's, so only what follows from it is held equal.)"""
    def run(ns):
        svc = _svc(live_services, ns)
        d0 = svc.async_depth()
        depths = []
        for depth in (4, 1, None):
            svc.set_async_depth(depth)
            depths.append(svc.async_depth())
        w0 = svc.coalesce_width()
        widths = []
        for width in (2, None):
            svc.set_coalesce_width(width)
            widths.append(svc.coalesce_width())
        return d0, depths, w0 is not None and widths == [2, w0]

    d0, depths, restored = both(run)
    assert d0 is not None
    assert depths == [4, 1, d0]
    assert restored


def test_controller_end_to_end_on_real_service(live_services, monkeypatch):
    """Injected transport shares move the probe on each package's real
    service; the escape hatch stops decisions and revert restores the
    bind-time width and depth exactly."""
    def run(ns):
        monkeypatch.delenv("FISHNET_NO_CONTROL", raising=False)
        svc = _svc(live_services, ns)
        w0, d0 = svc.coalesce_width(), svc.async_depth()
        state = {"eval_steps": 0}

        def fake_counters():
            state["eval_steps"] += 40
            return dict(state)

        collector = ns.sig.SignalCollector(service=svc,
                                           counters_fn=fake_counters)
        registry = ns.act.ActuatorRegistry()
        try:
            registry.register_all([
                a for a in ns.ctl.standard_actuators(service=svc)
                if a.name in ("coalesce_width", "pipeline_depth")])
            policy = ns.ctl.RuleProbePolicy()
            policy.width_probe = ns.ctl.LadderProbe(settle=1)
            ctrl = ns.ctl.Controller(collector, registry, policy=policy)
            collector.feed("dispatch_issue", 0.050)
            collector.feed("coalesce", 0.020)
            applied = [a.knob for a in ctrl.step()]
            ref = ns.ctl.LadderProbe(settle=1)
            nxt, kind = ref.update(ref.index_of(w0), 40.0)
            moved = svc.coalesce_width()
            monkeypatch.setenv(ns.pkg.NO_CONTROL_ENV, "1")
            collector.feed("dispatch_issue", 0.050)
            hatched = ctrl.step()
            registry.revert_all()
            return (w0, d0, applied, kind, moved == ns.ctl.WIDTH_LADDER[nxt],
                    hatched, svc.coalesce_width() == w0,
                    svc.async_depth() == d0)
        finally:
            monkeypatch.delenv("FISHNET_NO_CONTROL", raising=False)
            registry.close()
            collector.detach()

    # The bind-time width comes from each service's own dispatch probe,
    # so only what follows from it is held equal.
    port = run(PKGS["torch"])
    ref = run(PKGS["jax"])
    assert port[2:] == ref[2:] == (["coalesce_width"], "trial", True, [],
                                   True, True)


class _Gated(port_service.SearchService):
    """Parks its driver after the warm-up until the gate opens, so every
    submission lands in one drain pass."""

    def __init__(self, *args, **kwargs):
        self.gate = threading.Event()
        super().__init__(*args, **kwargs)

    def warmup(self):
        super().warmup()
        self.gate.wait()


class _JaxGated(jax_service.SearchService):
    def __init__(self, *args, **kwargs):
        self.gate = threading.Event()
        super().__init__(*args, **kwargs)

    def warmup(self):
        super().warmup()
        self.gate.wait()


class _Walk:
    """A scripted policy: one move a window along a fixed cycle of
    coalesce widths and async depths (scheduling knobs only)."""

    MOVES = (("coalesce_width", 1), ("pipeline_depth", 1),
             ("coalesce_width", 2), ("coalesce_width", 4),
             ("pipeline_depth", 4), ("coalesce_width", 8),
             ("pipeline_depth", 2))

    def __init__(self, action):
        self._action = action
        self._i = 0

    def decide(self, sig, knobs):
        knob, value = self.MOVES[self._i % len(self.MOVES)]
        self._i += 1
        return [self._action(knob, value, "scripted walk")]


def _analyses(results):
    return [(r.best_move, r.depth, r.nodes,
             tuple((l.multipv, l.depth, l.is_mate, l.value, tuple(l.pv))
                   for l in r.lines)) for r in results]


def _gated_run(svc, fens, nodes, during=None):
    try:
        svc.set_prefetch(0, adaptive=False)

        async def go():
            tasks = [asyncio.ensure_future(svc.search(fen, [], nodes=nodes))
                     for fen in fens]
            await asyncio.sleep(0.3)
            svc.gate.set()
            return await asyncio.gather(*tasks)

        ctrl = during(svc) if during is not None else None
        try:
            results = asyncio.run(go())
        finally:
            log = None
            if ctrl is not None:
                log = [e.knob for e in ctrl.registry.recent(1000)]
                controller.shutdown_controller(ctrl)
                co = svc._coalescer
                log = (log, (svc.coalesce_width(), svc.async_depth(),
                             dict(co._override)), co.policy_width(0))
        return _analyses(results), svc.counters(), log
    finally:
        svc.gate.set()
        svc.close()


def test_controller_on_equals_off_and_the_jax_service(monkeypatch):
    """A controller moving the port's CPU service's coalesce width and
    async depth every window while four searches run: the analyses equal
    the run without it and the JAX service's, bit for bit. At shutdown
    the depth is back at its default and no width override is left (the
    probe policy decides the width again, from the occupancy it saw)."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.delenv("FISHNET_COALESCE_WIDTH", raising=False)
    fens, nodes = _SMOKE_FENS[:4], 150
    off, c_off, _ = _gated_run(_Gated(
        weights=NnueWeights.random(seed=7), device="cpu", **SERVICE_KW),
        fens, nodes)
    def during(svc):
        reg = actuators.ActuatorRegistry()
        reg.register_all([a for a in controller.standard_actuators(
            service=svc) if a.name in ("coalesce_width", "pipeline_depth")])
        ctrl = controller.Controller(
            signals.SignalCollector(service=svc).attach(), reg,
            policy=_Walk(controller.Action))
        return ctrl.start(period_s=0.02)

    on, c_on, (log, after, policy) = _gated_run(_Gated(
        weights=NnueWeights.random(seed=7), device="cpu", **SERVICE_KW),
        fens, nodes, during=during)
    ref, _, _ = _gated_run(_JaxGated(
        weights=JaxWeights.random(seed=7), backend="jax", **SERVICE_KW),
        fens, nodes)
    assert on == off == ref
    assert c_on["eval_steps"] == c_off["eval_steps"]
    assert {"coalesce_width", "pipeline_depth"} <= set(log)
    assert after == (policy, _DEFAULT_DEPTH, {0: None})


def test_shard_scoped_coalesce_width_equals_jax(monkeypatch):
    """The ``coalesce_width`` actuator's seam on two logical shards: the
    same calls leave each package's coalescer with the same overrides and
    the same widths on the overridden shards (indices out of range are
    dropped, None means every shard), each unset shard back on its own
    probe policy; an env pin outranks every override."""
    monkeypatch.delenv("FISHNET_COALESCE_WIDTH", raising=False)
    calls = [(3, [1]), (5, [0, 7, -1]), (None, [1]), (2, None), (None, None)]

    def build(ns):
        if ns is PKGS["torch"]:
            return port_service.SearchService(
                weights=NnueWeights.random(seed=7), device="cpu",
                mesh_devices=["cpu", "cpu"], **SERVICE_KW)
        return jax_service.SearchService(
            weights=JaxWeights.random(seed=7), backend="jax", mesh_devices=2,
            **SERVICE_KW)

    def run(ns):
        svc = build(ns)
        try:
            _wait_for_probe(svc)
            co = svc._coalescer
            free = dict(co._widths)
            out = []
            for width, shards in calls:
                svc.set_coalesce_width(width, shards=shards)
                over = dict(co._override)
                out.append((over, {s: w for s, w in co._widths.items()
                                   if over[s] is not None},
                            all(co._widths[s] == free[s]
                                for s in over if over[s] is None)))
            return co._n_shards, out
        finally:
            svc.close()

    n, out = both(run)
    assert n == 2
    assert out[0][0] == {0: None, 1: 3} and out[0][1] == {1: 3}
    assert out[1][0] == {0: 5, 1: 3}
    assert out[2][0] == {0: 5, 1: None} and out[2][2]
    assert out[3][1] == {0: 2, 1: 2}
    assert out[4][0] == {0: None, 1: None} and out[4][2]

    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "4")

    def pinned(ns):
        svc = build(ns)
        try:
            svc.set_coalesce_width(8)
            return dict(svc._coalescer._override), dict(
                svc._coalescer._widths)
        finally:
            svc.close()

    assert both(pinned) == ({0: 8, 1: 8}, {0: 4, 1: 4})


def test_policy_width_is_the_width_without_override(monkeypatch):
    """``_DispatchCoalescer.policy_width``, which the controlled chip
    leg reads after shutdown, is each shard's width with no override
    and no env pin, and an override leaves it as it was."""
    monkeypatch.delenv("FISHNET_COALESCE_WIDTH", raising=False)
    svc = port_service.SearchService(
        weights=NnueWeights.random(seed=7), device="cpu",
        mesh_devices=["cpu", "cpu"], **SERVICE_KW)
    try:
        _wait_for_probe(svc)
        co = svc._coalescer
        free = dict(co._widths)
        assert {s: co.policy_width(s) for s in free} == free
        svc.set_coalesce_width(8, shards=[1])
        assert co._widths[1] == min(8, co.MAX_WIDTH)
        assert {s: co.policy_width(s) for s in free} == free
        svc.set_coalesce_width(None)
        assert dict(co._widths) == free
    finally:
        svc.close()
