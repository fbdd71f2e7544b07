"""The port's SLO engine (fishnet_tpu_torch.telemetry.slo) against the
JAX package's, on the CPU: tests/test_fleet_obs.py's SLO tests, held as
equality with the JAX engine.

On the same family snapshots — the JAX tests' counters and histograms,
and seeded random series over the default SLOs' families — both engines
return equal ``good_total``, ``evaluate``, ``burn_snapshot`` and
``families`` (the families compared as name, type, help and samples).
The default SLOs equal the JAX ones and name only families that the
port's ``run`` exports, with the label keys their selectors match."""

import numpy as np
import pytest

from fishnet_tpu.telemetry import registry as jax_registry
from fishnet_tpu.telemetry import slo as jax_slo
from fishnet_tpu_torch.telemetry import REGISTRY, registry, slo
from tests.fake_server import FakeLichess, FakeServer
from tests.test_torch_telemetry import _run_and_scrape

PKGS = ((slo, registry), (jax_slo, jax_registry))


def _fams(reg_mod, spec):
    """{family: MetricFamily} of ``reg_mod`` from ``spec``: family ->
    (type, [(sample name, labels, value)])."""
    out = {}
    for name, (typ, samples) in spec.items():
        fam = reg_mod.MetricFamily(name, typ, "h")
        fam.samples = [reg_mod.Sample(n, float(v), dict(lb))
                       for n, lb, v in samples]
        out[name] = fam
    return out


def _counter(ok, bad):
    return {"req_total": ("counter", [
        ("req_total", {"outcome": "ok"}, ok),
        ("req_total", {"outcome": "error"}, bad)])}


def _latency(under, total):
    b = "lat_seconds_bucket"
    return {"lat_seconds": ("histogram", [
        (b, {"le": "1"}, under), (b, {"le": "2.5"}, under),
        (b, {"le": "+Inf"}, total), ("lat_seconds_count", {}, total),
        ("lat_seconds_sum", {}, 0.0)])}


def _ratio(mod, objective=0.9):
    return mod.SLO(name="t", description="d", objective=objective,
                   total=mod.Selector("req_total"),
                   bad=mod.Selector("req_total", {"outcome": "error"}))


def _lat(mod):
    return mod.SLO(name="lat", description="d", objective=0.9,
                   total=mod.Selector("lat_seconds"), threshold_s=2.0)


def _family_rows(fams):
    return [(f.name, f.type, f.help,
             [(s.name, s.value, s.labels) for s in f.samples]) for f in fams]


def _both(make_slos, windows, feed, evals):
    """Run ``feed`` [(spec, now)] through each package's engine; return
    each one's (evaluations at ``evals``, families at the last)."""
    outs = []
    for mod, reg in PKGS:
        eng = mod.SLOEngine(make_slos(mod), windows=windows)
        for spec, now in feed:
            eng.observe(_fams(reg, spec), now=now)
        outs.append(([eng.evaluate(now=t) for t in evals] + [eng.evaluate()],
                     _family_rows(eng.families(now=evals[-1]))))
    return outs


def test_ratio_slo_burn_rates_multi_window():
    feed = [(_counter(100, 0), 1000.0), (_counter(180, 20), 1030.0),
            (_counter(1180, 20), 1120.0)]
    got, ref = _both(lambda m: [_ratio(m, 0.9)], (60.0, 300.0), feed,
                     [1030.0, 1120.0])
    assert got == ref
    rows = got[0]
    assert rows[1][0]["windows"]["60s"] == 0.0
    assert rows[1][0]["windows"]["300s"] > 0.0


def test_ratio_slo_breach_then_calm():
    feed = [(_counter(100, 0), 1000.0), (_counter(180, 20), 1030.0)]
    got, ref = _both(lambda m: [_ratio(m, 0.9)], (60.0, 300.0), feed,
                     [1030.0])
    assert got == ref
    assert got[0][0][0]["windows"]["60s"] == pytest.approx(2.0)
    assert got[0][0][0]["status"] == "breach"


def test_slo_no_traffic_is_not_burning():
    feed = [(_counter(50, 5), 0.0), (_counter(50, 5), 30.0)]
    got, ref = _both(lambda m: [_ratio(m)], (60.0,), feed, [30.0])
    assert got == ref
    assert got[0][0][0]["status"] == "ok"


def test_latency_slo_counts_good_from_snapped_bucket():
    for mod, reg in PKGS:
        good, total, snapped = _lat(mod).good_total(
            _fams(reg, _latency(80, 100)))
        assert (good, total, snapped) == (80.0, 100.0, 2.5)
    feed = [(_latency(80, 100), 0.0), (_latency(160, 200), 30.0)]
    got, ref = _both(lambda m: [_lat(m)], (60.0,), feed, [30.0])
    assert got == ref
    assert got[0][0][0]["windows"]["60s"] == pytest.approx(2.0)
    assert got[0][0][0]["snapped_bound_s"] == 2.5


def test_slo_families_exposition_shape():
    feed = [(_counter(10, 0), 0.0)]
    got, ref = _both(lambda m: [_ratio(m)], (60.0,), feed, [0.0])
    assert got == ref
    fams = {f[0]: f for f in got[1]}
    assert fams["fishnet_slo_burn_rate"][3][0][2] == {"slo": "t",
                                                      "window": "60s"}
    assert fams["fishnet_slo_status"][3][0][1] == 0.0


def test_engine_needs_a_window():
    for mod, _ in PKGS:
        with pytest.raises(ValueError):
            mod.SLOEngine([], windows=())


def _default_series(rng, steps):
    """Cumulative series of the default SLOs' families over ``steps``
    polls: request histograms by endpoint (bucket grid 0.5/1/2.5/5/+Inf),
    request outcomes, admission decisions, dropped submissions, and a
    counter reset now and then."""
    bounds = ("0.5", "1", "2.5", "5", "+Inf")
    endpoints = ("submit_move", "submit_analysis", "acquire")
    state = {
        "hist": {e: np.zeros(len(bounds)) for e in endpoints},
        "req": {("acquire", "ok"): 0, ("acquire", "error"): 0,
                ("submit_move", "ok"): 0, ("submit_analysis", "error"): 0},
        "adm": {("throughput", "admit"): 0, ("throughput", "shed"): 0,
                ("latency", "admit"): 0},
        "dropped": 0,
    }
    out = []
    t = 1000.0
    for _ in range(steps):
        t += float(rng.uniform(5, 90))
        for e in endpoints:
            add = rng.integers(0, 30, len(bounds))
            state["hist"][e] += np.cumsum(add)
        for k in state["req"]:
            state["req"][k] += int(rng.integers(0, 50))
        for k in state["adm"]:
            state["adm"][k] += int(rng.integers(0, 20))
        state["dropped"] += int(rng.integers(0, 2))
        if rng.random() < 0.1:  # a restarted feed resets its counters
            state["dropped"] = 0
            for k in state["req"]:
                state["req"][k] //= 3
        hist = []
        for e in endpoints:
            cum = state["hist"][e]
            for le, v in zip(bounds, cum):
                hist.append(("fishnet_api_request_seconds_bucket",
                             {"endpoint": e, "le": le}, v))
            hist.append(("fishnet_api_request_seconds_count",
                         {"endpoint": e}, cum[-1]))
            hist.append(("fishnet_api_request_seconds_sum",
                         {"endpoint": e}, float(cum[-1]) * 0.7))
        spec = {
            "fishnet_api_request_seconds": ("histogram", hist),
            "fishnet_api_requests_total": ("counter", [
                ("fishnet_api_requests_total",
                 {"endpoint": e, "outcome": o, "proc": "p0"}, v)
                for (e, o), v in state["req"].items()]),
            "fishnet_admission_total": ("counter", [
                ("fishnet_admission_total", {"lane": ln, "decision": d}, v)
                for (ln, d), v in state["adm"].items()]),
            "fishnet_api_submit_dropped_total": ("counter", [
                ("fishnet_api_submit_dropped_total", {},
                 state["dropped"])]),
        }
        out.append((spec, t))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_default_slos_evaluate_as_in_jax(seed):
    rng = np.random.default_rng(seed)
    feed = _default_series(rng, int(rng.integers(3, 25)))
    evals = sorted(float(t) for t in rng.uniform(
        feed[0][1], feed[-1][1] + 400, 4))
    got, ref = _both(lambda m: m.default_slos(), (60.0, 300.0), feed, evals)
    assert got == ref
    # burn_snapshot on explicit families: one observe + evaluate.
    snaps = []
    for mod, reg in PKGS:
        eng = mod.SLOEngine(windows=(60.0, 300.0))
        for spec, now in feed[:-1]:
            eng.observe(_fams(reg, spec), now=now)
        snaps.append(eng.burn_snapshot(_fams(reg, feed[-1][0]),
                                       now=feed[-1][1]))
    assert snaps[0] == snaps[1]
    assert set(snaps[0]) == {s.name for s in slo.default_slos()}


def test_default_slos_equal_jax():
    def rows(mod):
        return [(s.name, s.description, s.objective, s.total.family,
                 dict(s.total.labels), s.total.suffix,
                 None if s.bad is None else (s.bad.family, dict(s.bad.labels)),
                 s.threshold_s) for s in mod.default_slos()]

    assert rows(slo) == rows(jax_slo)
    assert slo.DEFAULT_WINDOWS == jax_slo.DEFAULT_WINDOWS


def test_burn_snapshot_reads_the_port_registry():
    eng = slo.SLOEngine()
    snap = eng.burn_snapshot(now=50.0)
    assert set(snap) == {s.name for s in slo.default_slos()}
    assert all(e["status"] == "ok" for e in snap.values())
    assert REGISTRY is registry.REGISTRY


@pytest.mark.anyio
async def test_default_slos_name_families_the_port_run_exports(tmp_path):
    """A port ``run --metrics-port 0 --tenants 2``
    (tests/test_torch_telemetry.py's helper) on one analysis job: every
    family a default SLO selects is
    on its /metrics, of the right type, with the label keys its
    selectors match."""
    lichess = FakeLichess()
    async with FakeServer(lichess) as server:
        job = lichess.add_analysis_job(moves="e2e4 e7e5", nodes=100)
        families = await _run_and_scrape("fishnet_tpu_torch", tmp_path,
                                         server, job,
                                         ["--device", "cpu", "--tenants", "2"])
    for s in slo.default_slos():
        for sel in (s.total, s.bad):
            if sel is None:
                continue
            assert sel.family in families, sel.family
            typ, keys = families[sel.family]
            assert typ == ("histogram" if s.threshold_s else "counter")
            assert set(sel.labels) <= keys, (sel.family, keys)
