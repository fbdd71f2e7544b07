"""The port's metrics plane (fishnet_tpu_torch.telemetry: the registry,
the /metrics exporter, ``--metrics-port``, and the collectors of the
ported modules) against the JAX package's, on the CPU.

The registry tests use a fresh ``MetricsRegistry()`` each; everything
that builds a service, a pool, a plane, a link or an exporter closes it,
so its collectors leave the process-global ``REGISTRY``. Exporters bind
port 0 and read back the bound port; every socket and thread wait has a
timeout. The family-set parity test runs both packages' ``run`` against
``tests/fake_server.py`` and compares the exported (family, type, label
keys), except the families of modules the port does not have yet
(``NOT_PORTED``)."""

import asyncio
import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from fishnet_tpu import configure as jax_configure
from fishnet_tpu.telemetry import registry as jax_registry
from fishnet_tpu_torch import configure, telemetry
from fishnet_tpu_torch.net import api as api_mod
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.telemetry import exporter as exporter_mod
from fishnet_tpu_torch.telemetry.exporter import MetricsExporter
from fishnet_tpu_torch.telemetry.registry import MetricsRegistry
from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.utils.stats import StatsRecorder, register_stats_collector
from tests.fake_server import VALID_KEY, FakeLichess, FakeServer

ROOT = Path(__file__).resolve().parent.parent
STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"

#: Families the JAX ``run`` exports whose module the port does not have
#: yet (ROADMAP Queue A): family -> module. Empty since the front end
#: and the shed policy were ported.
NOT_PORTED = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_port_cache():
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


# -- Prometheus text-format validation --------------------------------------

_HELP_RE = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*$")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|histogram|summary|untyped)$"
)
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*")*\})?'
    r" -?[0-9]+(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="(?:[^"\\\n]|\\.)*"')


def parse_exposition(text: str) -> dict:
    """Validate exposition-format 0.0.4 syntax; return {family: (type,
    label keys of its samples, "le" aside)}."""
    types, keys = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE"):
            m = _TYPE_RE.match(line)
            assert m, f"bad TYPE line: {line!r}"
            types[m.group(1)] = m.group(2)
            keys.setdefault(m.group(1), set())
        elif line.startswith("#"):
            assert _HELP_RE.match(line), f"bad comment line: {line!r}"
        else:
            m = _SAMPLE_RE.match(line)
            assert m, f"bad sample line: {line!r}"
            name = m.group(1)
            family = name if name in types else re.sub(r"_(bucket|sum|count)$", "", name)
            assert family in types, f"untyped sample: {name}"
            keys[family] |= set(_LABEL_RE.findall(m.group(2) or "")) - {"le"}
    return {f: (types[f], frozenset(keys[f])) for f in types}


def sample_value(text: str, name: str, **labels) -> float:
    for line in text.splitlines():
        if not line.startswith(name + "{") and not line.startswith(name + " "):
            continue
        if all(f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"sample {name}{labels} not found")


def scrape(url: str, path: str = "/metrics") -> bytes:
    with urllib.request.urlopen(f"{url}{path}", timeout=10) as res:
        return res.read()


# -- registry primitives (tests/test_telemetry.py, on a fresh registry) -----


def test_counter_aggregates_across_threads():
    reg = MetricsRegistry()
    c = reg.counter("t_counter_total", "test")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in range(1000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert c.value() == 8000


def test_counter_labels_and_reregistration():
    reg = MetricsRegistry()
    c = reg.counter("t_labeled_total", "test", labelnames=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="b")
    assert c.value(kind="a") == 1 and c.value(kind="b") == 2
    with pytest.raises(ValueError):
        c.inc(wrong="x")
    assert reg.counter("t_labeled_total", "test", labelnames=("kind",)) is c
    with pytest.raises(ValueError):
        reg.gauge("t_labeled_total", "test")
    with pytest.raises(ValueError):
        reg.counter("bad name", "test")


def test_gauge_set_and_function():
    reg = MetricsRegistry()
    g = reg.gauge("t_gauge", "test")
    g.set(41.0)
    assert g.collect().samples[0].value == 41.0
    g.set_function(lambda: 7.0)
    assert g.collect().samples[0].value == 7.0


def test_histogram_buckets_cumulative():
    reg = MetricsRegistry()
    h = reg.histogram("t_hist", "test", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    fam = h.collect()
    by_le = {s.labels["le"]: s.value for s in fam.samples if s.name == "t_hist_bucket"}
    assert by_le == {"0.1": 1, "1": 3, "10": 4, "+Inf": 5}
    assert next(s for s in fam.samples if s.name == "t_hist_count").value == 5
    assert next(s for s in fam.samples if s.name == "t_hist_sum").value == \
        pytest.approx(56.05)


def test_collector_lifecycle_and_error_counter():
    reg = MetricsRegistry()
    state = {"alive": True}
    reg.register_collector(
        lambda: [telemetry.counter_family("t_coll_total", "test", 3)], name="good")
    reg.register_collector(lambda: [] if state["alive"] else None, name="dying")

    def bad():
        raise RuntimeError("boom")

    reg.register_collector(bad, name="bad")
    fams = {f.name: f for f in reg.collect()}
    assert fams["t_coll_total"].samples[0].value == 3
    errs = fams["fishnet_telemetry_collector_errors_total"]
    assert any(s.labels.get("collector") == "bad" and s.value == 1
               for s in errs.samples)
    state["alive"] = False
    reg.collect()  # dying returns None -> self-unregisters
    with reg._lock:
        names = [name for name, _ in reg._collectors.values()]
    assert "dying" not in names and "good" in names
    calls = []
    token = reg.register_collector(lambda: calls.append(1) or [], name="x")
    reg.collect()
    reg.unregister_collector(token)
    reg.collect()
    assert calls == [1]


def test_unregister_waits_for_a_running_scrape():
    """``unregister_collector`` returns only after a scrape that is
    running the collector has finished it."""
    reg = MetricsRegistry()
    entered, release, order = threading.Event(), threading.Event(), []

    def slow():
        entered.set()
        release.wait(10)
        order.append("collected")
        return []

    token = reg.register_collector(slow, name="slow")
    scraper = threading.Thread(target=reg.collect)
    scraper.start()
    assert entered.wait(10)
    remover = threading.Thread(
        target=lambda: (reg.unregister_collector(token), order.append("unregistered")))
    remover.start()
    time.sleep(0.2)
    assert order == []
    release.set()
    scraper.join(10)
    remover.join(10)
    assert order == ["collected", "unregistered"]


def test_exposition_and_json_formats():
    reg = MetricsRegistry()
    c = reg.counter("t_total", "counter with\nnewline help", labelnames=("q",))
    c.inc(q='va"l\\ue')  # label escaping
    reg.gauge("t_g", "gauge").set(1.5)
    reg.histogram("t_h", "hist", buckets=(0.5,)).observe(0.1)
    parsed = parse_exposition(reg.render_prometheus())
    assert {k: v[0] for k, v in parsed.items()} == {
        "fishnet_telemetry_collector_errors_total": "counter",
        "t_total": "counter", "t_g": "gauge", "t_h": "histogram",
    }
    # Byte for byte the JAX registry's rendering of the same instruments.
    ref = jax_registry.MetricsRegistry()
    ref.counter("t_total", "counter with\nnewline help", labelnames=("q",)).inc(
        q='va"l\\ue')
    ref.gauge("t_g", "gauge").set(1.5)
    ref.histogram("t_h", "hist", buckets=(0.5,)).observe(0.1)
    assert reg.render_prometheus() == ref.render_prometheus()
    snap = reg.render_json()
    assert snap["metrics"]["t_total"]["type"] == "counter"
    assert snap["metrics"]["t_g"]["samples"][0]["value"] == 1.5
    assert snap["metrics"]["t_h"]["quantiles"][0]["count"] == 1


def test_quantile_helpers_equal_the_jax_package():
    rng = np.random.default_rng(0)
    values = rng.exponential(1.0, 101).tolist()
    for q in (0, 50, 90, 99, 100):
        assert telemetry.percentile(values, q) == jax_registry.percentile(values, q)
    assert telemetry.percentile([], 50) is None
    bounds, cum = (0.1, 1.0, 10.0), (3, 7, 9)
    for q in (0.1, 0.5, 0.9, 0.99):
        assert telemetry.quantile_from_buckets(bounds, cum, 10, q) == \
            jax_registry.quantile_from_buckets(bounds, cum, 10, q)
    reg, ref = MetricsRegistry(), jax_registry.MetricsRegistry()
    for r in (reg, ref):
        h = r.histogram("t_lat", "x", labelnames=("k",), buckets=(0.1, 1.0))
        for v in values:
            h.observe(v, k="a")
    ours = telemetry.histogram_quantiles(reg.histogram("t_lat", "x").collect())
    theirs = jax_registry.histogram_quantiles(ref.histogram("t_lat", "x").collect())
    assert [{k: v for k, v in r.items() if k != "sum"} for r in ours] == \
        [{k: v for k, v in r.items() if k != "sum"} for r in theirs]
    assert ours[0]["sum"] == pytest.approx(theirs[0]["sum"])


# -- the exporter -----------------------------------------------------------


def test_exporter_routes_and_not_ported_bodies():
    reg = MetricsRegistry()
    reg.counter("t_req_total", "x").inc(5)
    exporter = MetricsExporter(port=0, registry=reg)
    try:
        assert exporter.port > 0
        text = scrape(exporter.url).decode()
        parsed = parse_exposition(text)
        assert sample_value(text, "t_req_total") == 5
        assert parsed["fishnet_build_info"] == (
            "gauge", frozenset({"version", "abi", "jax"}))
        assert sample_value(text, "fishnet_build_info", jax="none", abi="11") == 1
        assert "fishnet_proc_start_time_seconds" in parsed
        assert "t_req_total" in json.loads(scrape(exporter.url, "/json"))["metrics"]
        for path in ("/healthz", "/healthz/live", "/healthz/ready"):
            assert scrape(exporter.url, path) == b"ok\n"
        for path, module in exporter_mod.NOT_PORTED.items():
            with pytest.raises(urllib.error.HTTPError) as err:
                scrape(exporter.url, path)
            assert err.value.code == 404
            assert module in err.value.read().decode()
        with pytest.raises(urllib.error.HTTPError) as err:
            scrape(exporter.url, "/nope")
        assert err.value.code == 404
    finally:
        exporter.close()
    with pytest.raises(OSError):
        scrape(exporter.url)


def test_health_providers_drive_readiness_not_liveness():
    exporter = MetricsExporter(port=0, registry=MetricsRegistry())
    state = {"healthy": True}
    fn = exporter_mod.register_health_provider("t-front", lambda: dict(state))
    try:
        assert json.loads(scrape(exporter.url, "/healthz"))["status"] == "ok"
        state["healthy"] = False
        with pytest.raises(urllib.error.HTTPError) as err:
            scrape(exporter.url, "/healthz/ready")
        assert err.value.code == 503
        assert scrape(exporter.url, "/healthz/live") == b"ok\n"
        exporter_mod.unregister_health_provider_if("t-front", lambda: None)
        assert exporter_mod.health_snapshot()[0] == 503  # not its provider
        exporter_mod.unregister_health_provider(fn)
        assert exporter_mod.health_snapshot() == (200, None)
        exporter_mod.register_health_provider("t-gone", lambda: None)
        assert exporter_mod.health_snapshot() == (200, None)  # self-removed
    finally:
        exporter_mod.unregister_health_provider("t-front")
        exporter.close()


def test_start_exporter_and_the_port_file_written_after_bind(tmp_path):
    from fishnet_tpu_torch.__main__ import start_metrics

    port_file = tmp_path / "metrics.port"
    opt = configure.parse_and_configure(
        ["run", "--no-conf", "--metrics-port", "0", "--metrics-port-file",
         str(port_file)])
    stats = StatsRecorder(cores=1, no_stats_file=True)
    stats.record_batch(positions=3, nodes=300, nnue_nps=1000)
    exporter = start_metrics(opt, stats, Logger())
    try:
        assert telemetry.enabled()
        assert port_file.read_text() == f"{exporter.port}\n"
        assert not (tmp_path / "metrics.port.tmp").exists()
        text = scrape(f"http://127.0.0.1:{int(port_file.read_text())}").decode()
        parse_exposition(text)
        assert sample_value(text, "fishnet_stats_positions_total") == 3
    finally:
        exporter.close()
        telemetry.disable()
    assert start_metrics(configure.parse_and_configure(["run", "--no-conf"]),
                         stats, Logger()) is None
    del stats  # its collector unregisters itself at the next scrape
    telemetry.REGISTRY.collect()


@pytest.mark.parametrize("argv,ini", [
    (["run", "--no-conf", "--metrics-port", "9100"], None),
    (["run", "--no-conf", "--metrics-port", "0", "--metrics-port-file", "p"], None),
    (["run"], "MetricsPort = 9200\nMetricsPortFile = q\n"),
    (["run", "--metrics-port", "0"], "MetricsPort = 9200\n"),
])
def test_metrics_flags_resolve_as_in_the_jax_package(tmp_path, argv, ini):
    if ini is not None:
        conf = tmp_path / "fishnet.ini"
        conf.write_text("[Fishnet]\n" + ini)
        argv = argv + ["--conf", str(conf)]
    port = configure.parse_and_configure(argv)
    ref = jax_configure.parse_and_configure(argv, write=False)
    assert (port.metrics_port, port.metrics_port_file) == \
        (ref.metrics_port, ref.metrics_port_file)


@pytest.mark.parametrize("value", ["70000", "-1", "http"])
def test_a_bad_metrics_port_is_refused(value):
    with pytest.raises((configure.ConfigError, SystemExit)):
        configure.parse_and_configure(["run", "--no-conf", "--metrics-port", value])


# -- the collectors of the ported modules -----------------------------------


def _acquire_hist():
    return api_mod._REQUEST_SECONDS.labels(endpoint="acquire").snapshot()


@pytest.mark.anyio
async def test_api_reject_counters():
    """406 on acquire: the rejected counter, an ok outcome (the server
    answered) and one latency observation."""
    async with FakeServer() as server:
        server.lichess.reject_with = 406
        stub, actor = api_mod.channel(server.endpoint, VALID_KEY, Logger())
        task = asyncio.create_task(actor.run())
        rej0 = api_mod._REJECTS.value(endpoint="acquire", status="406")
        ok0 = api_mod._REQUESTS.value(endpoint="acquire", outcome="ok")
        counts0, sum0, n0 = _acquire_hist()
        try:
            acquired = await asyncio.wait_for(stub.acquire(slow=False), 10)
        finally:
            actor.stop()
            await asyncio.wait_for(task, timeout=10)
        assert acquired is not None and acquired.kind.value == "rejected"
        assert api_mod._REJECTS.value(endpoint="acquire", status="406") == rej0 + 1
        assert api_mod._REQUESTS.value(endpoint="acquire", outcome="ok") == ok0 + 1
        counts1, sum1, n1 = _acquire_hist()
        assert n1 == n0 + 1 and sum1 >= sum0
        assert all(c1 >= c0 for c0, c1 in zip(counts0, counts1))


@pytest.mark.anyio
async def test_api_rate_limited_counters():
    """429 on acquire: a rate_limited outcome, one suspension and its
    >= 60 s in the suspended-seconds counter."""
    async with FakeServer() as server:
        server.lichess.reject_with = 429
        stub, actor = api_mod.channel(server.endpoint, VALID_KEY, Logger())
        task = asyncio.create_task(actor.run())
        rl0 = api_mod._REQUESTS.value(endpoint="acquire", outcome="rate_limited")
        susp0 = api_mod._SUSPENSIONS.value()
        sec0 = api_mod._SUSPENDED_SECONDS.value()
        stub0 = api_mod._STUB_ERRORS.value(endpoint="acquire")
        try:
            acquired = await asyncio.wait_for(stub.acquire(slow=False), timeout=10)
        finally:
            actor.stop()
            await asyncio.wait_for(task, timeout=10)
        assert acquired is None
        assert api_mod._REQUESTS.value(endpoint="acquire", outcome="rate_limited") \
            == rl0 + 1
        assert api_mod._SUSPENSIONS.value() == susp0 + 1
        assert api_mod._SUSPENDED_SECONDS.value() >= sec0 + 60.0
        assert api_mod._STUB_ERRORS.value(endpoint="acquire") == stub0 + 1


def test_stats_collector_exposes_totals():
    rec = StatsRecorder(cores=4, no_stats_file=True)
    rec.record_batch(positions=7, nodes=420, nnue_nps=1000)
    token = register_stats_collector(rec)
    try:
        text = telemetry.REGISTRY.render_prometheus()
        assert sample_value(text, "fishnet_stats_batches_total") == 1
        assert sample_value(text, "fishnet_stats_positions_total") == 7
        assert sample_value(text, "fishnet_stats_nodes_total") == 420
        assert sample_value(text, "fishnet_nnue_nps") > 0
    finally:
        telemetry.REGISTRY.unregister_collector(token)


def _service(**kw):
    kw = dict(dict(pool_slots=16, batch_capacity=64, tt_bytes=1 << 20,
                   device="cpu"), **kw)
    return SearchService(weights=NnueWeights.random(seed=5), **kw)


def _quiesced_scrape(svc, url):
    for _ in range(100):
        before = svc.counters()
        text = scrape(url).decode()
        if svc.counters() == before:
            return before, text
        time.sleep(0.05)
    pytest.fail("service never quiesced")


#: counters() key -> the family that adapts it.
ADAPTED = {
    "nodes": "fishnet_pool_nodes_total", "steps": "fishnet_pool_steps_total",
    "evals_shipped": "fishnet_pool_evals_shipped_total",
    "eval_steps": "fishnet_service_eval_steps_total",
    "dispatches": "fishnet_dispatches_total",
    "fused_dispatches": "fishnet_coalesced_dispatches_total",
    "wire_bytes": "fishnet_service_wire_bytes_total",
    "bucket_slots": "fishnet_service_bucket_slots_total",
    "fused_dedup": "fishnet_fused_dedup_total",
    "position_dedup": "fishnet_position_dedup_total",
    "bounds_seeded": "fishnet_bounds_seeded_total",
    "bounds_harvested": "fishnet_bounds_harvested_total",
    "cache_skipped_dispatches": "fishnet_eval_cache_skipped_dispatches_total",
}


def test_service_metrics_equal_counters_and_leave_at_close():
    svc = _service(driver_threads=2, pipeline_depth=2)
    exporter = MetricsExporter(port=0)
    try:
        async def run():
            await asyncio.gather(*(svc.search(STARTPOS, [], depth=3)
                                   for _ in range(4)))
        asyncio.run(run())
        counters, text = _quiesced_scrape(svc, exporter.url)
        parse_exposition(text)
        assert counters["dispatches"] > 0
        for key, family in ADAPTED.items():
            assert sample_value(text, family) == counters[key], key
        assert sample_value(text, "fishnet_eval_steps_total") == counters["eval_steps"]
        assert sample_value(text, "fishnet_eval_cache_hits_total", scope="pool") \
            == counters["tt_eval_hits"]
        assert sample_value(text, "fishnet_eval_cache_hits_total", scope="prewire") \
            == counters["cache_prewire_hits"]
        assert sample_value(text, "fishnet_shard_dispatches_total", shard="0") \
            == counters["dispatches"]
        assert sample_value(text, "fishnet_shard_ladder_rung", shard="0") == 1  # xla
        assert sample_value(text, "fishnet_service_info", backend=svc.backend,
                            psqt_path="xla", driver_threads="2") == 1
        assert sample_value(text, "fishnet_eval_cache_entries") == \
            counters["cache_entries"]
    finally:
        exporter.close()
        svc.close()
    text = telemetry.REGISTRY.render_prometheus()
    assert "fishnet_pool_nodes_total" not in text
    assert "fishnet_service_info" not in text


def test_two_shard_service_reports_both_shards():
    svc = _service(mesh_devices=["cpu", "cpu"], driver_threads=2, pipeline_depth=2)
    try:
        async def run():
            await asyncio.gather(*(svc.search(STARTPOS, [], nodes=40)
                                   for _ in range(4)))
        asyncio.run(run())
        text = telemetry.REGISTRY.render_prometheus()
        rep = svc.shard_report()
        for s in range(2):
            assert sample_value(text, "fishnet_shard_dispatches_total",
                                shard=str(s)) == rep["dispatches"][s]
    finally:
        svc.close()


def test_scrapes_racing_close_never_touch_a_freed_pool():
    """A scraper hammers the registry while services are built, searched
    and closed: ``fc_pool_free`` only ever runs after the service's
    collector has left the registry, and no collector raises."""
    errors0 = {s.labels.get("collector"): s.value for s in
               telemetry.REGISTRY._collector_errors.collect().samples}
    stop = threading.Event()
    scrapes = [0]

    def scraper():
        while not stop.wait(0.002):  # leave the drivers the interpreter
            telemetry.REGISTRY.render_prometheus()
            scrapes[0] += 1

    thread = threading.Thread(target=scraper, daemon=True)
    thread.start()
    freed = []
    try:
        for _ in range(3):
            svc = _service()
            real_lib = svc._lib

            class Lib:
                def __getattr__(self, name):
                    return getattr(real_lib, name)

                def fc_pool_free(self, pool, svc=svc):
                    token = svc._collector_token
                    with telemetry.REGISTRY._lock:
                        live = [t for t, (n, _) in
                                telemetry.REGISTRY._collectors.items()
                                if n == "search-service"]
                    freed.append(token is None and all(
                        t != getattr(svc, "_last_token", None) for t in live))
                    real_lib.fc_pool_free(pool)

            svc._last_token = svc._collector_token
            svc._lib = Lib()
            asyncio.run(svc.search(STARTPOS, [], nodes=50))
            svc.close()
    finally:
        stop.set()
        thread.join(10)
    assert freed == [True, True, True]
    assert scrapes[0] > 0
    errors1 = {s.labels.get("collector"): s.value for s in
               telemetry.REGISTRY._collector_errors.collect().samples}
    assert errors1.get("search-service", 0) == errors0.get("search-service", 0)


def test_cache_mcts_plane_and_rpc_collectors(tmp_path, monkeypatch):
    """The eval caches' collectors leave with ``reset_cache``; the MCTS
    pool's families and the AZ plane's appear with a pool; the plane's
    leave at its close; the rpc families follow a link's life."""
    monkeypatch.delenv("FISHNET_NO_BOUNDS", raising=False)
    from fishnet_tpu_torch.models.az import AzConfig, init_az_params
    from fishnet_tpu_torch.rpc import rings
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    cache = eval_cache.get_cache()
    eval_cache.get_bounds_cache()
    cache.insert_block(np.arange(1, 6, dtype=np.uint64), np.arange(5, dtype=np.int32))
    text = telemetry.REGISTRY.render_prometheus()
    assert sample_value(text, "fishnet_eval_cache_entries") == len(cache) == 5
    assert sample_value(text, "fishnet_eval_cache_entries", family="bounds") == 0
    eval_cache.reset_cache()
    assert "fishnet_eval_cache_entries" not in telemetry.REGISTRY.render_prometheus()

    cfg = AzConfig(channels=16, blocks=2, value_hidden=16)
    pool = MctsPool(init_az_params(0, cfg),
                    MctsConfig(batch_capacity=64, az=cfg), device="cpu")
    try:
        sid = pool.submit("6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1", [], visits=40)
        while pool.active():
            pool.step()
        pool.harvest(sid)
        text = telemetry.REGISTRY.render_prometheus()
        parsed = parse_exposition(text)
        assert sample_value(text, "fishnet_mcts_visits_total") >= 40
        assert parsed["fishnet_az_speculation_budget"][0] == "gauge"
        assert sample_value(text, "fishnet_eval_cache_entries", family="az") > 0
    finally:
        pool.close()
    text = telemetry.REGISTRY.render_prometheus()
    assert "fishnet_az_speculation_budget" not in text
    assert "fishnet_mcts_trees_active" in text  # process totals stay

    rings.set_role("frontend")
    link = rings.create_frontend_link(str(tmp_path))
    try:
        text = telemetry.REGISTRY.render_prometheus()
        name = os.path.basename(link.path)
        assert sample_value(text, "fishnet_rpc_ring_depth", link=name,
                            ring="submit") == 0
        assert sample_value(text, "fishnet_rpc_role", role="frontend") == 1
        assert sample_value(text, "fishnet_rpc_reattach_total") >= 1
    finally:
        link.close()
    assert os.path.basename(link.path) not in telemetry.REGISTRY.render_prometheus()


# -- family-set parity with the JAX package's `run` --------------------------


async def _run_and_scrape(module, tmp_path, server, job, extra):
    port_file = tmp_path / f"{module}.port"
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    log = open(tmp_path / f"{module}.log", "wb")
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", module, "run", "--no-conf", "--no-stats-file",
        "--endpoint", server.endpoint, "--key", VALID_KEY, "--cores", "1",
        "--engine", "tpu-nnue", "--microbatch", "64", "--max-backoff", "1",
        "--metrics-port", "0", "--metrics-port-file", str(port_file), *extra,
        stdout=log, stderr=asyncio.subprocess.STDOUT, cwd=str(tmp_path), env=env)
    log.close()
    try:
        deadline = time.monotonic() + 240
        while job not in server.lichess.analyses:
            assert proc.returncode is None, (tmp_path / f"{module}.log").read_text()[-3000:]
            assert time.monotonic() < deadline, "no analysis submitted"
            await asyncio.sleep(0.1)
        url = f"http://127.0.0.1:{int(port_file.read_text())}"
        text = await asyncio.get_running_loop().run_in_executor(
            None, lambda: scrape(url).decode())
        proc.send_signal(2)
        await asyncio.wait_for(proc.wait(), 120)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    return parse_exposition(text)


@pytest.mark.anyio
async def test_run_exports_the_jax_family_set(tmp_path):
    """`run --metrics-port 0 --metrics-port-file F` of both packages on
    the same job: the port's /metrics parses as 0.0.4, and its (family,
    type, label keys) equal the JAX client's but for NOT_PORTED."""
    families = {}
    for module, extra in (("fishnet_tpu", []),
                          ("fishnet_tpu_torch", ["--device", "cpu"])):
        lichess = FakeLichess()
        async with FakeServer(lichess) as server:
            job = lichess.add_analysis_job(moves="e2e4 e7e5", nodes=100)
            families[module] = await _run_and_scrape(
                module, tmp_path, server, job, extra)
    ref, port = families["fishnet_tpu"], families["fishnet_tpu_torch"]
    assert set(NOT_PORTED) <= set(ref)
    waiting = {f: ref[f] for f in NOT_PORTED}
    assert not set(NOT_PORTED) & set(port)
    assert port == {f: v for f, v in ref.items() if f not in waiting}
