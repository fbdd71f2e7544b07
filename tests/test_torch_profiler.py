"""The port's profiling plane (fishnet_tpu_torch.telemetry.profiler,
``/profile`` and ``FISHNET_PROFILE`` through ``start_exporter``) against
the JAX package's, on the CPU: tests/test_profiler.py's gate, role,
sampler, histogram and endpoint tests, and its on/off parity.

The plane is off by default and the env gate arms it; ``stop`` clears the
span recorder's stage-observer slot; ``role_of`` and the module's
constants equal JAX's; the sampler folds named threads under their role;
the stage observer feeds ``fishnet_stage_duration_seconds``; the
``/profile`` bodies have JAX's status codes, content types and keys; and
the port's gated service gives the same analyses, bit for bit, with the
profiler, the cost plane and the spans on as with all of them off. Every
test leaves both packages' planes off."""

import gc
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from fishnet_tpu.telemetry import cost as jax_cost
from fishnet_tpu.telemetry import profiler as jax_profiler
from fishnet_tpu.telemetry import spans as jax_spans
from fishnet_tpu_torch import telemetry
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.telemetry import REGISTRY, cost, profiler, spans
from fishnet_tpu_torch.telemetry.trace_export import validate_chrome_trace
from tests.test_async_dispatch import _SMOKE_FENS


def _all_off():
    for prof, led in ((profiler, cost), (jax_profiler, jax_cost)):
        prof.stop()
        led.disable()
        led.reset()


@pytest.fixture(autouse=True)
def disarmed():
    _all_off()
    yield
    _all_off()


@pytest.fixture(autouse=True)
def fresh_port_cache():
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


# -- gate discipline ----------------------------------------------------------


def test_plane_off_by_default():
    assert not profiler.enabled()
    assert profiler.profiler() is None
    assert spans.STAGE_OBSERVER is None
    assert not cost.enabled()
    # ... and the JAX package's planes too (its own test pins them).
    assert jax_spans.STAGE_OBSERVER is None and not jax_cost.enabled()


def test_env_gate(monkeypatch):
    monkeypatch.delenv("FISHNET_PROFILE", raising=False)
    assert profiler.maybe_start_from_env() is None
    monkeypatch.setenv("FISHNET_PROFILE", "0")
    assert profiler.maybe_start_from_env() is None
    monkeypatch.setenv("FISHNET_PROFILE", "1")
    monkeypatch.setenv("FISHNET_PROFILE_HZ", "31")
    prof = profiler.maybe_start_from_env()
    assert prof is not None and profiler.enabled() and prof.hz == 31.0
    assert profiler.start() is prof  # idempotent
    monkeypatch.setenv("FISHNET_PROFILE_HZ", "fast")
    profiler.stop()
    assert profiler.start().hz == profiler.DEFAULT_HZ


def test_stop_clears_span_hook():
    profiler.start(hz=10)
    assert spans.STAGE_OBSERVER is not None
    profiler.stop()
    assert spans.STAGE_OBSERVER is None
    assert not profiler.enabled()


# -- roles and constants --------------------------------------------------------

THREAD_NAMES = [
    "search-driver-0", "search-driver-11", "az-mcts-driver", "dispatch-pack",
    "dispatch-pack-s1", "dispatch-decode", "dispatch-decode-s1",
    "acquire-stream", "api", "api-poll", "frontend", "tenant-lichess",
    "tenant-t0", "MainThread", "profile-sampler", "metrics-exporter",
    "rpc-evaluator", "Thread-3", "", "searcher", "dispatch",
]


@pytest.mark.parametrize("name", THREAD_NAMES)
def test_role_of_equals_jax(name):
    assert profiler.role_of(name) == jax_profiler.role_of(name)


def test_role_of_contract():
    assert profiler.role_of("search-driver-0") == "driver"
    assert profiler.role_of("az-mcts-driver") == "driver"
    assert profiler.role_of("dispatch-pack") == "pack"
    assert profiler.role_of("dispatch-decode") == "decode"
    assert profiler.role_of("tenant-lichess") == "frontend"
    assert profiler.role_of("MainThread") == "main"
    assert profiler.role_of("profile-sampler") == "other"


def test_constants_equal_jax():
    for name in ("DEFAULT_HZ", "MAX_DEPTH", "MAX_STACKS", "STAGE_BUCKETS",
                 "ROLE_PREFIXES"):
        assert getattr(profiler, name) == getattr(jax_profiler, name), name


# -- the sampler and the histograms ---------------------------------------------


def test_sampler_folds_named_threads():
    """A busy thread named under the pack prefix shows up folded under
    the "pack" role, in top_stacks, and in the collapsed text."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(i * i for i in range(200))

    t = threading.Thread(target=spin, name="dispatch-pack-test", daemon=True)
    t.start()
    try:
        prof = profiler.start(hz=200)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if prof.snapshot()["samples_by_role"].get("pack", 0) >= 3:
                break
            time.sleep(0.02)
        snap = prof.snapshot()
        assert snap["samples"] > 0
        assert snap["samples_by_role"].get("pack", 0) >= 3
        tops = prof.top_stacks(10)
        assert tops and all(
            set(s) == {"role", "stack", "count", "share"} for s in tops)
        pack = [s for s in prof.top_stacks(1000) if s["role"] == "pack"]
        assert any(any("test_torch_profiler" in fr for fr in s["stack"])
                   for s in pack), pack
        collapsed = prof.collapsed()
        assert any(line.startswith("pack;")
                   for line in collapsed.splitlines())
        for line in collapsed.splitlines():
            assert line.rsplit(" ", 1)[1].isdigit()
    finally:
        stop.set()
        t.join(timeout=2)


def _parked_threads(name, n, depth, box=None):
    """``n`` threads named ``name-i``, each parked ``depth`` calls deep
    until the returned event is set; ``box`` (a list) gets, from each,
    a weak reference to an object that lives in the parked frame."""
    import weakref

    class Held:
        pass

    go, ready = threading.Event(), threading.Semaphore(0)

    def park(k):
        if k:
            return park(k - 1)
        held = Held()
        if box is not None:
            box.append(weakref.ref(held))
        ready.release()
        go.wait(10)

    threads = [threading.Thread(target=park, args=(depth,), name=f"{name}-{i}",
                                daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for _ in threads:
        assert ready.acquire(timeout=10)
    return go, threads


def test_sample_folds_as_jax():
    """One walk over the same parked threads folds the same stacks under
    the same roles in both packages' samplers."""
    go, threads = _parked_threads("dispatch-pack-fold", 3, 20)
    try:
        port, ref = profiler.SamplingProfiler(), jax_profiler.SamplingProfiler()
        port._sample()
        ref._sample()
    finally:
        go.set()
        for t in threads:
            t.join(timeout=5)

    def pack(prof):
        return {k: n for k, n in prof._stacks.items() if k[0] == "pack"}

    assert pack(port) and pack(port) == pack(ref)


def test_sample_keeps_no_frame_alive():
    """A walk makes no reference cycle: once a sampled thread's frames
    return, what they held is freed at once, with the cyclic collector
    off. The walk's own frame, which holds the frames it walked, must not
    be among them, or every walked frame and the tensors in its locals
    live until the next cyclic collection."""
    box = []
    prof = profiler.SamplingProfiler()
    was_on = gc.isenabled()
    gc.disable()
    try:
        go, threads = _parked_threads("search-driver-cycle", 2, 5, box)
        prof._sample()
        go.set()
        for t in threads:
            t.join(timeout=5)
        assert len(box) == 2 and [r() for r in box] == [None, None]
    finally:
        if was_on:
            gc.enable()
    assert prof.samples == 1


def test_stage_observer_feeds_histogram():
    profiler.start(hz=10)
    spans.RECORDER.record("pack", time.monotonic() - 0.002)
    spans.RECORDER.record("compute", time.monotonic() - 0.05)
    q = profiler.stage_quantiles()
    assert q["pack"]["count"] >= 1
    assert q["compute"]["count"] >= 1
    assert q["compute"]["p99"] >= q["compute"]["p50"] > 0
    assert set(q["pack"]) == {"count", "sum", "p50", "p90", "p99"}
    text = REGISTRY.render_prometheus()
    assert "# TYPE fishnet_stage_duration_seconds histogram" in text
    assert 'stage="pack"' in text


# -- /profile -----------------------------------------------------------------------


def test_render_endpoint_equals_jax():
    """Off: the same 503 body, byte for byte. On: the same status codes,
    content types and JSON keys, in both formats."""
    assert profiler.render_endpoint("") == jax_profiler.render_endpoint("")
    assert profiler.render_endpoint("format=collapsed") == \
        jax_profiler.render_endpoint("format=collapsed")
    profiler.start(hz=100)
    jax_profiler.start(hz=100)
    time.sleep(0.1)
    for query in ("", "format=collapsed", "format=json"):
        status, ctype, body = profiler.render_endpoint(query)
        jstatus, jctype, jbody = jax_profiler.render_endpoint(query)
        assert (status, ctype) == (jstatus, jctype) == (
            200, "text/plain; charset=utf-8" if "collapsed" in query
            else "application/json")
        if ctype == "application/json":
            doc, ref = json.loads(body), json.loads(jbody)
            assert set(doc) == set(ref)
            assert doc["enabled"] is True and doc["hz"] == 100.0
            assert doc["samples"] > 0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as res:
            return res.status, res.headers["Content-Type"], res.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers["Content-Type"], err.read()


def test_start_exporter_arms_both_planes_under_fishnet_profile(monkeypatch):
    """``start_exporter`` without the flag leaves the planes off and
    /profile answers the JAX hint; with ``FISHNET_PROFILE=1`` it arms
    the profiler and the cost plane, and the exporter serves /profile,
    /trace and the stage histogram."""
    monkeypatch.delenv("FISHNET_PROFILE", raising=False)
    exporter = telemetry.start_exporter(0)
    try:
        assert not profiler.enabled() and not cost.enabled()
        assert _get(f"{exporter.url}/profile") == (
            503, *jax_profiler.render_endpoint("")[1:])
    finally:
        exporter.close()
        telemetry.disable()
    monkeypatch.setenv("FISHNET_PROFILE", "1")
    exporter = telemetry.start_exporter(0)
    try:
        assert profiler.enabled() and cost.enabled()
        spans.RECORDER.record("pack", time.monotonic() - 0.001)
        status, ctype, body = _get(f"{exporter.url}/profile")
        assert (status, ctype) == (200, "application/json")
        assert json.loads(body)["enabled"] is True
        status, ctype, body = _get(
            f"{exporter.url}/profile?format=collapsed")
        assert (status, ctype) == (200, "text/plain; charset=utf-8")
        status, ctype, body = _get(f"{exporter.url}/trace")
        assert (status, ctype) == (200, "application/json")
        validate_chrome_trace(json.loads(body))
        text = _get(f"{exporter.url}/metrics")[2].decode()
        assert "fishnet_stage_duration_seconds_bucket" in text
        assert "fishnet_cost_device_ms_total" in text
    finally:
        exporter.close()
        telemetry.disable()


# -- on/off parity on the service ---------------------------------------------------


def test_analyses_with_the_plane_on_equal_off(monkeypatch):
    """tests/test_profiler.py's A/B on the port's gated service: the
    profiler, the cost plane and the spans on leave the analyses and the
    dispatch count as with all of them off. The sampler saw the driver,
    pack and decode threads, the stage histogram the pipeline's stages,
    and the ledger one record a stepped microbatch, whose tenant shares
    sum to the measured wall within 2%; the sampler's duty cycle stays
    under the JAX test's 3%."""
    from tests.test_torch_tracing import _port_run

    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off, c_off, _ = _port_run(_SMOKE_FENS[:4], 100)
        # The off run's closed service is garbage in reference cycles:
        # free it before the window, or the full collection that frees
        # it (170-190 ms in a process that holds both packages) lands
        # on whichever thread trips it, most often the sampler's walk.
        gc.collect()
        prof = profiler.start(hz=profiler.DEFAULT_HZ)
        cost.enable()
        telemetry.enable()
        try:
            on, c_on, is_async = _port_run(_SMOKE_FENS[:4], 100)
        finally:
            telemetry.disable()
        wall = max(1e-9, time.monotonic() - prof.started_at)
        snap = prof.snapshot()
        profiler.stop()
    finally:
        torch.set_num_threads(threads)
    assert on == off
    assert c_on["dispatches"] == c_off["dispatches"]
    assert is_async
    assert {"driver", "pack", "decode"} <= set(snap["samples_by_role"])
    assert {"pack", "device_step", "dispatch_issue", "dispatch_wait",
            "wire_decode"} <= set(snap["stages"])
    ledger = cost.LEDGER.snapshot()
    assert ledger["dispatches"] == c_on["eval_steps"]
    assert sum(ledger["tenant_device_ms"].values()) == pytest.approx(
        ledger["total_device_ms"], rel=0.02)
    assert set(ledger["tenant_device_ms"]) == {"default"}
    duty = prof.self_seconds / wall
    assert duty < 0.03, f"sampler duty cycle {duty:.4f} >= 3%"
