"""The port's causal traces (fishnet_tpu_torch.telemetry.tracing and the
step traces of its search service) against the JAX package's, on the
CPU.

Trace ids from seeded batch ids equal the JAX functions'. The trace
context rides the coalesce ticket across the async pipeline's pack and
decode workers (tests/test_tracing.py's handoff test, on the port's
pipeline). Then gated searches on the port's ``SearchService``
(tests/test_tracing.py's smoke: 4 FENs at 150 nodes, width pinned to 2),
async and with ``FISHNET_NO_ASYNC=1``: the stage set equals the JAX
service's on the same searches, the JAX package's own consumers
(``telemetry.critical_path``) find no orphan span and attribute at least
95% of each step trace's wall time (the JAX test's bound), and the
analyses with spans on equal those with spans off, bit for bit.
Durations are never compared: only structure, names, fields and ids."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from fishnet_tpu import telemetry as jax_telemetry
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.telemetry import critical_path as cp
from fishnet_tpu.telemetry import tracing as jax_tracing
from fishnet_tpu.telemetry.spans import RECORDER as JAX_RECORDER
from fishnet_tpu_torch import telemetry
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.search import coalesce, eval_cache
from fishnet_tpu_torch.search.coalesce import (
    _AsyncDispatchPipeline,
    _CoalesceTicket,
    _FusedValues,
)
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.telemetry import tracing
from fishnet_tpu_torch.telemetry.spans import RECORDER
from tests.test_async_dispatch import _SMOKE_FENS, _smoke_run


@pytest.fixture(autouse=True)
def fresh_port_cache():
    """The port's process-wide eval cache, reset around each test:
    tests/conftest.py resets only the JAX package's."""
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small gathers: torch's intra-op threads cost more than they give,
    most of all beside other test processes (ROADMAP C8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tel_enabled():
    telemetry.enable()
    try:
        yield
    finally:
        telemetry.disable()


def _spans_since(recorder, t0):
    # spans() rounds t to 6 decimals — allow the round-down.
    return [s for s in recorder.spans() if s["t"] >= t0 - 1e-4]


# -- trace contexts and ids ---------------------------------------------------

#: Seeded batch ids: the fake servers' shape ("wk000123") and random
#: alphanumerics of lichess's length.
_RNG = np.random.default_rng(23)
_ALNUM = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                       "0123456789"))
BATCH_IDS = [f"wk{i:06d}" for i in _RNG.integers(0, 10**6, 4)] + [
    "".join(_RNG.choice(_ALNUM, 8)) for _ in range(4)]


@pytest.mark.parametrize("batch_id", BATCH_IDS)
def test_batch_trace_ids_equal_the_jax_functions(batch_id):
    tid = tracing.trace_id_for_batch(batch_id)
    assert tid == jax_tracing.trace_id_for_batch(batch_id)
    root, ref_root = tracing.batch_root(batch_id), jax_tracing.batch_root(
        batch_id)
    assert (root.trace_id, root.span_id, root.parent_id) == (
        ref_root.trace_id, ref_root.span_id, ref_root.parent_id)
    child, ref_child = tracing.batch_child(batch_id), jax_tracing.batch_child(
        batch_id)
    assert (child.trace_id, child.parent_id) == (
        ref_child.trace_id, ref_child.parent_id) == (tid, tid)
    assert child.span_id != root.span_id
    ctxs = [tracing.batch_child(batch_id) for _ in range(3)]
    ref = [jax_tracing.TraceContext(c.trace_id, c.span_id, c.parent_id)
           for c in ctxs]
    assert tracing.links_for(ctxs) == jax_tracing.links_for(ref)
    assert tracing.links_for(ctxs) == [(tid, c.span_id) for c in ctxs]


def test_trace_context_chaining():
    root = tracing.new_trace()
    assert root.span_id == root.trace_id and root.parent_id is None
    child = root.child()
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    assert child.span_id != root.span_id
    assert child.child().parent_id == child.span_id


def test_span_ids_unique_across_threads():
    """8 threads, each started and ended several times: no id repeats
    (a thread's ordinal is never reused, unlike its ident)."""
    ids, lock = [], threading.Lock()

    def mint():
        mine = [tracing.next_span_id() for _ in range(50)]
        mine.append(tracing.new_trace().span_id)
        with lock:
            ids.extend(mine)

    for _ in range(4):
        threads = [threading.Thread(target=mint) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(ids) == len(set(ids)) == 4 * 8 * 51


# -- propagation across the pack/decode worker handoff ------------------------


class _StubCoalescer:
    width = 1

    def _execute(self, tickets):
        for tk in tickets:
            tk.done.set()


class _StubSvc(coalesce.CoalesceBackend):
    def __init__(self):
        self._coalescer = _StubCoalescer()


def test_handoff_propagation_fused_multi_owner(tel_enabled):
    """tests/test_tracing.py's handoff test on the port's pipeline: one
    fused dispatch owned by TWO step traces. dispatch_issue parents
    under the FIRST owner's device_step context and links the second;
    dispatch_wait (decode worker, a second thread handoff) chains under
    dispatch_issue in the same trace, links preserved."""
    d1 = tracing.new_trace().child()  # two owners' device_step contexts
    d2 = tracing.new_trace().child()
    t0 = time.monotonic()
    pipe = _AsyncDispatchPipeline(_StubSvc())
    try:
        tks = [
            _CoalesceTicket(0, 1, 4, trace=d1),
            _CoalesceTicket(1, 1, 4, trace=d2),
        ]
        tks[0].values = _FusedValues(np.zeros(8, np.int32),
                                     lambda a: a.copy())
        assert pipe.submit(tks)
        for tk in tks:
            assert tk.done.wait(5) and tk.error is None
        deadline = time.monotonic() + 5
        while (
            "dispatch_wait" not in {s["stage"]
                                    for s in _spans_since(RECORDER, t0)}
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
    finally:
        pipe.close()
    by_stage = {s["stage"]: s for s in _spans_since(RECORDER, t0)}
    issue, wait = by_stage["dispatch_issue"], by_stage["dispatch_wait"]
    assert issue["trace_id"] == d1.trace_id
    assert issue["parent_id"] == d1.span_id
    assert issue["links"] == [[d2.trace_id, d2.span_id]]
    assert issue["thread"] == "dispatch-pack"
    assert wait["trace_id"] == d1.trace_id  # identical across the handoff
    assert wait["parent_id"] == issue["span_id"]
    assert wait["links"] == issue["links"]
    assert wait["thread"] == "dispatch-decode"
    assert issue["seq"] == wait["seq"] and issue["width"] == wait["width"] == 2
    # Reconstructed by the JAX package's analyzer: both owners' traces
    # see the shared spans.
    spans = [
        s for s in _spans_since(RECORDER, t0)
        if s.get("trace_id") in (d1.trace_id, d2.trace_id)
    ]
    traces = cp.group_traces(spans)
    assert {s["stage"] for s in traces[d2.trace_id]} >= {
        "dispatch_issue", "dispatch_wait",
    }


def test_a_ticket_without_a_trace_keeps_the_links(tel_enabled):
    """A fused dispatch whose first ticket has no trace (telemetry
    turned on mid-run): the shared span parents under the first ticket
    that has one and links the rest, in ticket order."""
    d2 = tracing.new_trace().child()
    d3 = tracing.new_trace().child()
    t0 = time.monotonic()
    pipe = _AsyncDispatchPipeline(_StubSvc())
    try:
        tks = [_CoalesceTicket(0, 1, 4), _CoalesceTicket(1, 1, 4, trace=d2),
               _CoalesceTicket(2, 1, 4, trace=d3)]
        tks[0].values = _FusedValues(np.zeros(8, np.int32),
                                     lambda a: a.copy())
        assert pipe.submit(tks)
        deadline = time.monotonic() + 5
        while (
            "dispatch_wait" not in {s["stage"]
                                    for s in _spans_since(RECORDER, t0)}
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
    finally:
        pipe.close()
    by_stage = {s["stage"]: s for s in _spans_since(RECORDER, t0)}
    issue, wait = by_stage["dispatch_issue"], by_stage["dispatch_wait"]
    assert (issue["trace_id"], issue["parent_id"]) == (d2.trace_id,
                                                       d2.span_id)
    assert issue["links"] == wait["links"] == [[d3.trace_id, d3.span_id]]
    assert wait["parent_id"] == issue["span_id"]


# -- end-to-end gated smokes ---------------------------------------------------


class _Gated(SearchService):
    """A service whose driver parks after its warm-up until the gate
    opens, so every submission lands in one drain pass
    (tests/test_async_dispatch.py's ``_GatedService``)."""

    def __init__(self, *args, **kwargs):
        self.gate = threading.Event()
        super().__init__(*args, **kwargs)

    def warmup(self):
        super().warmup()
        self.gate.wait()


def _port_run(fens, nodes):
    """tests/test_async_dispatch.py's ``_smoke_run`` on the port's CPU
    service: the same settings, a cold eval cache, prefetch pinned."""
    eval_cache.reset_cache()
    svc = _Gated(weights=NnueWeights.random(seed=7), device="cpu",
                 pool_slots=8, batch_capacity=256, tt_bytes=8 << 20,
                 pipeline_depth=4, driver_threads=1)
    try:
        svc.set_prefetch(0, adaptive=False)

        async def go():
            tasks = [asyncio.ensure_future(svc.search(fen, [], nodes=nodes))
                     for fen in fens]
            await asyncio.sleep(0.3)
            svc.gate.set()
            return await asyncio.gather(*tasks)

        results = asyncio.run(go())
        analyses = [(r.best_move, r.depth, r.nodes,
                     tuple((l.multipv, l.depth, l.is_mate, l.value,
                            tuple(l.pv)) for l in r.lines))
                    for r in results]
        return analyses, svc.counters(), bool(svc._async_pipes)
    finally:
        svc.gate.set()
        svc.close()


def _step_traces(spans):
    return {
        tid: sp for tid, sp in cp.group_traces(spans).items()
        if any(s["stage"] == "pack" for s in sp)
    }


def _jax_stages(fens, nodes):
    """The stage set of the JAX service's spans on the same searches."""
    jax_telemetry.enable()
    try:
        t0 = time.monotonic()
        _smoke_run(JaxWeights.random(seed=7), fens=fens, nodes=nodes)
    finally:
        jax_telemetry.disable()
    return {s["stage"] for s in _spans_since(JAX_RECORDER, t0)}


@pytest.mark.parametrize("path", ["async", "sync"])
def test_step_traces_match_the_jax_service(monkeypatch, path):
    """tests/test_tracing.py's gated smokes on the port: every eval
    microbatch yields one complete step trace (one ``pack`` root, then
    device_step, wire_decode and postprocess) with zero orphans under
    the JAX package's ``critical_path.orphan_spans`` and coverage >=
    0.95 under its ``report``; on the async path the shared dispatch
    spans come from the dispatch-pack and dispatch-decode threads. The
    stage set equals the JAX service's on the same searches, and the
    analyses with spans on equal those with spans off, bit for bit."""
    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "2")
    if path == "sync":
        monkeypatch.setenv("FISHNET_NO_ASYNC", "1")
    fens, nodes = _SMOKE_FENS[:4], 150
    t_off = time.monotonic()
    off, c_off, is_async = _port_run(fens, nodes)
    assert is_async == (path == "async")
    assert _spans_since(RECORDER, t_off) == [], "spans recorded while off"
    telemetry.enable()
    try:
        t0 = time.monotonic()
        on, c_on, _ = _port_run(fens, nodes)
    finally:
        telemetry.disable()
    assert on == off
    assert c_on["dispatches"] == c_off["dispatches"]

    spans = _spans_since(RECORDER, t0)
    stages = {s["stage"] for s in spans}
    assert stages == _jax_stages(fens, nodes)
    want = {"pack", "device_step", "wire_decode", "postprocess", "coalesce"}
    if path == "async":
        want |= {"dispatch_issue", "dispatch_wait"}
    assert stages >= want
    traced = [s for s in spans if "trace_id" in s]
    assert cp.orphan_spans(traced) == [], "orphan spans in a gated run"
    step = _step_traces(traced)
    assert len(step) > 3
    for tid, sp in step.items():
        roots = [s for s in sp if s["stage"] == "pack"]
        assert len(roots) == 1 and roots[0]["span_id"] == tid
        assert {s["stage"] for s in sp} >= {
            "pack", "device_step", "wire_decode", "postprocess",
        }
    issues = [s for s in spans if s["stage"] == "dispatch_issue"]
    if path == "async":
        threads = {
            s["thread"] for sp in step.values() for s in sp
            if s["stage"] in ("device_step", "dispatch_issue",
                              "dispatch_wait")
        }
        assert {"dispatch-pack", "dispatch-decode"} <= threads
        # One dispatch_issue per device dispatch, each paired with its
        # dispatch_wait by seq.
        waits = {s["seq"] for s in spans if s["stage"] == "dispatch_wait"}
        assert len(issues) == c_on["dispatches"]
        assert {s["seq"] for s in issues} == waits
    else:
        assert issues == []
    for s in spans:
        if s["stage"] == "coalesce":
            assert len(s["links"]) == s["width"] - 1
            assert len(s["groups"]) == s["width"]
    rep = cp.report(traced)
    assert rep["traces"] > 0
    assert rep["coverage"] >= 0.95, rep
