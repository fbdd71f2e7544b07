"""The port's cost attribution (fishnet_tpu_torch.telemetry.cost and its
call sites in the search service, the coalescer, the async pipeline and
the AZ plane) against the JAX package's, on the CPU:
tests/test_profiler.py's ledger and attribution tests.

The ledger's arithmetic equals the JAX ledger's on the same seeded note
sequences, and so does its families' exposition. A two-tenant run of the
port's gated service (one driver thread, the eval cache on) attributes
the same owner table, ticket by ticket and in the same order, as the
JAX service on the same searches, with the same per-tenant cache hits;
the per-tenant device ms sum to the measured total within 2% (the JAX
test's gate) on the async path, the sync path and the solo dispatch.

Wire bytes: each package attributes its own wire. The port ships the
emitted rows (``rows + 4``) and the entry offsets where the JAX package
ships its padded row tier, so the byte counts differ by format; the
port's per-tenant bytes sum to its own ``wire_bytes`` counter, as the
JAX package's do to its own. Every test leaves both packages' planes
off and their ledgers zeroed."""

import asyncio
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.search import service as jax_service
from fishnet_tpu.telemetry import cost as jax_cost
from fishnet_tpu.telemetry import profiler as jax_profiler
from fishnet_tpu.telemetry import registry as jax_registry
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.telemetry import REGISTRY, cost, profiler
from fishnet_tpu_torch.telemetry.registry import MetricsRegistry
from tests.test_async_dispatch import _SMOKE_FENS


def _all_off():
    for prof, led in ((profiler, cost), (jax_profiler, jax_cost)):
        prof.stop()
        led.disable()
        led.reset()


@pytest.fixture(autouse=True)
def disarmed():
    """Both packages' planes off and ledgers zeroed, before and after
    (the JAX package's tests/test_profiler.py pins the off state)."""
    _all_off()
    eval_cache.reset_cache()
    yield
    _all_off()
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the ledger -------------------------------------------------------------

TENANTS = ("lichess", "backfill", "", "t3")
FAMILIES = ("analysis", "best-move", "selfplay")


def _owners(rng):
    if rng.random() < 0.1:
        return None
    return [((str(rng.choice(TENANTS)), str(rng.choice(FAMILIES))),
             int(rng.integers(-1, 9)))
            for _ in range(int(rng.integers(0, 4)))]


def _acct(rng):
    kind = rng.integers(0, 3)
    if kind == 0:
        return (int(rng.integers(1, 64)), int(rng.integers(0, 9000)),
                int(rng.integers(0, 900)))
    if kind == 1:
        return {"n": 3, "wire_bytes": int(rng.integers(0, 9000))}
    return None


def _notes(seed: int):
    """A seeded sequence of the three kinds of note."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(int(rng.integers(5, 40))):
        kind = rng.integers(0, 3)
        if kind == 0:
            ops.append(("dispatch", _owners(rng), int(rng.integers(0, 20)),
                        int(rng.integers(0, 1 << 16)),
                        float(rng.uniform(0, 0.05))))
        elif kind == 1:
            ops.append(("hits", _owners(rng) or []))
        else:
            tickets = [dict(rows=int(rng.integers(0, 40)),
                            n=int(rng.integers(0, 30)), acct=_acct(rng),
                            owners=_owners(rng))
                       for _ in range(int(rng.integers(1, 5)))]
            ops.append(("tickets", tickets, float(rng.uniform(0, 0.05))))
    return ops


def _apply(mod, ops):
    for op in ops:
        if op[0] == "dispatch":
            mod.note_dispatch(*op[1:])
        elif op[0] == "hits":
            mod.note_cache_hits(op[1])
        else:
            mod.note_tickets([SimpleNamespace(**t) for t in op[1]], op[2])
    return mod.LEDGER.snapshot()


@pytest.mark.parametrize("seed", range(12))
def test_ledger_arithmetic_equals_jax(seed):
    ops = _notes(seed)
    got, ref = _apply(cost, ops), _apply(jax_cost, ops)
    assert got == ref
    assert sum(got["tenant_device_ms"].values()) == pytest.approx(
        got["total_device_ms"], rel=1e-9, abs=1e-9)


def _families(fams):
    return [(f.name, f.type, f.help,
             [(s.name, s.value, s.labels) for s in f.samples]) for f in fams]


@pytest.mark.parametrize("seed", range(4))
def test_ledger_families_and_exposition_equal_jax(seed):
    ops = _notes(seed)
    mine, theirs = cost.CostLedger(), jax_cost.CostLedger()
    for led in (mine, theirs):
        for op in ops:
            if op[0] == "dispatch":
                led.note_dispatch(*op[1:])
            elif op[0] == "hits":
                led.note_cache_hits(op[1])
    assert _families(mine.collect()) == _families(theirs.collect())
    reg, jreg = MetricsRegistry(), jax_registry.MetricsRegistry()
    reg.register_collector(mine.collect, name="cost-attribution")
    jreg.register_collector(theirs.collect, name="cost-attribution")
    assert reg.render_prometheus() == jreg.render_prometheus()
    doc, ref = reg.render_json(), jreg.render_json()
    assert doc["metrics"] == ref["metrics"]


def test_jax_ledger_unit_cases():
    """tests/test_profiler.py's ledger cases on the port's ledger."""
    led = cost.CostLedger()
    led.note_dispatch(
        [(("lichess", "analysis"), 3), (("backfill", "selfplay"), 1)],
        rows=4, wire_bytes=4096, duration_s=0.010)
    snap = led.snapshot()
    assert snap["tenant_device_ms"]["lichess"] == pytest.approx(7.5)
    assert snap["tenant_device_ms"]["backfill"] == pytest.approx(2.5)
    assert snap["family_device_ms"]["selfplay"] == pytest.approx(2.5)
    assert snap["tenant_wire_bytes"]["lichess"] == pytest.approx(3072)
    led.note_dispatch([(("a", "analysis"), 2)], rows=8, wire_bytes=0,
                      duration_s=0.008)
    assert led.snapshot()["tenant_device_ms"]["unknown"] == pytest.approx(6.0)
    led.note_dispatch([(("", "analysis"), 1)], rows=1, wire_bytes=16,
                      duration_s=0.001)
    assert "default" in led.snapshot()["tenant_device_ms"]
    assert cost.UNKNOWN_OWNER == jax_cost.UNKNOWN_OWNER
    assert cost.DEFAULT_TENANT == jax_cost.DEFAULT_TENANT


@pytest.mark.parametrize("acct", [(64, 100, 7), (1, 2), {"wire_bytes": 9},
                                  {"n": 3}, None, [1, 2, 3]])
def test_acct_wire_bytes_equals_jax(acct):
    assert cost._acct_wire_bytes(acct) == jax_cost._acct_wire_bytes(acct)


def test_gate_and_collector_registration():
    """Off by default; ``enable`` registers the collector once a
    process, so the families appear once however often it is called;
    ``disable`` closes the gate and keeps the series."""
    assert not cost.enabled()
    cost.enable()
    cost.enable()
    assert cost.enabled()
    cost.note_dispatch([(("x", "analysis"), 1)], 1, 64, 0.001)
    names = [f.name for f in REGISTRY.collect()]
    assert names.count("fishnet_cost_device_ms_total") == 1
    cost.disable()
    assert not cost.enabled()
    assert "fishnet_tenant_device_ms_total" in {
        f.name for f in REGISTRY.collect()}


# -- the call sites, against the JAX service ----------------------------------


def _gated(base):
    class Gated(base):
        """The driver parks after its warm-up until the gate opens, so
        every submission lands in one drain pass
        (tests/test_coalesce.py's discipline)."""

        def __init__(self, *args, **kwargs):
            self.gate = threading.Event()
            super().__init__(*args, **kwargs)

        def warmup(self):
            super().warmup()
            self.gate.wait()

    return Gated


GATED_KW = dict(pool_slots=8, batch_capacity=256, tt_bytes=8 << 20,
                pipeline_depth=4, driver_threads=1)
#: Two waves of the same four positions, each on a fresh gated service
#: and the tenants swapped in the second: the process-wide eval cache
#: then answers the second wave's entries (credited as cache hits).
WAVES = [[(fen, ("lichess", "backfill")[(i + w) % 2])
          for i, fen in enumerate(_SMOKE_FENS[:4])] for w in (0, 1)]
NODES = 100
#: Service counters summed over the waves.
SUMMED = ("eval_steps", "dispatches", "fused_dispatches", "wire_bytes",
          "cache_prewire_hits")


def _recorded(mod):
    """Wrap ``mod.LEDGER.note_dispatch`` to keep each record's (owners,
    rows, wire bytes); returns the list and the undo."""
    calls = []
    orig = mod.LEDGER.note_dispatch

    def note(owners, rows, wire_bytes, duration_s):
        calls.append((sorted(owners or []), int(rows), int(wire_bytes)))
        return orig(owners, rows, wire_bytes, duration_s)

    mod.LEDGER.note_dispatch = note
    return calls, lambda: delattr(mod.LEDGER, "note_dispatch")


def _wave(svc, searches):
    try:
        svc.set_prefetch(0, adaptive=False)

        async def go():
            tasks = [asyncio.ensure_future(svc.search(fen, [], nodes=NODES,
                                                      tenant=tenant))
                     for fen, tenant in searches]
            await asyncio.sleep(0.3)
            svc.gate.set()
            return await asyncio.gather(*tasks)

        results = asyncio.run(go())
        return results, svc.counters()
    finally:
        svc.gate.set()
        svc.close()


def _tenant_run(make, mod):
    """Both waves with ``mod``'s cost plane on (``make()`` builds each
    wave's service); returns the analyses, the summed service counters,
    the ledger snapshot and the records."""
    calls, undo = _recorded(mod)
    mod.enable()
    results, counters = [], dict.fromkeys(SUMMED, 0)
    try:
        for searches in WAVES:
            got, c = _wave(make(), searches)
            results += got
            for key in SUMMED:
                counters[key] += c[key]
    finally:
        mod.disable()
        undo()
    analyses = [(r.best_move, r.depth, r.nodes, tuple(
        (l.multipv, l.depth, l.is_mate, l.value, tuple(l.pv))
        for l in r.lines)) for r in results]
    return analyses, counters, mod.LEDGER.snapshot(), calls


#: path -> the env of the run: the async pipeline (the default), the
#: sync path, and the solo dispatch without a coalescer.
PATHS = {
    "async": {"FISHNET_COALESCE_WIDTH": "2"},
    "sync": {"FISHNET_COALESCE_WIDTH": "2", "FISHNET_NO_ASYNC": "1"},
    "solo": {"FISHNET_NO_COALESCE": "1"},
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_two_tenants_attribute_as_the_jax_service(monkeypatch, path):
    for var, value in PATHS[path].items():
        monkeypatch.setenv(var, value)
    eval_cache.reset_cache()
    got, c, snap, calls = _tenant_run(
        lambda: _gated(SearchService)(weights=NnueWeights.random(seed=7),
                                      device="cpu", **GATED_KW), cost)
    from fishnet_tpu.search import eval_cache as jax_cache

    jax_cache.reset_cache()
    ref, jc, jsnap, jcalls = _tenant_run(
        lambda: _gated(jax_service.SearchService)(
            weights=JaxWeights.random(seed=7), backend="jax", **GATED_KW),
        jax_cost)
    jax_cache.reset_cache()
    assert got == ref
    assert c["eval_steps"] == jc["eval_steps"]
    # The owner table of every record, in order, equals the JAX one's.
    assert [o[:2] for o in calls] == [o[:2] for o in jcalls]
    assert snap["tenant_cache_hits"] == jsnap["tenant_cache_hits"]
    assert set(snap["tenant_cache_hits"]) == {"lichess", "backfill"}
    assert sum(snap["tenant_cache_hits"].values()) == c[
        "cache_prewire_hits"] == jc["cache_prewire_hits"]
    assert snap["dispatches"] == jsnap["dispatches"] == len(calls)
    # One record a ticket: each stepped microbatch is one.
    assert snap["dispatches"] == c["eval_steps"]
    if path == "solo":
        assert c["dispatches"] == c["eval_steps"]
    else:
        assert c["fused_dispatches"] > 0
        assert c["dispatches"] < snap["dispatches"]
    attributed = sum(snap["tenant_device_ms"].values())
    assert snap["total_device_ms"] > 0
    assert attributed == pytest.approx(snap["total_device_ms"], rel=0.02)
    for tenant in ("lichess", "backfill"):
        assert snap["tenant_device_ms"].get(tenant, 0) > 0
        assert snap["tenant_wire_bytes"].get(tenant, 0) > 0
    assert set(snap["family_device_ms"]) == {"analysis"}
    assert sum(snap["tenant_wire_bytes"].values()) == pytest.approx(
        c["wire_bytes"])
    assert sum(jsnap["tenant_wire_bytes"].values()) == pytest.approx(
        jc["wire_bytes"])
    assert sum(w for *_, w in calls) == c["wire_bytes"]


def test_plane_off_builds_no_owner_table(monkeypatch):
    """With the plane off no record is made and no ticket carries
    owners."""
    from fishnet_tpu_torch.search import coalesce

    seen = []
    orig = coalesce._DispatchCoalescer.submit

    def submit(self, *args, **kwargs):
        seen.append(kwargs.get("owners"))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(coalesce._DispatchCoalescer, "submit", submit)
    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "2")
    svc = _gated(SearchService)(weights=NnueWeights.random(seed=7),
                                device="cpu", **GATED_KW)
    try:
        svc.set_prefetch(0, adaptive=False)

        async def go():
            task = asyncio.ensure_future(svc.search(_SMOKE_FENS[0], [],
                                                    nodes=60, tenant="x"))
            await asyncio.sleep(0.1)
            svc.gate.set()
            return await task

        asyncio.run(go())
    finally:
        svc.gate.set()
        svc.close()
    assert seen and all(o is None for o in seen)
    assert cost.LEDGER.snapshot()["dispatches"] == 0


def test_az_plane_traffic_lands_on_selfplay():
    """The AZ plane's tickets carry ``[((cost_tenant, "selfplay"), n)]``
    (the JAX plane's owners): every attributed row and ms lands on the
    selfplay tenant and family, and the rows equal the plane's."""
    from fishnet_tpu_torch.models.az import AzConfig, init_az_params
    from fishnet_tpu_torch.search.az_plane import AzDispatchPlane
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool
    from tests.test_torch_az_plane import run_workload

    tiny = AzConfig(channels=16, blocks=2, value_hidden=16)
    params = init_az_params(3, tiny)
    cfg = MctsConfig(batch_capacity=64, az=tiny)
    calls, undo = _recorded(cost)
    cost.enable()
    plane = AzDispatchPlane(params, cfg, device="cpu")
    pool = MctsPool(params, cfg, evaluator=plane, device="cpu")
    try:
        run_workload(pool, visits=40, trees=4)
        rows = plane.counters()["rows_dispatched"]
    finally:
        pool.close()
        plane.close()
        cost.disable()
        undo()
    snap = cost.LEDGER.snapshot()
    assert calls and all(o == [(("selfplay", "selfplay"), r)]
                         for o, r, _ in calls)
    assert sum(r for _, r, _ in calls) == rows > 0
    assert set(snap["tenant_device_ms"]) == {"selfplay"}
    assert set(snap["family_device_ms"]) == {"selfplay"}
    assert snap["tenant_wire_bytes"]["selfplay"] > 0
    assert snap["tenant_device_ms"]["selfplay"] == pytest.approx(
        snap["total_device_ms"], rel=0.02)
