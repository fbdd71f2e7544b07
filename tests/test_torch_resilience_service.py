"""The port's device-side fault sites against the JAX package's, on the
CPU: ``service.device_step`` (the supervisor's ladder forced by plans,
the async pipeline, the serving mesh's per-shard ladder with the
exactly-once ledger and the eval cache live) and ``rpc.detach`` (the
split plane's evaluator host dropping a link mid-flight).

Searches are deterministic functions of their submissions (one driver
thread, a pinned prefetch budget, gated submissions on the mesh as in
tests/test_torch_mesh.py), and the NNUE is integer arithmetic, so every
analysis comparison is exact: no tolerance."""

import asyncio
import os
import subprocess
import sys

import pytest
import torch

from fishnet_tpu.engine.tpu_engine import TpuNnueEngineFactory as JaxFactory
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.resilience import accounting as jax_accounting
from fishnet_tpu.resilience import faults as jax_faults
from fishnet_tpu.resilience.supervisor import ServiceSupervisor as JaxSupervisor
from fishnet_tpu.rpc import rings as jax_rings
from fishnet_tpu.rpc.host import EvaluatorHost as JaxHost
from fishnet_tpu.search import service as jax_service
from fishnet_tpu.utils.logger import Logger as JaxLogger
from fishnet_tpu_torch.chess.core import NativeCoreError
from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.protocol.types import EngineFlavor
from fishnet_tpu_torch.resilience import accounting, faults
from fishnet_tpu_torch.resilience.supervisor import (
    ServiceSupervisor,
    ladder_for,
)
from fishnet_tpu_torch.rpc import rings
from fishnet_tpu_torch.rpc.client import RemoteBackend
from fishnet_tpu_torch.rpc.host import EvaluatorHost
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.utils.logger import Logger
from test_torch_mesh import _FENS, GATED_KW, NODES, _gated
from test_torch_rpc import _COMMON, ROOT, _analyses, _delta, _swept

TWO = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def _clean_state():
    eval_cache.reset_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for pkg in (faults, accounting, jax_faults, jax_accounting):
        pkg.clear()
    eval_cache.reset_cache()


# -- the supervisor's ladder, forced by plans -------------------------------

_LADDER_FENS = (
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
    "r1bqkbnr/pppp1ppp/2n5/4p3/2B1P3/5N2/PPPP1PPP/RNBQK2R b KQkq - 3 3",
    "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1",
    "8/2k5/3p4/p2P1p2/P2P1P2/8/8/4K3 w - - 0 1",
)
#: A position the rungs' searches never reach: a repeat would be
#: answered from the TT without a dispatch, and the fault would not fire.
_FRESH = "rnbqkb1r/pppppppp/5n2/8/3P4/8/PPP1PPPP/RNBQKBNR w KQkq - 1 2"
_LADDER_KW = dict(pool_slots=16, batch_capacity=64, tt_bytes=8 << 20,
                  pipeline_depth=1, driver_threads=1)


async def _rung_results(svc):
    svc.set_prefetch(0, adaptive=False)
    out = []
    for fen in _LADDER_FENS:
        r = await svc.search(fen, [], depth=1)
        line = [ln for ln in r.lines if ln.multipv == 1][-1]
        out.append((fen, line.value, line.is_mate, r.best_move, r.nodes))
    return out


async def _forced_ladder(port: bool):
    """Walk the CPU ladder xla -> host-material through real
    ``service.device_step`` crashes (the supervisor and the engine
    factory's respawn path), searching the same positions on each
    rung."""
    if port:
        weights = NnueWeights.random(seed=21)
        sup = ServiceSupervisor(
            lambda rung: SearchService(weights=weights, device="cpu",
                                       psqt_path=rung, **_LADDER_KW),
            rungs=ladder_for("cpu"), degrade_after=1, logger=Logger())
        factory, fmod = TpuNnueEngineFactory(service_builder=sup.build), faults
    else:
        weights = JaxWeights.random(seed=21)
        sup = JaxSupervisor(
            lambda rung: jax_service.SearchService(
                weights=weights, backend="jax", psqt_path=rung,
                **_LADDER_KW),
            start_rung="xla", degrade_after=1, logger=JaxLogger())
        factory, fmod = JaxFactory(service_builder=sup.build), jax_faults
    results, rungs = {}, []
    try:
        for expected in ("xla", "host-material"):
            engine = await factory.create(EngineFlavor.OFFICIAL)
            rungs.append((sup.rung, engine.service.psqt_path))
            results[expected] = await _rung_results(engine.service)
            if expected != "host-material":
                fmod.install("service.device_step:nth=1:crash")
                with pytest.raises(Exception, match="search driver crashed"):
                    await engine.service.search(_FRESH, [], depth=3)
                fmod.clear()
                assert not engine.service.is_alive()
    finally:
        factory.close()
    return results, rungs, sup.respawns


@pytest.mark.anyio
async def test_ladder_forced_by_plans_is_bit_identical_to_the_jax_package(
        monkeypatch):
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    port = await _forced_ladder(True)
    assert port == await _forced_ladder(False)
    results, rungs, respawns = port
    assert results["xla"] == results["host-material"]
    assert rungs == [("xla", "xla"), ("host-material", "host-material")]
    assert respawns == 1


async def _async_fault(port: bool):
    if port:
        weights = NnueWeights.random(seed=21)
        sup = ServiceSupervisor(
            lambda rung: SearchService(
                weights=weights, device="cpu", psqt_path=rung, pool_slots=8,
                batch_capacity=256, tt_bytes=8 << 20, pipeline_depth=4,
                driver_threads=1),
            rungs=ladder_for("cpu"), degrade_after=1, logger=Logger())
        fmod = faults
    else:
        weights = JaxWeights.random(seed=21)
        sup = JaxSupervisor(
            lambda rung: jax_service.SearchService(
                weights=weights, backend="jax", psqt_path=rung, pool_slots=8,
                batch_capacity=256, tt_bytes=8 << 20, pipeline_depth=4,
                driver_threads=1),
            start_rung="xla", degrade_after=1, logger=JaxLogger())
        fmod = jax_faults
    svc = sup.build()
    try:
        pipes = svc._async_pipes if port else [svc._async_pipe]
        assert pipes and pipes[0] is not None
        fmod.install("service.device_step:nth=1:crash")
        with pytest.raises(Exception, match="search driver crashed") as err:
            await svc.search(_FRESH, [], depth=3)
        if port:
            assert isinstance(err.value, NativeCoreError)
        fmod.clear()
        assert not svc.is_alive()
    finally:
        svc.close()
    svc2 = sup.build()
    try:
        svc2.set_prefetch(0, adaptive=False)
        r = await svc2.search(_FRESH, [], depth=2)
        return sup.rung, svc2.psqt_path, (
            r.best_move, r.depth, r.nodes,
            tuple((ln.multipv, ln.depth, ln.value, tuple(ln.pv))
                  for ln in r.lines))
    finally:
        svc2.close()


@pytest.mark.anyio
async def test_device_step_fault_under_the_async_pipeline_degrades_the_ladder(
        monkeypatch):
    """tests/test_async_dispatch.py's fault case: the site fires on the
    driver thread with the async pipeline up, the error reaches the
    owner, the service reads dead, the supervisor rebuilds one rung
    down, and the rebuilt service searches as the JAX one does."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    port = await _async_fault(True)
    assert port == await _async_fault(False)
    assert port[:2] == ("host-material", "host-material")
    assert port[2][0] is not None


# -- the mesh: a shard-local degradation, the ledger, the cache ----------------


def _mesh_run(svc, fmod, amod, plan, tag):
    """The four searches through a gated mesh service under ``plan``,
    each acquired and submitted through the ledger; returns the
    analyses and the shard report."""
    led = amod.get()
    try:
        svc.set_prefetch(0, adaptive=False)

        async def go():
            async def one(i, fen):
                led.record_acquired(f"{tag}-{i}")
                r = await svc.search(fen, [], nodes=NODES)
                led.record_submitted(f"{tag}-{i}")
                return r

            tasks = [asyncio.ensure_future(one(i, f))
                     for i, f in enumerate(_FENS)]
            await asyncio.sleep(0.3)
            if plan:
                fmod.install(plan)
            svc.gate.set()
            try:
                return await asyncio.gather(*tasks)
            finally:
                fmod.clear()

        results = asyncio.run(go())
        return ([(r.best_move, r.depth, r.nodes,
                  tuple((ln.multipv, ln.depth, ln.is_mate, ln.value,
                         tuple(ln.pv)) for ln in r.lines))
                 for r in results], svc.shard_report())
    finally:
        svc.gate.set()
        svc.close()


def _port_mesh(plan, tag, mesh_devices=TWO):
    return _mesh_run(_gated(SearchService)(
        weights=NnueWeights.random(seed=7), device="cpu",
        mesh_devices=mesh_devices, **GATED_KW), faults, accounting, plan, tag)


def test_a_device_fault_on_the_mesh_degrades_one_shard_as_jax(monkeypatch):
    """``service.device_step:nth=2:error`` on two shards: the group's
    shard steps one rung down and its sibling's rung never moves; the
    step is dispatched on the degraded path, so the analyses equal the
    single-device run and the JAX mesh's under the same plan, and the
    ledger is clean."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    plan = "service.device_step:nth=2:error"
    led = accounting.install()
    single, _ = _port_mesh(None, "one", mesh_devices=None)
    two, rep = _port_mesh(plan, "two")
    jled = jax_accounting.install()
    ref, jrep = _mesh_run(_gated(jax_service.SearchService)(
        weights=JaxWeights.random(seed=7), backend="jax", mesh_devices=2,
        **GATED_KW), jax_faults, jax_accounting, plan, "two")
    assert two == ref == single
    # The same group's shard stepped down in both packages.
    assert rep["rungs"] == jrep["rungs"] and rep["alive"] == jrep["alive"]
    assert rep["groups"] == jrep["groups"]
    assert len(rep["degradations"]) == 1
    shard, frm, to = rep["degradations"][0]
    assert (frm, to) == ("xla", "host-material")
    assert rep["rungs"][shard] == "host-material"
    assert rep["rungs"][1 - shard] == "xla" and all(rep["alive"])
    assert led.assert_clean()["submitted"] == 2 * len(_FENS)
    assert jled.assert_clean() == {
        **led.report(), "batches": len(_FENS), "submitted": len(_FENS)}


def test_mesh_ledger_clean_under_device_faults_with_the_cache_live(
        monkeypatch):
    """tests/test_eval_cache.py's fault case on the port: two injected
    device-step errors mid-traffic on two shards, with the eval cache
    off and then live (cold, then warm): every search lands exactly
    once, and the cache-on analyses equal the cache-off ones under the
    same faults, the fault-free run's and the JAX mesh's under the same
    plan with its cache live."""
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    plan = "service.device_step:nth=2:error;service.device_step:nth=5:error"
    led = accounting.install()
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    clean, _ = _port_mesh(None, "clean")
    off, rep_off = _port_mesh(plan, "f-off")
    monkeypatch.delenv("FISHNET_NO_EVAL_CACHE")
    eval_cache.reset_cache()
    on, rep_on = _port_mesh(plan, "f-on")
    warm, _ = _port_mesh(plan, "f-warm")
    assert eval_cache.get_cache() is not None and len(eval_cache.get_cache())
    jled = jax_accounting.install()
    ref, _ = _mesh_run(_gated(jax_service.SearchService)(
        weights=JaxWeights.random(seed=7), backend="jax", mesh_devices=2,
        **GATED_KW), jax_faults, jax_accounting, plan, "jax")
    assert jled.assert_clean()["submitted"] == len(_FENS)
    assert on == off == warm == clean == ref
    assert len(rep_off["degradations"]) == 2
    assert len(rep_on["degradations"]) == 2
    assert led.assert_clean()["submitted"] == 4 * len(_FENS)


# -- rpc.detach on the split plane ---------------------------------------------


def test_rpc_detach_site_drops_and_reattaches_one_link_as_jax(tmp_path):
    """The host drops one live link on the matched sweep (the file
    kept) and re-attaches it on the next, as the JAX host does; with no
    link attached the site is not polled."""
    def run(rmod, host_cls, fmod, where):
        where.mkdir()
        host = host_cls(rpc_dir=str(where))
        before = rmod.stats()
        fmod.install("rpc.detach:nth=1:error")
        try:
            host.sweep()  # no link yet: the site is not polled
            assert fmod.current().counts()["rpc.detach"] == 0
            front = rmod.create_frontend_link(str(where), name="fa.ring")
            host.sweep()  # attaches, then the injected detach fires
            seen = [len(host._links), os.path.exists(front.path)]
            host.sweep()  # nth=1 spent: re-attached, serving
            seen.append(len(host._links))
            after = rmod.stats()
            seen += [after.get(k, 0) - before.get(k, 0)
                     for k in ("detach.fault", "attach.host")]
            seen.append(fmod.current().counts()["rpc.detach"])
            front.close()
            return seen
        finally:
            fmod.clear()
            host.close()

    port = run(rings, lambda rpc_dir: EvaluatorHost(rpc_dir=rpc_dir,
                                                    device="cpu"),
               faults, tmp_path / "port")
    assert port == run(jax_rings, JaxHost, jax_faults, tmp_path / "jax")
    assert port == [0, True, 1, 1, 2, 2]


@pytest.fixture
def parity_env(monkeypatch):
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.setenv("FISHNET_NO_BOUNDS", "1")


def test_rpc_detach_mid_flight_resubmits_and_keeps_the_analyses(
        tmp_path, parity_env):
    """An in-process host under ``rpc.detach:every=40:error`` drops the
    frontend's link every 40th sweep, also while a microbatch is in
    flight (the sweeps before the first submission count too, so a
    single early ``nth`` would land before any): the frontend sees the
    epoch move, resubmits, and searches exactly as the monolith."""
    weights = NnueWeights.random(seed=7)
    mono = _analyses(SearchService(weights=weights, device="cpu", **_COMMON))
    host = EvaluatorHost(nnue_params=params_from_weights(weights, "cpu"),
                         rpc_dir=str(tmp_path), device="cpu")
    host.warmup()
    before = rings.stats()
    faults.install("rpc.detach:every=40:error")
    with _swept(host):
        split = _analyses(RemoteBackend(weights=weights,
                                        rpc_dir=str(tmp_path), **_COMMON))
    assert split == mono
    detaches = _delta(before, "detach.fault")
    assert detaches == faults.current().counts()["rpc.detach"] // 40 >= 1
    assert _delta(before, "resubmits") >= 1


def test_rpc_detach_in_a_host_process_from_the_plan_env(tmp_path, parity_env):
    """``python -m fishnet_tpu_torch.rpc.host`` reads FISHNET_FAULT_PLAN:
    its detach makes this frontend resubmit, and the analyses equal the
    monolith's. A bad plan in the env refuses to start."""
    weights = NnueWeights.random(seed=7)
    wpath = tmp_path / "w.nnue"
    weights.save(str(wpath))
    mono = _analyses(SearchService(weights=weights, device="cpu", **_COMMON))
    cmd = [sys.executable, "-m", "fishnet_tpu_torch.rpc.host", "--dir",
           str(tmp_path / "rpc"), "--nnue-file", str(wpath), "--device",
           "cpu", "--poll", "0.001"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    bad = subprocess.run(cmd, env={**env, faults.PLAN_ENV: "rpc.detach:x"},
                         cwd=ROOT, capture_output=True, timeout=120)
    assert bad.returncode == 2 and b"FISHNET_FAULT_PLAN" in bad.stderr
    host = subprocess.Popen(
        cmd, env={**env, faults.PLAN_ENV: "rpc.detach:every=40:error"},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    before = rings.stats()
    try:
        split = _analyses(RemoteBackend(weights=weights,
                                        rpc_dir=str(tmp_path / "rpc"),
                                        **_COMMON))
    finally:
        host.terminate()
        try:
            _, err = host.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            host.kill()
            _, err = host.communicate(timeout=20)
    assert host.returncode == 0, err.decode()[-2000:]
    assert split == mono
    assert _delta(before, "resubmits") >= 1
