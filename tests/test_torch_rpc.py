"""The port's split evaluator plane (fishnet_tpu_torch.rpc) on the CPU.

Transport: ports of the JAX package's ring tests (wraparound and flow
control at two slots, a record too large, a torn record read as a miss,
a stale epoch refused after a frontend restart, evaluator death as a
demand timeout, an evaluator restart resubmitting the in-flight ticket),
and the link format, byte for byte, against ``fishnet_tpu.rpc.rings``.

Evaluation: the port's host backend against the JAX host backend on
seeded fused segments (full and in-batch delta entries, padding); a
``RemoteBackend`` served by a port ``EvaluatorHost`` (in process,
driven through ``sweep()``, and as a subprocess on ``--device cpu``)
against the port's and the JAX package's monoliths under the parity
settings: no eval cache or bounds tier, the host-material wire, the
prefetch budget pinned to 0, fixed FENs at fixed nodes, one driver
thread. A malformed record is refused before the evaluator runs.

The AZ half: the record codecs byte for byte against the JAX package's;
the host's AZ backend (the plane's forward at the plane's bucket ladder)
against the plane's forward bit for bit and the JAX host backend within
a bf16 tolerance; MCTS trees and self-play batches over a
``RemoteAzPlane`` (the host in process, or a ``--az-seed`` subprocess)
equal to the in-process shared plane's, bit for bit.
"""

import asyncio
import contextlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fishnet_tpu.nnue.jax_eval import params_from_weights as jax_params
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.rpc import rings as jax_rings
from fishnet_tpu.rpc.host import _HostNnueBackend as JaxHostBackend
from fishnet_tpu.search.service import SearchService as JaxService
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.rpc import rings
from fishnet_tpu_torch.rpc.client import (
    EvaluatorLostError,
    EvaluatorRefusedError,
    RemoteBackend,
    _RpcClient,
)
from fishnet_tpu_torch.rpc.host import (
    EvaluatorHost,
    _HostNnueBackend,
    check_nnue_record,
)
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_port_cache():
    """The port's process-wide eval cache, reset around each test
    (tests/conftest.py resets only the JAX package's)."""
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread, as every port test holds (ROADMAP C8,
    C10)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _delta(before: dict, key: str) -> int:
    return rings.stats().get(key, 0) - before.get(key, 0)


def _nnue_arrays(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 1000, (n, 2, 32), dtype=np.uint16)
    buckets = rng.integers(0, 8, n, dtype=np.int32)
    parents = np.full(n, -1, np.int32)
    material = rng.integers(-100, 100, n, dtype=np.int32)
    return feats, buckets, parents, material


def _nnue_payload(n: int, seed: int = 0) -> bytes:
    return rings.pack_nnue_submit(*_nnue_arrays(n, seed))


# -- transport ---------------------------------------------------------------


def test_ring_wraparound_and_flow_control(tmp_path, monkeypatch):
    """Two slots a ring: records survive many laps, and a producer
    outrunning the consumer gets RingFull, never a clobbered slot."""
    monkeypatch.setenv(rings.RING_SLOTS_ENV, "2")
    front = rings.create_frontend_link(str(tmp_path), name="wrap.ring")
    host = rings.attach_host_link(front.path)
    try:
        for lap in range(7):
            payload = _nnue_payload(3, seed=lap)
            front.push(rings.KIND_NNUE_SUBMIT, lap + 1, 1, 3, payload)
            got = host.drain()
            assert len(got) == 1
            assert got[0] == (rings.KIND_NNUE_SUBMIT, lap + 1, 1, 3, payload)
        front.push(rings.KIND_NNUE_SUBMIT, 100, 1, 1, b"\0" * 8)
        front.push(rings.KIND_NNUE_SUBMIT, 101, 1, 1, b"\0" * 8)
        with pytest.raises(rings.RingFull):
            front.push(rings.KIND_NNUE_SUBMIT, 102, 1, 1, b"\0" * 8,
                       deadline_s=0.05)
        assert [t for _, t, _, _, _ in host.drain()] == [100, 101]
    finally:
        front.close()
        host.close()


def test_record_too_large_fails_loudly(tmp_path, monkeypatch):
    monkeypatch.setenv(rings.SLOT_BYTES_ENV, "256")
    front = rings.create_frontend_link(str(tmp_path), name="small.ring")
    try:
        assert front.slot_capacity == 256 - rings.REC_HEADER_BYTES
        with pytest.raises(rings.RecordTooLarge, match=rings.SLOT_BYTES_ENV):
            front.push(rings.KIND_NNUE_SUBMIT, 1, 1, 8, b"\0" * 512)
    finally:
        front.close()


def test_torn_record_reads_as_miss(tmp_path):
    """A payload clobbered after publish fails the checksum: skipped,
    counted as torn, its slot consumed so the ring never wedges."""
    front = rings.create_frontend_link(str(tmp_path), name="torn.ring")
    host = rings.attach_host_link(front.path)
    before = rings.stats()
    try:
        payload = _nnue_payload(2)
        front.push(rings.KIND_NNUE_SUBMIT, 1, 1, 2, payload)
        front._submit[rings.REC_HEADER_BYTES] ^= 0xFF
        assert host.drain() == []
        assert _delta(before, "torn") == 1
        front.push(rings.KIND_NNUE_SUBMIT, 2, 1, 2, payload)
        got = host.drain()
        assert [t for _, t, _, _, _ in got] == [2] and got[0][4] == payload
    finally:
        front.close()
        host.close()


def test_stale_epoch_refused_after_frontend_restart(tmp_path):
    first = rings.create_frontend_link(str(tmp_path), name="fe.ring")
    assert first.frontend_epoch == 1
    first.push(rings.KIND_NNUE_SUBMIT, 1, first.frontend_epoch, 2,
               _nnue_payload(2))
    first.close()  # killed: no unlink, the record stays in the ring

    reborn = rings.create_frontend_link(str(tmp_path), name="fe.ring")
    assert reborn.frontend_epoch == 2
    reborn.push(rings.KIND_NNUE_SUBMIT, 2, reborn.frontend_epoch, 2,
                _nnue_payload(2))
    before = rings.stats()
    host = EvaluatorHost(rpc_dir=str(tmp_path))  # serves nothing
    try:
        host.sweep()
        assert _delta(before, "stale_refusals") == 1
        # The fresh record got past the fence; with no NNUE backend it
        # is unserviceable, not refused.
        assert _delta(before, "unserviceable") == 1
    finally:
        host.close()
        reborn.close()


def test_evaluator_death_demand_timeout_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(rings.TIMEOUT_ENV, "1")
    client = _RpcClient(str(tmp_path))
    try:
        payload = _nnue_payload(2)
        ticket = client.submit(rings.KIND_NNUE_SUBMIT, 2, payload)
        t0 = time.monotonic()
        with pytest.raises(EvaluatorLostError, match="requeue"):
            client.wait(ticket, 2, rings.KIND_NNUE_SUBMIT, payload)
        assert time.monotonic() - t0 < 10.0
    finally:
        client.close()


def test_evaluator_restart_resubmits_inflight_ticket(tmp_path):
    """Evaluator A consumes a submit and dies unanswered; when B attaches
    (host-epoch bump) the waiting client resubmits the kept payload and
    consumes B's answer exactly once."""
    client = _RpcClient(str(tmp_path))
    before = rings.stats()
    try:
        payload = _nnue_payload(3, seed=9)
        ticket = client.submit(rings.KIND_NNUE_SUBMIT, 3, payload)
        host_a = rings.attach_host_link(client.link.path)
        rings.bump_host_epoch([host_a])
        assert len(host_a.drain()) == 1  # consumed, never answered
        host_a.close()

        got = {}

        def waiter():
            got["res"] = client.wait(ticket, 3, rings.KIND_NNUE_SUBMIT,
                                     payload)

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.05)  # the wait observes the first epoch
        host_b = rings.attach_host_link(client.link.path)
        rings.bump_host_epoch([host_b])
        values = np.array([11, -22, 33], np.int32)
        deadline = time.monotonic() + 10.0
        served = False
        while not served and time.monotonic() < deadline:
            for _kind, tkt, epoch, n, pay in host_b.drain():
                assert pay == payload  # the self-contained resubmit
                host_b.push(rings.KIND_NNUE_RESULT, tkt, epoch, n,
                            rings.pack_nnue_result(values))
                served = True
            time.sleep(0.001)
        th.join(timeout=10.0)
        assert not th.is_alive() and served
        _kind, _n, result = got["res"]
        assert (rings.unpack_nnue_result(result, 3) == values).all()
        assert _delta(before, "resubmits") >= 1
        host_b.close()
    finally:
        client.close()


def test_many_threads_share_one_link_without_losing_a_result(
        tmp_path, monkeypatch):
    """One client, more submitting threads than cores and a short switch
    interval: the client's lock keeps each ring single-writer, and every
    ticket comes back with its own values, exactly once."""
    monkeypatch.setenv(rings.TIMEOUT_ENV, "10")  # a lost record fails fast
    client = _RpcClient(str(tmp_path))
    host = rings.attach_host_link(client.link.path)
    stop = threading.Event()

    def echo():  # the host side: answer each record with its ticket
        while not stop.is_set():
            for _kind, ticket, epoch, n, _pay in host.drain():
                host.push(rings.KIND_NNUE_RESULT, ticket, epoch, n,
                          rings.pack_nnue_result(np.full(n, ticket)))
            time.sleep(0.0002)

    got, errors = [], []

    def worker(w):
        try:
            for i in range(25):
                n = 1 + (w + i) % 7
                payload = _nnue_payload(n, seed=w)
                ticket = client.submit(rings.KIND_NNUE_SUBMIT, n, payload)
                _kind, back_n, result = client.wait(
                    ticket, n, rings.KIND_NNUE_SUBMIT, payload)
                values = rings.unpack_nnue_result(result, back_n)
                got.append(ticket)
                assert back_n == n and (values == ticket).all()
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    server = threading.Thread(target=echo, daemon=True)
    server.start()
    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(2 * (os.cpu_count() or 4))]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        stop.set()
        server.join(timeout=10)
        client.close()
        host.close()
    assert not errors, errors[0]
    assert sorted(got) == list(range(1, 25 * len(threads) + 1))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("seed", [0, 1])
def test_link_file_and_submit_bytes_match_jax(tmp_path, writer, seed):
    """One link-file format for both packages: the header and record
    dtypes and constants are the JAX package's, a submit record packs to
    the same bytes from the same seeded arrays, and a link written by
    either package's frontend drains on the other's host side."""
    assert rings._HEADER_DTYPE == jax_rings._HEADER_DTYPE
    assert rings._REC_DTYPE == jax_rings._REC_DTYPE
    assert (rings._MAGIC, rings._VERSION, rings._HEADER_BYTES) == (
        jax_rings._MAGIC, jax_rings._VERSION, jax_rings._HEADER_BYTES)
    assert (rings.KIND_NNUE_SUBMIT, rings.KIND_AZ_SUBMIT,
            rings.KIND_NNUE_RESULT, rings.KIND_AZ_RESULT) == (
        jax_rings.KIND_NNUE_SUBMIT, jax_rings.KIND_AZ_SUBMIT,
        jax_rings.KIND_NNUE_RESULT, jax_rings.KIND_AZ_RESULT)
    n = 5 + 7 * seed
    arrays = _nnue_arrays(n, seed)
    payload = rings.pack_nnue_submit(*arrays)
    assert payload == jax_rings.pack_nnue_submit(*arrays)
    assert len(payload) == n * rings.NNUE_ENTRY_BYTES
    for got, want in zip(rings.unpack_nnue_submit(payload, n),
                         jax_rings.unpack_nnue_submit(payload, n)):
        assert np.array_equal(got, want)
    front_mod, host_mod = ((jax_rings, rings) if writer == "jax"
                           else (rings, jax_rings))
    front = front_mod.create_frontend_link(str(tmp_path), name="x.ring")
    host = host_mod.attach_host_link(front.path)
    try:
        front.push(front_mod.KIND_NNUE_SUBMIT, 7, 1, n, payload)
        assert host.drain() == [(rings.KIND_NNUE_SUBMIT, 7, 1, n, payload)]
        result = rings.pack_nnue_result(arrays[3])
        host.push(rings.KIND_NNUE_RESULT, 7, 1, n, result)
        assert front.drain() == [(rings.KIND_NNUE_RESULT, 7, 1, n, result)]
    finally:
        front.close()
        host.close()


# -- the host's evaluation ---------------------------------------------------


def _segment(rng, k: int):
    """One frontend record of ``k`` entries as the service's dense seam
    ships it: fulls and in-batch deltas on the most recent earlier full
    (adds, then removals, in their first 8 slots), padded like a step."""
    feats = np.full((k, 2, 32), spec.NUM_FEATURES, np.uint16)
    parents = np.full(k, -1, np.int32)
    last_full = -1
    for i in range(k):
        if last_full >= 0 and rng.random() < 0.6:
            parents[i] = (last_full << 1) | int(rng.integers(0, 2))
            feats[i, :, :4] = rng.integers(0, spec.NUM_FEATURES, (2, 4))
            feats[i, :, 4:6] = spec.DELTA_BASE + rng.integers(
                0, spec.NUM_FEATURES, (2, 2))
        else:
            live = int(rng.integers(20, 33))
            feats[i, :, :live] = rng.integers(0, spec.NUM_FEATURES,
                                              (2, live))
            last_full = i
    buckets = rng.integers(0, 8, k).astype(np.int32)
    material = rng.integers(-300, 300, k).astype(np.int32)
    return feats, buckets, parents, material


@pytest.mark.parametrize("sizes", [(40,), (17, 40), (5, 64, 23)],
                         ids=["1seg", "2segs", "3segs"])
def test_host_backend_matches_jax(sizes):
    """The port's ``_run`` over seeded segments (fused and padded to the
    bucket, parents rebased) returns the JAX host backend's int32
    values, entry for entry, padding included."""
    rng = np.random.default_rng(sum(sizes))
    segs = [_segment(rng, k) for k in sizes]
    for seg in segs:
        check_nnue_record(*seg[:3])
    port = _HostNnueBackend(
        params_from_weights(NnueWeights.random(seed=5), "cpu"),
        torch.device("cpu"))
    ref = JaxHostBackend(jax_params(JaxWeights.random(seed=5)))
    got = port._run(segs)
    want = ref._run(segs)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert len(got) == max(32, 1 << (sum(sizes) - 1).bit_length())
    assert np.array_equal(got, want)
    assert (port.dispatches, port.segments, port.rows) == (
        1, len(sizes), sum(sizes))


@pytest.mark.parametrize("fault", [
    "persistent", "later", "self", "on_delta", "bucket", "index", "length",
])
def test_malformed_record_is_refused_before_the_evaluator_runs(
        tmp_path, fault):
    """Every code must be -1 or name an earlier plain full of the same
    record; buckets and indices must be in range; the payload must hold
    n entries. A record that breaks this is answered with an empty
    result, which the frontend raises at once, and the evaluator never
    sees it."""
    rng = np.random.default_rng(3)
    feats, buckets, parents, material = _segment(rng, 12)
    parents[:] = -1
    n = 12
    if fault == "persistent":
        parents[4] = -(2 + ((3 << 2) | 2))
    elif fault == "later":
        parents[4] = 9 << 1
    elif fault == "self":
        parents[4] = 4 << 1
    elif fault == "on_delta":
        parents[4] = 2 << 1
        parents[6] = 4 << 1
    elif fault == "bucket":
        buckets[3] = 8
    elif fault == "index":
        feats[2, 1, 5] = spec.DELTA_BASE + spec.NUM_FEATURES + 1
    payload = rings.pack_nnue_submit(feats, buckets, parents, material)
    if fault == "length":
        payload = payload[:-4]
    host = EvaluatorHost(
        nnue_params=params_from_weights(NnueWeights.random(seed=5), "cpu"),
        rpc_dir=str(tmp_path), device="cpu")
    ran = []
    host._nnue._run = lambda segs: ran.append(segs)
    client = _RpcClient(str(tmp_path))
    before = rings.stats()
    try:
        ticket = client.submit(rings.KIND_NNUE_SUBMIT, n, payload)
        host.sweep()
        assert _delta(before, "refused.nnue") == 1 and not ran
        from fishnet_tpu_torch.rpc.client import _PendingEval

        t0 = time.monotonic()
        with pytest.raises(EvaluatorRefusedError, match="refused"):
            np.asarray(_PendingEval(client, ticket, n, payload))
        assert time.monotonic() - t0 < 5.0
    finally:
        client.close()
        host.close()


# -- analyses: split == monoliths --------------------------------------------

_FENS = [
    "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 2 3",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
]
_NODES = 50
_COMMON = dict(pool_slots=8, batch_capacity=64, tt_bytes=8 << 20,
               psqt_path="host-material", pipeline_depth=2,
               driver_threads=1)


def _analyses(svc, counters=None):
    """The searches' analyses; ``counters`` (a dict) receives the
    service's counters before it closes."""
    svc.set_prefetch(0, adaptive=False)

    async def go():
        out = []
        for fen in _FENS:
            r = await svc.search(fen, [], nodes=_NODES)
            out.append((r.best_move, r.depth, r.nodes, tuple(
                (l.multipv, l.depth, l.is_mate, l.value, tuple(l.pv))
                for l in r.lines)))
        return out

    try:
        out = asyncio.run(go())
        if counters is not None:
            counters.update(svc.counters())
        return out
    finally:
        svc.close()


@contextlib.contextmanager
def _swept(host: EvaluatorHost):
    """Drive ``host`` through ``sweep()`` on a thread of the test."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            if host.sweep() == 0:
                time.sleep(0.0005)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        yield host
    finally:
        stop.set()
        th.join(timeout=30)
        host.close()


@pytest.fixture
def parity_env(monkeypatch):
    """The parity settings: no eval cache, no bounds tier."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.setenv("FISHNET_NO_BOUNDS", "1")


@pytest.fixture(scope="module")
def monolith():
    """The port's monolith's analyses under the parity settings (searched
    once for the module's split tests)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FISHNET_NO_EVAL_CACHE", "1")
        mp.setenv("FISHNET_NO_BOUNDS", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return _analyses(SearchService(
                weights=NnueWeights.random(seed=7), device="cpu",
                **_COMMON))
        finally:
            torch.set_num_threads(threads)


def test_split_in_process_matches_port_and_jax_monoliths(
        tmp_path, parity_env, monolith, monkeypatch):
    """A RemoteBackend served by a port EvaluatorHost (driven through
    sweep()) searches exactly as the port's monolith and the JAX
    package's monolith on the host-material wire. The frontend holds no
    device: it never resolves one."""
    import fishnet_tpu_torch.search.service as service_mod

    weights = NnueWeights.random(seed=7)
    jax_mono = _analyses(JaxService(weights=JaxWeights.random(seed=7),
                                    backend="jax", **_COMMON))

    def no_device(device=None):
        raise AssertionError("a frontend resolved a device")

    host = EvaluatorHost(nnue_params=params_from_weights(weights, "cpu"),
                         rpc_dir=str(tmp_path), device="cpu")
    host.warmup()
    monkeypatch.setattr(service_mod, "resolve_device", no_device)
    with _swept(host):
        split = RemoteBackend(weights=weights, rpc_dir=str(tmp_path),
                              **_COMMON)
        assert split.device is None and split.psqt_path == "host-material"
        assert split._coalescer is None and split._eval_cache is None
        assert split._bounds_cache is None and not split._async_pipes
        counters = {}
        split_out = _analyses(split, counters)
    assert split_out == monolith == jax_mono
    assert sum(r[2] for r in split_out) > len(_FENS)  # they searched
    # Every step crossed the ring: dense wire, host material.
    assert counters["dispatches"] == counters["eval_steps"] > 0
    assert counters["wire_material_bytes"] == 4 * counters["bucket_slots"]
    c = host.counters()
    assert c["dispatches"] >= counters["dispatches"] and c["rows"] > 0
    assert not torch.cuda.is_initialized()


def test_split_across_two_processes_matches_the_monolith(
        tmp_path, parity_env, monolith):
    """A frontend in this process, the evaluator host a subprocess
    (``python -m fishnet_tpu_torch.rpc.host --device cpu``): the same
    analyses as the port's monolith."""
    weights = NnueWeights.random(seed=7)
    wpath = tmp_path / "w.nnue"
    weights.save(str(wpath))
    rpc_dir = tmp_path / "rpc"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    host = subprocess.Popen(
        [sys.executable, "-m", "fishnet_tpu_torch.rpc.host", "--dir",
         str(rpc_dir), "--nnue-file", str(wpath), "--device", "cpu",
         "--poll", "0.001"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        split = _analyses(RemoteBackend(weights=weights,
                                        rpc_dir=str(rpc_dir), **_COMMON))
    finally:
        host.terminate()
        try:
            _, err = host.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            host.kill()
            _, err = host.communicate(timeout=20)
    assert host.returncode == 0, err.decode()[-2000:]
    assert split == monolith


# -- the escape hatch ----------------------------------------------------------


def test_flag_off_builds_monolith_flag_on_builds_remote(monkeypatch,
                                                       tmp_path):
    """FISHNET_RPC unset or "0" builds the monolith; "1" builds a
    RemoteBackend with the CLI's microbatch, pipeline and threads, and
    resolves no device: it builds without a GPU."""
    from fishnet_tpu_torch import __main__ as cli
    from fishnet_tpu_torch.configure import Opt
    from fishnet_tpu_torch.utils.logger import Logger

    monkeypatch.delenv("FISHNET_RPC", raising=False)
    assert not rings.rpc_enabled()
    monkeypatch.setenv("FISHNET_RPC", "0")
    assert not rings.rpc_enabled()
    opt = Opt(microbatch=64, pipeline=2, search_threads=1, device="cpu")
    logger = Logger(verbose=0)
    svc = cli.build_search_service(opt, logger)
    try:
        assert type(svc) is SearchService and svc.device.type == "cpu"
    finally:
        svc.close()

    monkeypatch.setenv("FISHNET_RPC", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rings.rpc_enabled()

    class _Probe:
        def __init__(self, **kwargs):
            self.kwargs = kwargs

        def warmup(self):
            pass

    import fishnet_tpu_torch.rpc.client as client_mod

    monkeypatch.setattr(client_mod, "RemoteBackend", _Probe)
    probe = cli.build_search_service(Opt(microbatch=64, search_threads=3),
                                     logger)
    assert isinstance(probe, _Probe)
    assert probe.kwargs["pipeline_depth"] == 2
    assert probe.kwargs["driver_threads"] == 3
    assert "device" not in probe.kwargs
    factory = cli.build_engine_factory(Opt(engine="tpu-nnue"), logger)
    assert factory.supervisor.rung == "host-material"


# -- the AZ half ---------------------------------------------------------------
# The tree-side evaluator seam: a RemoteAzPlane in a pool's evaluator slot,
# served by a port EvaluatorHost with AZ params, against the pool's own
# in-process shared plane on the same params (TINY, on the CPU).

import jax.numpy as jnp  # noqa: E402

from fishnet_tpu.models.az import AzConfig as JaxAzConfig  # noqa: E402
from fishnet_tpu.rpc.host import _HostAzBackend as JaxHostAzBackend  # noqa: E402
from fishnet_tpu.search.mcts import MctsConfig as JaxMctsConfig  # noqa: E402
from fishnet_tpu_torch.models.az import (  # noqa: E402
    AzConfig,
    init_az_params,
    params_from_jax as az_params_from_jax,
    wire_forward,
)
from fishnet_tpu_torch.rpc.client import RemoteAzPlane  # noqa: E402
from fishnet_tpu_torch.rpc.host import _HostAzBackend  # noqa: E402
from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool  # noqa: E402
from fishnet_tpu_torch.train.selfplay import SelfPlayConfig, selfplay_batch  # noqa: E402

AZ_TINY = AzConfig(channels=16, blocks=2, value_hidden=16)
AZ_CFG = MctsConfig(batch_capacity=64, az=AZ_TINY)
#: The JAX forward against the port's: within 2**-5 of the largest
#: logit's magnitude (tests/test_torch_az_model.py's bound).
AZ_TOLERANCE = 2.0 ** -5
AZ_ROOTS = [[], ["e2e4"], ["d2d4", "d7d5"], ["g1f3", "g8f6", "c2c4"]]


def _az_planes(rng, n):
    x = rng.integers(0, 2, (n, 8, 8, 19)).astype(np.uint8)
    x[..., 17] = rng.integers(0, 101, (n, 1, 1))
    return x


@pytest.fixture(scope="module")
def az_params():
    """The TINY dev-mode draw with every zero leaf given small seeded
    values (live biases and value head)."""
    rng = np.random.default_rng(11)
    params = init_az_params(11, AZ_TINY)
    for k, v in params.items():
        if not v.any():
            params[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
    return params


@pytest.mark.parametrize("seed", [0, 1])
def test_az_codecs_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 3 + 5 * seed
    planes = _az_planes(rng, n)
    payload = rings.pack_az_submit(planes)
    assert payload == jax_rings.pack_az_submit(planes)
    assert rings.AZ_PLANE_SHAPE == jax_rings.AZ_PLANE_SHAPE
    assert np.array_equal(rings.unpack_az_submit(payload, n),
                          jax_rings.unpack_az_submit(payload, n))
    logits = rng.standard_normal((n, 4672)).astype(np.float16)
    values = rng.uniform(-1, 1, n).astype(np.float32)
    result = rings.pack_az_result(logits, values)
    assert result == jax_rings.pack_az_result(logits, values)
    assert len(result) == n * (4672 * 2 + 4)
    for got, want in zip(rings.unpack_az_result(result, n, 4672),
                         jax_rings.unpack_az_result(result, n, 4672)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="az submit"):
        rings.unpack_az_submit(payload[:-1], n)


@pytest.mark.parametrize("sizes", [(5,), (17, 40), (40, 50, 3)],
                         ids=["1seg", "2segs", "over-capacity"])
def test_host_az_backend_equals_the_plane_forward_and_jax(az_params, sizes):
    """The port host's fused AZ dispatch gives each row the plane's
    forward bits (a fused batch above the capacity runs as capacity-
    sized forwards of the ladder) and the JAX host backend's within
    AZ_TOLERANCE."""
    rng = np.random.default_rng(sum(sizes))
    segs = [_az_planes(rng, k) for k in sizes]
    host = _HostAzBackend(az_params, AZ_CFG, torch.device("cpu"))
    assert host.buckets == [32, 64]
    logits, values = host._run(segs)
    rows = np.concatenate(segs)
    net = az_params_from_jax(az_params)
    want_l, want_v = wire_forward(net, torch.from_numpy(rows))
    assert logits.dtype == np.float16 and values.dtype == np.float32
    assert np.array_equal(logits, want_l.numpy())
    assert np.array_equal(values, want_v.numpy())
    assert host.forwards == -(-len(rows) // 64) and host.rows == len(rows)
    ref = JaxHostAzBackend({k: jnp.asarray(v) for k, v in az_params.items()},
                           JaxMctsConfig(batch_capacity=64, az=JaxAzConfig(
                               channels=16, blocks=2, value_hidden=16)))
    ref_l, ref_v = ref._run(segs)  # padded to its own bucket
    ref_l, ref_v = ref_l[: len(rows)], ref_v[: len(rows)]
    scale = max(1.0, float(np.abs(ref_l.astype(np.float32)).max()))
    assert np.abs(logits.astype(np.float32) - ref_l.astype(np.float32)).max() \
        <= AZ_TOLERANCE * scale
    assert np.abs(values - ref_v).max() <= AZ_TOLERANCE


def _trees(pool, roots, visits=48):
    sids = [pool.submit(MATE_START, line, visits) for line in roots]
    while pool.active() > 0:
        pool.step()
    return [(r.best_move, r.visits, r.value, tuple(r.root_visits), tuple(r.pv))
            for r in map(pool.harvest, sids)]


MATE_START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"


def _in_process(params, fn):
    pool = MctsPool(params, AZ_CFG, device="cpu")
    try:
        return fn(pool)
    finally:
        pool.close()


def test_remote_az_plane_trees_equal_the_in_process_plane(tmp_path, az_params):
    """MCTS over a RemoteAzPlane (the host swept in this process) gives
    the in-process plane's trees bit for bit, cold and warm (a warm
    replay resolves rows from the salted cache before the wire), and the
    frontend holds no device."""
    want = _in_process(az_params, lambda p: _trees(p, AZ_ROOTS))
    eval_cache.reset_cache()
    host = EvaluatorHost(az_params=az_params, az_cfg=AZ_CFG,
                         rpc_dir=str(tmp_path), device="cpu")
    host.warmup()
    with _swept(host):
        plane = RemoteAzPlane(AZ_CFG, az_params, rpc_dir=str(tmp_path),
                              link_name="a.ring")
        try:
            plane.warmup()
            pool = MctsPool(az_params, AZ_CFG, evaluator=plane)
            cold = _trees(pool, AZ_ROOTS)
            c_cold = plane.counters()
            warm = _trees(MctsPool(az_params, AZ_CFG, evaluator=plane),
                          AZ_ROOTS)
            c_warm = plane.counters()
        finally:
            plane.close()
        az = host.counters()["az"]
    assert cold == want and warm == want
    assert c_cold["dispatches"] > 0 and c_cold["rows_dispatched"] > 0
    assert c_warm["prewire_hits"] > c_cold["prewire_hits"]
    assert az["dispatches"] >= c_cold["dispatches"] and az["rows"] > 0
    assert not torch.cuda.is_initialized()


def test_remote_az_plane_splits_a_record_too_large_for_a_slot(
        tmp_path, az_params, monkeypatch):
    """A microbatch whose answer outgrows one ring slot crosses as
    several records, submitted together; the rows come back in order,
    the plane's bits."""
    row = 4672 * 2 + 4
    monkeypatch.setenv(rings.SLOT_BYTES_ENV, str(rings.REC_HEADER_BYTES + 10 * row))
    host = EvaluatorHost(az_params=az_params, az_cfg=AZ_CFG,
                         rpc_dir=str(tmp_path), device="cpu")
    planes = _az_planes(np.random.default_rng(3), 25)
    with _swept(host):
        plane = RemoteAzPlane(AZ_CFG, rpc_dir=str(tmp_path), link_name="b.ring")
        try:
            logits, values = plane.evaluate(plane.register_lane(), planes, 25)
            counters = plane.counters()
        finally:
            plane.close()
    want_l, want_v = wire_forward(az_params_from_jax(az_params),
                                  torch.from_numpy(planes))
    assert counters["records"] == 3 and counters["dispatches"] == 1
    assert np.array_equal(logits, want_l.float().numpy())
    assert np.array_equal(values, want_v.numpy())


def test_two_remote_frontends_self_play_as_the_in_process_plane(tmp_path,
                                                                az_params):
    """Two frontends (each a pool over its own RemoteAzPlane, on its own
    thread) self-play through one host: each batch equals the in-process
    plane's at its seed, bit for bit."""
    cfg = SelfPlayConfig(games=2, visits=16, max_plies=8)
    want = {seed: _in_process(az_params, lambda p, s=seed: selfplay_batch(p, cfg, s))
            for seed in (0, 1)}
    eval_cache.reset_cache()
    host = EvaluatorHost(az_params=az_params, az_cfg=AZ_CFG,
                         rpc_dir=str(tmp_path), device="cpu")
    got, errors = {}, []

    def frontend(seed):
        plane = RemoteAzPlane(AZ_CFG, az_params, rpc_dir=str(tmp_path),
                              link_name=f"f{seed}.ring")
        try:
            got[seed] = selfplay_batch(MctsPool(az_params, AZ_CFG,
                                                evaluator=plane), cfg, seed)
        except BaseException as err:  # noqa: BLE001 - raised below
            errors.append(err)
        finally:
            plane.close()

    with _swept(host):
        threads = [threading.Thread(target=frontend, args=(s,)) for s in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        az = host.counters()["az"]
    assert not errors, errors
    for seed in (0, 1):
        for k in want[seed]:
            np.testing.assert_array_equal(got[seed][k], want[seed][k],
                                          err_msg=f"{seed} {k}")
    assert az["segments"] >= az["dispatches"] > 0


def test_malformed_az_record_is_refused(tmp_path, az_params):
    host = EvaluatorHost(az_params=az_params, az_cfg=AZ_CFG,
                         rpc_dir=str(tmp_path), device="cpu")
    client = _RpcClient(str(tmp_path))
    before = rings.stats()
    try:
        payload = rings.pack_az_submit(_az_planes(np.random.default_rng(0), 2))
        ticket = client.submit(rings.KIND_AZ_SUBMIT, 3, payload)
        host.sweep()
        _kind, n, result = client.wait(ticket, 3, rings.KIND_AZ_SUBMIT, payload)
        assert n == 0 and result == b""
        assert _delta(before, "refused.az") == 1
        assert host.counters()["az"]["dispatches"] == 0
    finally:
        client.close()
        host.close()


def test_host_subprocess_serves_az_seed(tmp_path):
    """``python -m fishnet_tpu_torch.rpc.host --az-seed 3 --device cpu``
    serves the default AzConfig's seeded params: self-play through it
    equals the in-process plane on ``init_az_params(3)``."""
    cfg = MctsConfig(batch_capacity=64)
    params = init_az_params(3, cfg.az)
    sp = SelfPlayConfig(games=2, visits=8, max_plies=3)
    pool = MctsPool(params, cfg, device="cpu")
    try:
        want = selfplay_batch(pool, sp, seed=4)
    finally:
        pool.close()
    eval_cache.reset_cache()
    rpc_dir = tmp_path / "rpc"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    host = subprocess.Popen(
        [sys.executable, "-m", "fishnet_tpu_torch.rpc.host", "--dir",
         str(rpc_dir), "--az-seed", "3", "--az-capacity", "64", "--device",
         "cpu", "--poll", "0.001"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        plane = RemoteAzPlane(cfg, params, rpc_dir=str(rpc_dir))
        try:
            got = selfplay_batch(MctsPool(params, cfg, evaluator=plane), sp, seed=4)
        finally:
            plane.close()
    finally:
        host.terminate()
        try:
            _, err = host.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            host.kill()
            _, err = host.communicate(timeout=20)
    assert host.returncode == 0, err.decode()[-2000:]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
