"""The port's serving mesh (fishnet_tpu_torch.parallel, the service's
shards, ``--mesh``) against the JAX package's, on the CPU, bit for bit.

The JAX side runs on the 8 host CPU devices tests/conftest.py forces;
the port's side on explicit lists of CPU shards (``["cpu", "cpu"]``:
two logical shards on one device, what a one-card host runs). Seeded
inputs go through both packages: the router's decisions on the same
call sequences, ``serving_devices`` and its escape hatch,
``factor_mesh``/``pad_to_multiple``/``make_mesh``, both sharded
evaluators, the service on two shards against the JAX service on two
devices and the port's single-device service on every port rung, the
per-shard ladder and drain (before traffic and during it, with table
blocks migrating), the eval cache on the mesh, a ``size_multiple``
evaluator's capacities and aligned emission, and the CLI's ``--mesh``.
Integer NNUE: no tolerance. Searches run at one driver thread with
their submissions gated (tests/test_torch_coalesce.py's discipline),
so results are a function of the submission sequence, never of
placement."""

import asyncio
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fishnet_tpu import __main__ as jax_main
from fishnet_tpu import configure as jax_configure
from fishnet_tpu.nnue import jax_eval
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.parallel import mesh as jax_mesh
from fishnet_tpu.search import service as jax_service
from fishnet_tpu_torch import __main__ as port_main
from fishnet_tpu_torch import configure
from fishnet_tpu_torch.nnue import spec, torch_eval
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.parallel import mesh
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.utils.logger import Logger
from test_torch_coalesce import _PLANS, _make_segment

CPU = torch.device("cpu")
TWO = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def fresh_port_cache():
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the router, the device list, the mesh shape ----------------------------


def _router_trace(router, ops, n_groups, n_shards):
    out = []
    for op in ops:
        if op[0] == "note":
            router.note_occupancy(op[1], op[2])
            out.append(None)
        else:
            try:
                out.append(sorted(router.drain(op[1]).items()))
            except RuntimeError as err:
                out.append(str(err))
        out.append(([router.shard_of(g) for g in range(n_groups)],
                    [router.groups_of(s) for s in range(n_shards)],
                    [router.group_count(s) for s in range(n_shards)],
                    router.shard_loads(), router.alive_shards()))
    return out


@pytest.mark.parametrize("placement", ["rr", "lb"])
@pytest.mark.parametrize("seed", [0, 1])
def test_router_decides_as_the_jax_router(monkeypatch, placement, seed):
    """The same call sequence (first traffic, repeated traffic, drains
    down to the last shard) gives the same placements, loads, drain
    answers and refusal under both placements."""
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", placement)
    rng = np.random.default_rng(seed)
    n_groups, n_shards = 8, 4
    ops = []
    for _ in range(40):
        ops.append(("note", int(rng.integers(0, n_groups)),
                    int(rng.integers(1, 300))))
    for shard in (2, 0, 3, 1):
        ops.append(("drain", shard))
        ops.extend(("note", int(g), int(rng.integers(1, 300)))
                   for g in rng.integers(0, n_groups, 5))
    port = _router_trace(mesh.ShardRouter(n_groups, n_shards), ops,
                         n_groups, n_shards)
    ref = _router_trace(jax_mesh.ShardRouter(n_groups, n_shards), ops,
                        n_groups, n_shards)
    assert port == ref
    assert "no alive shard" in str(port)


def test_router_drain_determinism():
    """tests/test_parallel.py's router unit, on the port."""
    r1, r2 = mesh.ShardRouter(8, 4), mesh.ShardRouter(8, 4)
    assert [r1.shard_of(g) for g in range(8)] == [g % 4 for g in range(8)]
    assert r1.groups_of(1) == [1, 5] and r1.group_count(2) == 2
    moved = r1.drain(1)
    assert moved == {1: 0, 5: 2} and r2.drain(1) == moved
    assert r1.alive_shards() == [0, 2, 3] and r1.rehomes == 2
    r1.drain(0)
    r1.drain(2)
    assert all(r1.shard_of(g) == 3 for g in range(8))
    with pytest.raises(RuntimeError, match="no alive shard"):
        r1.drain(3)


def test_router_under_concurrent_traffic_and_drains():
    """More threads than cores note traffic and read placements while
    shards drain (the interpreter switching every few microseconds):
    every group stays on exactly one alive shard, and every move is
    counted once (a lost update would break either)."""
    import sys

    router = mesh.ShardRouter(32, 4)
    moves = []
    errors = []

    def traffic(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(400):
                g = int(rng.integers(0, 32))
                router.note_occupancy(g, int(rng.integers(1, 512)))
                router.shard_of(g)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    def drains():
        for shard in (3, 1):
            moves.append(len(router.drain(shard)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=traffic, args=(i,))
                   for i in range(16)] + [threading.Thread(target=drains)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    alive = router.alive_shards()
    assert alive == [0, 2]
    assert all(router.shard_of(g) in alive for g in range(32))
    assert sum(router.group_count(s) for s in range(4)) == 32
    assert router.groups_of(1) == router.groups_of(3) == []
    first_traffic = router.rehomes - sum(moves)
    assert 0 <= first_traffic <= 32  # each group re-homes at most once


def test_serving_devices_and_the_escape_hatch(monkeypatch):
    """None/"auto"/int/sequence resolve as in the JAX package (here the
    one CPU device, or an explicit list, duplicates kept), and
    FISHNET_NO_MESH=1 clamps any request to its first device."""
    monkeypatch.delenv("FISHNET_NO_MESH", raising=False)
    cpu = [CPU]
    assert mesh.serving_devices(None, "cpu") == cpu
    assert mesh.serving_devices("auto", "cpu") == cpu
    assert mesh.serving_devices(3, "cpu") == cpu
    assert mesh.serving_devices(TWO, "cpu") == [CPU, CPU]
    devs = jax.devices()
    assert jax_mesh.serving_devices(devs[1:3]) == devs[1:3]
    monkeypatch.setenv("FISHNET_NO_MESH", "1")
    assert mesh.serving_devices(TWO, "cpu") == cpu
    assert mesh.serving_devices(4, "cpu") == cpu
    assert jax_mesh.serving_devices(4) == devs[:1]


def test_factor_pad_and_make_mesh_match_jax():
    for n in range(1, 17):
        for cap in (1, 2, 3, 4):
            assert mesh.factor_mesh(n, cap) == jax_mesh.factor_mesh(n, cap)
        for m in (1, 2, 3, 8):
            assert mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(n, m)
    devs = jax.devices()[:4]
    for data, model in ((None, None), (2, None), (None, 1), (4, 1)):
        ref = jax_mesh.make_mesh(devs, data=data, model=model)
        got = mesh.make_mesh(["cpu"] * 4, data=data, model=model)
        assert got.shape == ref.devices.shape and got.size == 4
        assert got.axis_names == ref.axis_names
    with pytest.raises(ValueError, match="mesh 3x1 != 4 devices"):
        mesh.make_mesh(["cpu"] * 4, data=3, model=1)
    with pytest.raises(ValueError, match="mesh 3x1 != 4 devices"):
        jax_mesh.make_mesh(devs, data=3, model=1)


# -- the sharded evaluators -------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    return (torch_eval.params_from_weights(NnueWeights.random(seed=11), CPU),
            jax_eval.params_from_weights(JaxWeights.random(seed=11)))


def _block_wire(rng, n_blocks, block):
    """Anchor-protocol dense batch: each block one full entry then delta
    children referencing it (tests/test_ops.py's ``_block_batch``)."""
    ds = spec.DELTA_SLOTS
    batch = n_blocks * block
    idx = np.full((batch, 2, spec.MAX_ACTIVE_FEATURES), spec.NUM_FEATURES,
                  np.int32)
    parent = np.full((batch,), -1, np.int32)
    for s in range(0, batch, block):
        idx[s, :, :29] = rng.integers(0, spec.NUM_FEATURES, (2, 29))
        for e in range(s + 1, s + block):
            parent[e] = (s << 1) | int(rng.integers(0, 2))
            for p in range(2):
                n_add, n_rem = (int(x) for x in rng.integers(0, ds + 1, 2))
                idx[e, p, :n_add] = rng.integers(0, spec.NUM_FEATURES, n_add)
                idx[e, p, ds: ds + n_rem] = spec.DELTA_BASE + rng.integers(
                    0, spec.NUM_FEATURES, n_rem)
                idx[e, p, ds + n_rem: 2 * ds] = (spec.DELTA_BASE
                                                 + spec.NUM_FEATURES)
    return idx, parent


@pytest.mark.parametrize("material", [False, True])
def test_sharded_evaluator_matches_jax(nets, material):
    """Dense calls (plain fulls, then shard-aligned delta blocks) split
    over two CPU shards equal the JAX ShardedEvaluator over the 8-device
    mesh and the single-device evaluator; a cross-shard reference raises
    in both."""
    params, jparams = nets
    port = mesh.ShardedEvaluator(params, mesh=mesh.make_mesh(TWO),
                                 batch_capacity=60)
    ref = jax_mesh.ShardedEvaluator(jparams, mesh=jax_mesh.make_mesh(),
                                    batch_capacity=60)
    assert (port.size_multiple, port.batch_capacity) == (2, 60)
    n = ref.batch_capacity  # 64: one 8-entry block per JAX shard
    rng = np.random.default_rng(3)
    idx, parent = _block_wire(rng, n // 8, 8)
    buckets = rng.integers(0, 8, n).astype(np.int32)
    mat = (rng.integers(-400, 400, n).astype(np.int32) if material
           else None)
    fulls = np.where(parent[:, None, None] < 0, idx, spec.NUM_FEATURES)
    for ind, par in ((fulls, None), (idx, parent)):
        got = port(None, ind, buckets, par, mat)
        want = np.asarray(ref(None, ind, buckets, par, mat))
        single = torch_eval.evaluate_batch(
            params, torch.from_numpy(ind), torch.from_numpy(buckets),
            None if par is None else torch.from_numpy(par),
            None if mat is None else torch.from_numpy(mat)).numpy()
        assert np.array_equal(got, want) and np.array_equal(got, single)
    bad = parent.copy()
    bad[n // 2 + 1] = 0  # a second-half child anchored in the first half
    with pytest.raises(ValueError, match="outside its mesh shard"):
        port(None, idx, buckets, bad)
    with pytest.raises(ValueError, match="outside its mesh shard"):
        ref(None, idx, buckets, bad)


def test_sharded_packed_eval_matches_jax(nets):
    """``packed_eval`` over a per-shard repacked wire (two shards, each
    its rows, its sentinel block, shard-local offsets) equals the JAX
    evaluator's on two devices and evaluate_packed of each shard."""
    params, jparams = nets
    rng = np.random.default_rng(5)
    size = 8
    plans = [[("full",), ("inbatch", 0, 1), ("inbatch", 0, 0), ("full",),
              ("inbatch", 3, 1)],
             [("full",), ("full",), ("inbatch", 1, 0)]]
    segs = [_make_segment(p, size, 2, rng) for p in plans]
    tier = 4 * size + 4
    packed = np.concatenate([s["packed"][:tier] for s in segs])
    offsets, parent = [], []
    for k, s in enumerate(segs):
        off = torch_eval.derive_offsets_np(s["parent"], s["rows"])
        offsets.append(off)
        p = s["parent"].copy()
        inb = p >= 0
        p[inb] = (((p[inb] >> 1) + k * size) << 1) | (p[inb] & 1)
        parent.append(p)
    offsets, parent = np.concatenate(offsets), np.concatenate(parent)
    buckets = np.concatenate([s["buckets"] for s in segs])
    mat = np.concatenate([s["mat"] for s in segs])
    port = mesh.ShardedEvaluator(params, mesh=mesh.make_mesh(TWO),
                                 batch_capacity=16)
    ref = jax_mesh.ShardedEvaluator(
        jparams, mesh=jax_mesh.make_mesh(jax.devices()[:2]),
        batch_capacity=16)
    got = port.packed_eval(None, packed, offsets, buckets, parent, mat)
    want = np.asarray(ref.packed_eval(None, packed, offsets, buckets,
                                      parent, mat))
    assert np.array_equal(got, want)
    for k, s in enumerate(segs):
        one = torch_eval.evaluate_packed(
            params, torch.from_numpy(s["packed"][:tier].view(np.int16)),
            torch.from_numpy(offsets[k * size:(k + 1) * size]),
            torch.from_numpy(s["buckets"]), torch.from_numpy(s["parent"]),
            torch.from_numpy(s["mat"])).numpy()
        assert np.array_equal(got[k * size:(k + 1) * size], one)


@pytest.mark.parametrize("rung", ["xla", "host-material"])
def test_sharded_segmented_evaluator_matches_jax(nets, rung):
    """Four segments over two shards: values and every group's tables
    equal the JAX ShardedSegmentedEvaluator's on two devices (and so the
    single-device segmented evaluator's); a segment count that does not
    divide over the mesh raises in both."""
    params, jparams = nets
    rng = np.random.default_rng(37)
    size, tab_rows = 6, 4
    tier = 4 * size + 4
    segs = [_make_segment(p, size, tab_rows, rng)
            for p in _PLANS + _PLANS[:1]]
    material = rung == "host-material"

    def wire(ss, lib):
        return (
            lib(np.concatenate([s["packed"][:tier] for s in ss])),
            lib(np.concatenate([s["buckets"] for s in ss])),
            lib(np.concatenate([s["parent"] for s in ss])),
            lib(np.concatenate([s["mat"] for s in ss])) if material else None,
            lib(np.stack([s["tab"] for s in ss])),
            lib(np.array([s["rows"] for s in ss], np.int32)),
            lib(np.stack([s["ptab"] for s in ss])),
        )

    def to_torch(a):
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        return torch.from_numpy(np.ascontiguousarray(a))

    ref = jax_mesh.ShardedSegmentedEvaluator(devices=jax.devices()[:2])
    want = tuple(map(np.asarray, ref(jparams, *wire(segs, jnp.asarray))))
    port = mesh.ShardedSegmentedEvaluator(devices=TWO)
    got = port(params, *wire(segs, to_torch))
    for g, w, what in zip(got, want, ("values", "anchor", "psqt")):
        assert np.array_equal(g.numpy(), w), what
    with pytest.raises(ValueError, match="does not divide"):
        port(params, *wire(segs[:3], to_torch))


# -- the service on two shards ----------------------------------------------


_FENS = [
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
    "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 2 3",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
    "rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2",
]
#: One slot per group: the four searches land in groups 0-3, so each of
#: two shards runs two groups (and may fuse them). Small nodes: the
#: CPU's plain version takes tens of ms a dispatch.
NODES = 40
GATED_KW = dict(pool_slots=4, batch_capacity=256, tt_bytes=8 << 20,
                pipeline_depth=4, driver_threads=1)


def _gated(base):
    class Gated(base):
        """Parks its driver after the warm-up until the gate opens."""

        def __init__(self, *args, **kwargs):
            self.gate = threading.Event()
            super().__init__(*args, **kwargs)

        def warmup(self):
            super().warmup()
            self.gate.wait()

    return Gated


def _run(svc, hook=None):
    """The four searches through a gated service; returns the analyses,
    the shard report and the counters, and closes the service."""
    try:
        svc.set_prefetch(0, adaptive=False)
        if hook is not None:
            hook(svc)

        async def go():
            tasks = [asyncio.ensure_future(svc.search(f, [], nodes=NODES))
                     for f in _FENS]
            await asyncio.sleep(0.3)
            svc.gate.set()
            return await asyncio.gather(*tasks)

        results = asyncio.run(go())
        report = svc.shard_report() if hasattr(svc, "shard_report") else None
        return ([(r.best_move, r.depth, r.nodes,
                  tuple((ln.multipv, ln.depth, ln.is_mate, ln.value,
                         tuple(ln.pv)) for ln in r.lines))
                 for r in results], report, svc.counters())
    finally:
        svc.gate.set()
        svc.close()


def _port(mesh_devices=None, psqt_path=None, hook=None, fresh=True):
    if fresh:
        eval_cache.reset_cache()
    return _run(_gated(SearchService)(
        weights=NnueWeights.random(seed=7), device="cpu",
        psqt_path=psqt_path, mesh_devices=mesh_devices, **GATED_KW), hook)


@pytest.fixture(scope="module")
def single():
    """The single-device port service's analyses, eval cache off."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FISHNET_NO_EVAL_CACHE", "1")
    try:
        return _port()[0]
    finally:
        mp.undo()


@pytest.mark.parametrize("rung", ["xla", "host-material"])
def test_two_shards_match_one_device_and_the_jax_mesh(monkeypatch, single,
                                                      rung):
    """Two logical shards on one device serve the analyses of the
    single-device service and of the JAX service on two devices, on
    every port rung, with both shards dispatching."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    one = single
    if rung != "xla":  # the fixture's is the default rung's
        one, rep1, _ = _port(psqt_path=rung)
        assert rep1["n_shards"] == 1 and rep1["rungs"] == [rung]
    two, rep2, c2 = _port(TWO, psqt_path=rung)
    assert rep2["n_shards"] == 2 and rep2["rungs"] == [rung, rung]
    assert all(d > 0 for d in rep2["dispatches"]), rep2
    assert sum(rep2["dispatches"]) == c2["dispatches"]
    assert c2["shard0_dispatches"] + c2["shard1_dispatches"] \
        == c2["dispatches"]
    ref, jrep, _ = _run(_gated(jax_service.SearchService)(
        weights=JaxWeights.random(seed=7), backend="jax", mesh_devices=2,
        psqt_path=rung, **GATED_KW))
    assert jrep["n_shards"] == 2 and all(d > 0 for d in jrep["dispatches"])
    assert one == two == ref == single


def test_load_balanced_placement_and_the_escape_hatch(monkeypatch, single):
    """Under the default ``lb`` placement the analyses do not change;
    FISHNET_NO_MESH=1 and a mesh request on a host with one device build
    the single-device service."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.delenv("FISHNET_SHARD_PLACEMENT", raising=False)
    two, rep, _ = _port(TWO)
    assert two == single and rep["n_shards"] == 2
    monkeypatch.setenv("FISHNET_NO_MESH", "1")
    for req in (TWO, "auto"):
        svc = SearchService(weights=NnueWeights.random(seed=7), device="cpu",
                            mesh_devices=req, **GATED_KW)
        try:
            assert svc._router is None and svc.shard_report()["n_shards"] == 1
            assert svc._material_buf is None and len(svc._async_pipes) == 1
        finally:
            svc.close()


def test_drain_before_traffic_reroutes_groups(monkeypatch, single):
    """A shard walked past its last rung before any traffic is drained:
    its groups re-home on its sibling, it serves nothing, and the
    analyses do not change."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    err = RuntimeError("injected shard fault")

    def hook(svc):
        g = svc._router.groups_of(1)[0]
        for _ in range(2):
            svc._degrade_shard_for(g, err)

    gone, rep, _ = _port(TWO, hook=hook)
    assert gone == single
    assert rep["rungs"] == ["xla", "drained"] and rep["alive"] == [True, False]
    assert rep["groups"] == [[0, 1, 2, 3], []]
    assert rep["dispatches"][1] == 0


def test_drain_during_traffic_migrates_table_blocks(monkeypatch, single):
    """Shard 1 steps down to host-material while its groups hold live
    anchors — its sibling keeps its rung, every shard stays alive — and
    is later drained: each drained group's table block follows it to
    shard 0 at its next dispatch, the host-material rung keeps the PSQT
    tables exact, and the analyses never change."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    err = RuntimeError("injected shard fault")

    def hook(svc):
        solo, fused = svc._dispatch_eval, svc._dispatch_segmented
        seen = [0]

        def count(group):
            if svc._router.shard_of(group) == 1:
                seen[0] += 1
                if seen[0] in (4, 8):  # mid-search: the anchors are warm
                    svc._degrade_shard_for(group, err)
                    mid.append(svc.shard_report())

        def on_solo(group, n, rows):
            count(group)
            return solo(group, n, rows)

        def on_fused(tickets):
            count(tickets[0].group)
            return fused(tickets)

        svc._dispatch_eval, svc._dispatch_segmented = on_solo, on_fused

    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "2")
    mid = []
    got, rep, c = _port(TWO, hook=hook)
    assert got == single
    assert mid[0]["rungs"] == ["xla", "host-material"]
    assert all(mid[0]["alive"]) and mid[0]["migrations"] == 0
    assert rep["rungs"] == ["xla", "drained"]
    assert rep["degradations"] == [(1, "xla", "host-material"),
                                   (1, "host-material", "drained")]
    assert rep["migrations"] == 2 and rep["dispatches"][1] >= 8
    assert c["fused_dispatches"] > 0


def test_eval_cache_off_cold_warm_on_the_mesh(monkeypatch, single):
    """tests/test_eval_cache.py's mesh check on the port: cache off
    (the single-device run, which two shards equal) == cold == warm on
    two shards, the warm run answering before the wire."""
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    monkeypatch.delenv("FISHNET_NO_EVAL_CACHE", raising=False)
    off = single
    cold, _, _ = _port(TWO)
    warm, _, cw = _port(TWO, fresh=False)
    assert cold == off and warm == off
    assert cw["cache_prewire_hits"] > 0


def test_size_multiple_rounds_capacities_as_jax(nets):
    """A sharded evaluator's size_multiple rounds the capacities and the
    buckets, and aligns the pool's emission to its shard size, as in the
    JAX service."""
    params, jparams = nets
    port_ev = mesh.ShardedEvaluator(params, mesh=mesh.make_mesh(["cpu"] * 8),
                                    batch_capacity=64)
    ref_ev = jax_mesh.ShardedEvaluator(jparams, mesh=jax_mesh.make_mesh(),
                                       batch_capacity=64)
    kw = dict(pool_slots=16, batch_capacity=100, tt_bytes=4 << 20)
    port = SearchService(weights=NnueWeights.random(seed=5),
                         evaluator=port_ev, **kw)
    ref = jax_service.SearchService(weights=JaxWeights.random(seed=5),
                                    evaluator=ref_ev, **kw)
    try:
        for svc in (port, ref):
            assert svc.batch_capacity % 8 == 0
            assert svc._group_capacity % 8 == 0
        assert (port.batch_capacity, port._group_capacity, port._eval_sizes,
                port._shard_align, port._sharded_packed) == (
            ref.batch_capacity, ref._group_capacity, ref._eval_sizes,
            ref._shard_align, ref._sharded_packed)
    finally:
        port.close()
        ref.close()


async def _sequential(svc, fens, nodes):
    """One search at a time (the TT evolves as a function of the
    sequence), prefetch pinned."""
    svc.set_prefetch(4, adaptive=False)
    try:
        out = []
        for fen in fens:
            r = await svc.search(fen, [], nodes=nodes)
            line = [ln for ln in r.lines if ln.multipv == 1][-1]
            out.append((line.value, line.is_mate, r.best_move))
        return out
    finally:
        svc.close()


def test_sharded_packed_search_parity(nets):
    """tests/test_parallel.py's packed-wire parity on the port: the
    service over a two-shard ShardedEvaluator (aligned emission, the
    per-shard repack, ``packed_eval``) scores and moves as the
    single-device service and the JAX service over two devices."""
    params, jparams = nets
    fens = _FENS[1:]
    kw = dict(pool_slots=16, batch_capacity=64, tt_bytes=16 << 20)
    svc = SearchService(weights=NnueWeights.random(seed=11),
                        evaluator=mesh.ShardedEvaluator(
                            params, mesh=mesh.make_mesh(TWO),
                            batch_capacity=64), **kw)
    assert svc._sharded_packed
    assert svc._shard_align == svc._group_capacity // 2 == 40
    sharded = asyncio.run(_sequential(svc, fens, NODES))
    one = asyncio.run(_sequential(SearchService(
        weights=NnueWeights.random(seed=11), device="cpu", **kw), fens,
        NODES))
    ref = asyncio.run(_sequential(jax_service.SearchService(
        weights=JaxWeights.random(seed=11),
        evaluator=jax_mesh.ShardedEvaluator(
            jparams, mesh=jax_mesh.make_mesh(jax.devices()[:2]),
            batch_capacity=64), **kw), fens, NODES))
    assert sharded == one == ref


# -- the CLI ----------------------------------------------------------------


@pytest.mark.parametrize("spec_", ["auto", "off", "AUTO", " 4x2 ", "1x1",
                                   "8x1", "0x2", "2x", "x", "cpu", ""])
def test_mesh_flag_parses_as_in_the_jax_package(spec_):
    try:
        want = jax_configure.parse_mesh(spec_)
    except jax_configure.ConfigError as err:
        with pytest.raises(configure.ConfigError) as got:
            configure.parse_mesh(spec_)
        assert str(got.value) == str(err)
    else:
        assert configure.parse_mesh(spec_) == want
        argv = ["run", "--no-conf", "--mesh", spec_]
        assert configure.parse_and_configure(argv).resolved_mesh() \
            == jax_configure.parse_and_configure(
                argv, write=False).resolved_mesh() == want
    assert configure.parse_and_configure(
        ["run", "--no-conf"]).resolved_mesh() == "auto"


@pytest.mark.parametrize("spec_", ["auto", "off", "4x2", "8x1", "9x1",
                                   "3x3", "1x1"])
def test_validate_and_resolve_mesh_as_in_the_jax_package(monkeypatch, spec_):
    """With as many visible devices as the JAX side's eight, the port's
    ``validate_mesh`` refuses the same meshes with the same message, and
    ``resolve_mesh_devices`` and ``build_sharded_evaluator`` make the
    same choices."""
    monkeypatch.setattr(port_main, "_visible_devices",
                        lambda opt: len(jax.devices()))
    argv = ["run", "--no-conf", "--mesh", spec_]
    port_opt = configure.parse_and_configure(argv)
    ref_opt = jax_configure.parse_and_configure(argv, write=False)
    try:
        jax_main.validate_mesh(ref_opt)
    except jax_configure.ConfigError as err:
        with pytest.raises(configure.ConfigError) as got:
            port_main.validate_mesh(port_opt)
        assert str(got.value) == str(err)
        return
    port_main.validate_mesh(port_opt)
    log = Logger()
    assert port_main.resolve_mesh_devices(port_opt, None, log) \
        == jax_main.resolve_mesh_devices(ref_opt, None, log)
    assert port_main.resolve_mesh_devices(port_opt, object(), log) is None
    data_model = spec_.split("x")
    legacy = len(data_model) == 2 and int(data_model[1]) > 1
    if not legacy:
        assert port_main.build_sharded_evaluator(port_opt, None, log) is None


def test_mesh_on_one_device_fails_fast(capsys):
    """``--mesh 2x1`` where one device is visible fails before any
    service exists, with the JAX package's message; ``--mesh auto`` and
    ``off`` leave the single-device service."""
    for cmd in (["run", "--engine", "tpu-nnue"], ["uci"]):
        assert port_main.main(cmd + [
            "--no-conf", "--no-stats-file", "--device", "cpu", "--mesh",
            "2x1", "--endpoint", "http://127.0.0.1:9/fishnet"]) == 2
        assert "--mesh 2x1 needs 2 devices, found 1" in capsys.readouterr().err
    log = Logger()
    for spec_ in ("auto", "off", "1x1"):
        opt = configure.parse_and_configure(
            ["run", "--no-conf", "--device", "cpu", "--mesh", spec_])
        assert port_main.resolve_mesh_devices(opt, None, log) is None
