"""The port's shared AZ dispatch plane (fishnet_tpu_torch.search.az_plane)
on the CPU: the port's versions of the JAX plane tests
(``tests/test_mcts_plane.py`` and the speculation tests of
``tests/test_bounds_plane.py``), all inside the port and bit for bit.

The plane against the private evaluator of ``FISHNET_NO_SHARED_AZ_PLANE=1``
on every forced rung with the AZ cache live, a fused dispatch of two
lanes against each lane's rows alone on every rung, a warm replay
against a cold run, nets keyed apart by their fingerprints, speculative
pad rows against none, the speculation budget's pin, and the claim all
of it rests on: a row's logits and value do not depend on the forward's
batch shape (each bucket of the ladder). Then the tree semantics the
JAX plane tests pin, on a counting evaluator.

tests/conftest.py sets ``FISHNET_NO_SPECULATION=1`` (the port reads the
same hatch); the speculation tests lift it."""

import threading

import numpy as np
import pytest
import torch

from fishnet_tpu_torch.chess.board import Board
from fishnet_tpu_torch.models import az
from fishnet_tpu_torch.models.az import AzConfig, init_az_params
from fishnet_tpu_torch.models.az_encoding import POLICY_SIZE
from fishnet_tpu_torch.search import az_plane, eval_cache
from fishnet_tpu_torch.search.az_plane import AzDispatchPlane, _bucket_ladder
from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
TINY = AzConfig(channels=16, blocks=2, value_hidden=16)
OPENINGS = [[], ["e2e4"], ["d2d4"], ["g1f3"], ["e2e4", "c7c5"],
            ["e2e4", "e7e5"], ["d2d4", "d7d5"], ["d2d4", "g8f6"]]


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


@pytest.fixture(scope="module")
def params():
    return init_az_params(3, TINY)


def run_workload(pool, visits=80, trees=8):
    sids = [pool.submit(STARTPOS, list(OPENINGS[i % len(OPENINGS)]), visits)
            for i in range(trees)]
    while pool.active() > 0:
        pool.step()
    out = []
    for sid in sids:
        r = pool.harvest(sid)
        out.append((r.best_move, r.visits, r.value, tuple(r.root_visits), tuple(r.pv)))
    return out


def parity_run(params, monkeypatch, force_rung=None, hatch=False):
    eval_cache.reset_cache()
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    plane = None
    if hatch:
        monkeypatch.setenv("FISHNET_NO_SHARED_AZ_PLANE", "1")
    else:
        monkeypatch.delenv("FISHNET_NO_SHARED_AZ_PLANE", raising=False)
        if force_rung is not None:
            plane = AzDispatchPlane(params, cfg, device="cpu", force_rung=force_rung)
    pool = MctsPool(params, cfg, evaluator=plane, device="cpu")
    try:
        return run_workload(pool), pool.counters()
    finally:
        pool.close()
        if plane is not None:
            plane.close()


@pytest.fixture(scope="module")
def hatch_run(params):
    mp = pytest.MonkeyPatch()
    try:
        out, counters = parity_run(params, mp, hatch=True)
    finally:
        mp.undo()
    assert "dispatch" not in counters  # the private evaluator keeps none
    assert any(r[1] > 0 for r in out)
    return out


@pytest.mark.parametrize("rung", [None, 0, 1, 2])
def test_plane_equals_hatch_on_every_rung(params, hatch_run, rung, monkeypatch):
    """The shared plane matches the private evaluator bit for bit on the
    default ladder and each forced rung, with the AZ cache live."""
    out, counters = parity_run(params, monkeypatch, force_rung=rung)
    assert out == hatch_run
    d = counters["dispatch"]
    assert d["rung"] == az_plane.AZ_RUNGS[rung or 0]
    assert d["forwards"] >= d["dispatches"] > 0
    if rung == 2:  # minimum-bucket chunks only
        assert set(k for k, v in d["bucket_forwards"].items() if v) == {32}


def test_plane_equals_hatch_without_the_async_pipeline(params, hatch_run, monkeypatch):
    monkeypatch.setenv("FISHNET_NO_ASYNC", "1")
    out, counters = parity_run(params, monkeypatch)
    assert out == hatch_run


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_fused_lanes_equal_each_lane_alone_on_every_rung(params, rung):
    """Two lanes' microbatches in ONE fused dispatch (the coalescer's
    width pinned at 2) give each lane the rows the private evaluator
    gives it alone, on every rung."""
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    rng = np.random.default_rng(rung)
    rows = [rng.integers(0, 2, (n, 8, 8, 19)).astype(np.uint8) for n in (20, 50)]
    for r in rows:
        r[..., 17] = rng.integers(0, 101, (len(r), 1, 1))
    plane = AzDispatchPlane(params, cfg, device="cpu", coalesce_width=2,
                            force_rung=rung)
    try:
        lanes = [plane.register_lane(), plane.register_lane()]
        for lane, r in zip(lanes, rows):
            plane._staged[lane] = r
        tickets = [plane._coalescer.submit(lane, len(r), rows=len(r))
                   for lane, r in zip(lanes, rows)]
        for tk in tickets:
            plane._coalescer.demand(tk)
        got = [tk.values.materialize()[tk.start: tk.start + tk.n] for tk in tickets]
        c = plane.counters()
    finally:
        plane.close()
    assert c["dispatches"] == 1 and c["fused_dispatches"] == 1
    # 70 rows over a 64-row capacity: 64 + 6; solo 20 + 50; 32-row chunks
    assert c["forwards"] == {0: 2, 1: 2, 2: 3}[rung]
    net = az.params_from_jax(params)
    for seg, r in zip(got, rows):
        buf = np.zeros((64, 8, 8, 19), np.uint8)
        buf[:len(r)] = r
        logits, values = az.wire_forward(net, torch.from_numpy(buf))
        np.testing.assert_array_equal(seg.logits16, logits[:len(r)].numpy())
        np.testing.assert_array_equal(seg.values, values[:len(r)].numpy())


def drive_in_lockstep(pools, lines, visits):
    """Each pool on its own thread over its own roots, their evaluator
    calls met at a barrier (so both lanes' microbatches reach the plane
    together) until the first pool finishes. Returns each pool's
    results."""
    barrier = threading.Barrier(len(pools))
    for pool in pools:
        ev = pool._evaluator
        real = ev.evaluate

        def evaluate(*a, _real=real, **k):
            try:
                barrier.wait(timeout=30)
            except threading.BrokenBarrierError:
                pass
            return _real(*a, **k)

        ev.evaluate = evaluate
    out, errors = [None] * len(pools), []

    def drive(i):
        try:
            sids = [pools[i].submit(STARTPOS, list(m), visits) for m in lines[i]]
            while pools[i].active() > 0:
                pools[i].step()
            out[i] = [(r.best_move, r.visits, r.value, tuple(r.root_visits),
                       tuple(r.pv)) for r in map(pools[i].harvest, sids)]
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)
        finally:
            barrier.abort()  # the other pool steps on alone

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(len(pools))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return out


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_two_pools_on_one_plane_equal_the_hatch_on_every_rung(params, rung, monkeypatch):
    """Two pools, each on its own driver thread and lane of one plane
    (width 2, lingering for the sibling lane), fuse their microbatches
    and still give each pool the trees the private evaluator gives it,
    on every rung."""
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    halves = [OPENINGS[:4], OPENINGS[4:]]
    monkeypatch.setenv("FISHNET_NO_SHARED_AZ_PLANE", "1")
    hatch = []
    for half in halves:
        pool = MctsPool(params, cfg, device="cpu")
        hatch.append(drive_in_lockstep([pool], [half], 80)[0])
        pool.close()
    monkeypatch.delenv("FISHNET_NO_SHARED_AZ_PLANE")
    eval_cache.reset_cache()
    plane = AzDispatchPlane(params, cfg, device="cpu", coalesce_width=2,
                            force_rung=rung)
    pools = [MctsPool(params, cfg, evaluator=plane, device="cpu") for _ in halves]
    try:
        got = drive_in_lockstep(pools, halves, 80)
        c = plane.counters()
    finally:
        for pool in pools:
            pool.close()
        plane.close()
    assert got == hatch
    assert c["fused_dispatches"] > 0 and c["rung"] == az_plane.AZ_RUNGS[rung]


def _two_pool_hatch(params, cfg, halves, monkeypatch):
    monkeypatch.setenv("FISHNET_NO_SHARED_AZ_PLANE", "1")
    hatch = []
    for half in halves:
        pool = MctsPool(params, cfg, device="cpu")
        hatch.append(drive_in_lockstep([pool], [half], 80)[0])
        pool.close()
    monkeypatch.delenv("FISHNET_NO_SHARED_AZ_PLANE")
    eval_cache.reset_cache()
    return hatch


def test_two_shards_equal_the_hatch(params, monkeypatch):
    """The plane over two shards (``devices=["cpu", "cpu"]``, a replica
    each, the lanes routed round-robin): each pool's trees equal the
    private evaluator's, and both shards dispatch."""
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    halves = [OPENINGS[:4], OPENINGS[4:]]
    hatch = _two_pool_hatch(params, cfg, halves, monkeypatch)
    plane = AzDispatchPlane(params, cfg, device="cpu", devices=["cpu", "cpu"])
    pools = [MctsPool(params, cfg, evaluator=plane, device="cpu")
             for _ in halves]
    try:
        assert plane._nets[1] is not plane._nets[0]
        got = drive_in_lockstep(pools, halves, 80)
        c = plane.counters()
    finally:
        for pool in pools:
            pool.close()
        plane.close()
    assert got == hatch
    assert all(d > 0 for d in c["shard_dispatches"]), c
    assert sum(c["shard_dispatches"]) == c["dispatches"]
    assert c["shard_rungs"] == ["fused", "fused"] and c["alive"] == [0, 1]


def test_a_failing_shard_steps_down_its_ladder_then_drains(params,
                                                           monkeypatch):
    """A shard whose forwards fail walks down its own ladder (fused ->
    solo -> chunk), is then drained, and its lane's dispatches move to
    its sibling: the trees never change and the healthy shard never
    leaves its rung."""
    monkeypatch.setenv("FISHNET_SHARD_PLACEMENT", "rr")
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    halves = [OPENINGS[:4], OPENINGS[4:]]
    hatch = _two_pool_hatch(params, cfg, halves, monkeypatch)
    plane = AzDispatchPlane(params, cfg, device="cpu", devices=["cpu", "cpu"])
    real = plane._execute_rung

    def sick(shard, rung, segs):
        if shard == 1:
            raise RuntimeError("injected shard fault")
        return real(shard, rung, segs)

    plane._execute_rung = sick
    pools = [MctsPool(params, cfg, evaluator=plane, device="cpu")
             for _ in halves]
    try:
        got = drive_in_lockstep(pools, halves, 80)
        c = plane.counters()
    finally:
        for pool in pools:
            pool.close()
        plane.close()
    assert got == hatch
    assert c["alive"] == [0] and c["shard_rungs"][0] == "fused"
    assert c["degradations"] == [(1, "fused", "solo"), (1, "solo", "chunk"),
                                 (1, "chunk", "drained")]


def test_warm_replay_resolves_before_the_wire(params, monkeypatch):
    """A fresh pool (fresh memo, fresh plane) against the surviving
    process AzEvalCache resolves its leaves pre-wire and gives the cold
    run's results bit for bit."""
    monkeypatch.delenv("FISHNET_NO_SHARED_AZ_PLANE", raising=False)
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    cold_pool = MctsPool(params, cfg, device="cpu")
    cold = run_workload(cold_pool)
    cold_c = cold_pool.counters()["dispatch"]
    cold_pool.close()
    assert cold_c["rows_dispatched"] > 0 and cold_c["prewire_hits"] == 0
    warm_pool = MctsPool(params, cfg, device="cpu")
    warm = run_workload(warm_pool)
    warm_c = warm_pool.counters()["dispatch"]
    warm_pool.close()
    assert warm == cold
    assert warm_c["prewire_hits"] > 0
    assert warm_c["skipped_dispatches"] > 0
    assert warm_c["rows_dispatched"] < cold_c["rows_dispatched"]
    # The cache off: the same results, nothing reused.
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    off_pool = MctsPool(params, cfg, device="cpu")
    off = run_workload(off_pool)
    off_c = off_pool.counters()["dispatch"]
    off_pool.close()
    assert off == cold and off_c["prewire_hits"] == 0


def test_fingerprint_keys_nets_apart(params):
    other = init_az_params(9, TINY)
    fp_a = eval_cache.az_net_fingerprint(params)
    fp_b = eval_cache.az_net_fingerprint(other)
    assert fp_a != fp_b
    assert fp_a == eval_cache.az_net_fingerprint(params)
    key = eval_cache.az_position_key(0x1234ABCD, 7)
    assert (key ^ fp_a) != (key ^ fp_b)
    assert eval_cache.az_position_key(0x1234ABCD, 7) != eval_cache.az_position_key(0x1234ABCD, 8)
    # Two nets share the process cache and never serve each other.
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    pool_a = MctsPool(params, cfg, device="cpu")
    run_workload(pool_a, trees=2)
    pool_a.close()
    pool_b = MctsPool(other, cfg, device="cpu")
    run_workload(pool_b, trees=2)
    c = pool_b.counters()["dispatch"]
    pool_b.close()
    assert c["prewire_hits"] == 0


@pytest.mark.parametrize("cfg,cap", [(TINY, 256), (AzConfig(), 128)],
                         ids=["tiny", "default"])
def test_rows_do_not_depend_on_the_batch_shape(cfg, cap):
    """Each bucket of the ladder: every row of a forward at that shape
    equals the same row at the capacity's shape and the row alone."""
    net = az.params_from_jax(init_az_params(4, cfg))
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2, (cap, 8, 8, 19)).astype(np.uint8)
    x[..., 17] = rng.integers(0, 101, (cap, 1, 1))
    full_l, full_v = az.wire_forward(net, torch.from_numpy(x))
    ladder = _bucket_ladder(cap)
    assert ladder[0] == az_plane.CPU_MIN_BUCKET and ladder[-1] == cap
    for bucket in ladder:
        l, v = az.wire_forward(net, torch.from_numpy(x[:bucket].copy()))
        assert torch.equal(l, full_l[:bucket]) and torch.equal(v, full_v[:bucket])
        row = bucket - 1
        l1, v1 = az.wire_forward(net, torch.from_numpy(x[row:row + 1].copy()))
        assert torch.equal(l1[0], full_l[row]) and torch.equal(v1[0], full_v[row])


def test_bucket_ladder_and_device_floor(monkeypatch, tmp_path):
    assert _bucket_ladder(1024) == [32, 64, 128, 256, 512, 1024]
    assert _bucket_ladder(1024, az_plane.CUDA_MIN_BUCKET) == [256, 512, 1024]
    assert _bucket_ladder(64, az_plane.CUDA_MIN_BUCKET) == [64]
    assert _bucket_ladder(1000, 256) == [256, 512, 1000]
    plane = AzDispatchPlane(init_az_params(0, TINY), MctsConfig(batch_capacity=300, az=TINY),
                            device="cpu")
    try:
        assert plane.buckets == [32, 64, 128, 256, 300]
        assert plane.device == torch.device("cpu")
    finally:
        plane.close()
    # No GPU: the plane (the default device) and the hatch refuse.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for hatch in ("0", "1"):
        monkeypatch.setenv("FISHNET_NO_SHARED_AZ_PLANE", hatch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MctsPool(init_az_params(0, TINY), MctsConfig(batch_capacity=64, az=TINY))
    monkeypatch.delenv("FISHNET_NO_SHARED_AZ_PLANE")
    # FISHNET_POSITION_TIER=1 attaches the fleet tier with the eval cache
    # on (the JAX plane's condition), and not with FISHNET_NO_EVAL_CACHE=1.
    from fishnet_tpu_torch.cluster import position_tier

    monkeypatch.setenv("FISHNET_POSITION_TIER", "1")
    monkeypatch.setenv("FISHNET_POSITION_TIER_PATH", str(tmp_path / "t.seg"))
    monkeypatch.setenv("FISHNET_POSITION_TIER_CAPACITY", "64")
    monkeypatch.setenv("FISHNET_POSITION_TIER_AZ_CAPACITY", "8")
    monkeypatch.setenv("FISHNET_POSITION_TIER_BOUNDS_CAPACITY", "64")
    position_tier.reset_tier()
    try:
        for hatch, attached in (("0", True), ("1", False)):
            monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", hatch)
            plane = AzDispatchPlane(init_az_params(0, TINY),
                                    MctsConfig(batch_capacity=64, az=TINY),
                                    device="cpu")
            plane.close()
            assert (plane._postier is not None) == attached
            assert (plane._postier is position_tier.get_tier()) == attached
    finally:
        position_tier.reset_tier()
    monkeypatch.delenv("FISHNET_NO_EVAL_CACHE")
    monkeypatch.delenv("FISHNET_POSITION_TIER")
    with pytest.raises(ValueError, match="not"):
        AzDispatchPlane(init_az_params(0, TINY), MctsConfig(batch_capacity=64),
                        device="cpu")


def test_coalesce_width_from_the_environment(params, monkeypatch):
    monkeypatch.setenv("FISHNET_AZ_COALESCE_WIDTH", "4")
    plane = AzDispatchPlane(params, MctsConfig(batch_capacity=64, az=TINY), device="cpu")
    try:
        assert plane._coalescer.width == 4
    finally:
        plane.close()


# -- speculative pad rows -----------------------------------------------------


def spec_run(params, evaluator=None, trees=5, visits=48):
    cfg = MctsConfig(batch_capacity=64, az=TINY)
    pool = MctsPool(params, cfg, evaluator=evaluator, device="cpu")
    try:
        return run_workload(pool, visits=visits, trees=trees), pool.counters()
    finally:
        pool.close()


def test_speculation_fills_pads_without_changing_results(params, monkeypatch):
    hatch_out, hatch_c = spec_run(params)  # the conftest pins the hatch
    assert hatch_c["spec_offered"] == 0
    assert hatch_c["dispatch"]["spec_rows"] == 0
    monkeypatch.setenv("FISHNET_NO_SPECULATION", "0")
    eval_cache.reset_cache()
    spec_out, spec_c = spec_run(params)
    assert spec_out == hatch_out, "speculation must never perturb results"
    assert spec_c["spec_offered"] > 0
    assert spec_c["dispatch"]["spec_rows"] > 0
    assert spec_c["dispatch"]["speculation_budget"] == az_plane.DEFAULT_SPECULATION_BUDGET
    assert eval_cache.get_az_cache().stats()["insertions"] > 0


def test_speculation_budget_zero_pins_off(params, monkeypatch):
    monkeypatch.setenv("FISHNET_NO_SPECULATION", "0")
    monkeypatch.setenv("FISHNET_SPECULATION_BUDGET", "32")
    plane = AzDispatchPlane(params, MctsConfig(batch_capacity=64, az=TINY), device="cpu")
    assert plane.speculation_budget() == 32
    plane.set_speculation_budget(0)
    try:
        _, c = spec_run(params, evaluator=plane)
        assert c["spec_offered"] == 0
        assert plane.counters()["spec_rows"] == 0
    finally:
        plane.close()


# -- tree semantics, on a counting evaluator ----------------------------------


class CountingEval:
    """Instant uniform-policy evaluator: pins tree semantics apart from
    any dispatch path."""

    def __init__(self):
        self.calls = 0
        self.rows = 0

    def warmup(self, cap):
        pass

    def evaluate(self, planes_u8, n, keys=None):
        self.calls += 1
        self.rows += n
        return np.zeros((n, POLICY_SIZE), np.float32), np.zeros(n, np.float32)

    def close(self):
        pass


def test_step_reuses_the_preallocated_batch_buffer(monkeypatch):
    cfg = MctsConfig(batch_capacity=128, az=TINY)
    pool = MctsPool({}, cfg, evaluator=CountingEval())
    sids = [pool.submit(STARTPOS, [], 40) for _ in range(4)]
    full_allocs = []
    real_zeros = np.zeros

    def spy(shape, *a, **k):
        if isinstance(shape, tuple) and len(shape) == 4 and shape[0] == cfg.batch_capacity:
            full_allocs.append(shape)
        return real_zeros(shape, *a, **k)

    monkeypatch.setattr(np, "zeros", spy)
    while pool.active() > 0:
        pool.step()
    monkeypatch.setattr(np, "zeros", real_zeros)
    for sid in sids:
        assert pool.harvest(sid).visits == 40
    pool.close()
    assert full_allocs == []


def test_collision_release_under_forced_line():
    forced = "4k3/8/8/8/8/7P/2q5/K7 w - - 0 1"
    assert Board(forced).legal_moves() == ["h3h4"]
    cfg = MctsConfig(batch_capacity=32, leaves_per_step=8, adaptive_leaves=False, az=TINY)
    pool = MctsPool({}, cfg, evaluator=CountingEval())
    sid = pool.submit(forced, [], 30)
    search = pool._searches[sid]
    while pool.active() > 0:
        pool.step()
    r = pool.harvest(sid)
    pool.close()
    assert r.best_move == "h3h4"
    assert r.visits == 30
    assert search.collisions > 0
    for node in search.nodes:
        assert not node.vloss.any()


def test_terminal_leaf_backup_sign():
    fen = "6k1/8/6K1/8/8/8/8/R7 w - - 0 1"
    pool = MctsPool({}, MctsConfig(batch_capacity=32, az=TINY), evaluator=CountingEval())
    sid = pool.submit(fen, [], 200)
    search = pool._searches[sid]
    while pool.active() > 0:
        pool.step()
    r = pool.harvest(sid)
    pool.close()
    assert r.best_move == "a1a8"
    root = search.nodes[0]
    edge = root.moves.index("a1a8")
    assert root.n[edge] > 0
    assert root.w[edge] == root.n[edge]
    assert r.value == 1.0


def test_multipv_ranking_at_zero_visits():
    pool = MctsPool({}, MctsConfig(batch_capacity=32, az=TINY), evaluator=CountingEval())
    sid = pool.submit(STARTPOS, [], 500, multipv=3)
    search = pool._searches[sid]
    pool.step()  # the root's eval only; no simulation has completed
    pool.stop_search(sid)
    r = pool.harvest(sid)
    pool.close()
    root = search.nodes[0]
    assert int(root.n.sum()) == 0
    expected = [root.moves[i] for i in np.lexsort((root.priors, root.n))[::-1][:3]]
    assert [line.move for line in r.lines] == expected
