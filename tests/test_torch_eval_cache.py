"""The port's position-keyed eval reuse plane (fishnet_tpu_torch.search.
eval_cache and its wiring in the service, the coalescer, the kernel's
copy-source fan-in, the queue and the CLI) against the JAX package's, on
the CPU, bit for bit.

Seeded inputs go through both packages: the cache primitives (the same
operations on the port's and the JAX package's EvalCache, BoundsCache and
MissHistory), the net fingerprint, snapshots written by one package and
read by the other, and the copy-source fan-in of a position-keyed fused
dispatch (values and every group's anchor and PSQT tables, persistent
drops included). Then the service: cache off, cold and warm give the same
analyses as each other and as the JAX service, with the same pre-wire
counts; cross-group position dedup; the bounds tier's harvest then seed;
a snapshot warm restart; the queue's generation tick; and the condition
on which the fleet position tier attaches. The NNUE is integer arithmetic: no tolerance.

tests/conftest.py resets only the JAX package's cache, so every test here
resets the port's before and after (the process-wide cache would
otherwise survive from one test to the next on a worker)."""

import asyncio
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import VALID_KEY, FakeServer
from fishnet_tpu.nnue import jax_eval
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.search import eval_cache as jax_cache
from fishnet_tpu.search import service as jax_service
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.engine.mock import MockEngineFactory
from fishnet_tpu_torch.nnue import spec, torch_eval
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.ops import ft_gather
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search import service as port_service
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.utils.logger import Logger
from test_torch_coalesce import GATED_KW, _SMOKE_FENS, _gated, _make_segment

CPU = torch.device("cpu")
STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
PACKAGES = {"port": eval_cache, "jax": jax_cache}


@pytest.fixture(autouse=True)
def fresh_port_cache():
    """The port's process-wide caches, reset around each test."""
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small gathers: torch's intra-op threads cost more than they give
    beside other test processes (ROADMAP C8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the cache primitives, the same operations on both packages -------------


def _both(fn):
    """``fn(module)`` on the port's and the JAX package's eval_cache."""
    return {name: fn(mod) for name, mod in PACKAGES.items()}


def _entries(cache):
    h, v, g = cache.dump_entries()
    order = np.argsort(h)
    return h[order].tolist(), v[order].tolist(), g[order].tolist()


def test_probe_insert_roundtrip_matches_jax():
    def run(mod):
        c = mod.EvalCache(capacity=1024, stripes=8)
        out = [c.probe(0xDEAD)]
        c.insert(0xDEAD, -77)
        out += [c.probe(0xDEAD), len(c), c.probe(0xBEEF), c.stats()]
        c.clear()
        out += [len(c), c.probe(0xDEAD), c.stats()]
        return out

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1] == -77


def test_block_ops_and_mask_match_jax():
    rng = np.random.default_rng(1)
    hashes = rng.integers(0, 1 << 63, 64, dtype=np.uint64)
    values = rng.integers(-3000, 3000, 40).astype(np.int32)
    probe = np.concatenate([hashes[::3], rng.integers(0, 1 << 63, 8,
                                                      dtype=np.uint64)])

    def run(mod):
        c = mod.EvalCache(capacity=4096, stripes=8)
        c.insert_block(hashes[:40], values)
        out = np.full(len(probe), -1, np.int32)
        vals, mask = c.probe_block(probe, out=out)
        assert vals is out  # written in place (the service's scratch)
        return vals.tolist(), mask.tolist(), c.stats(), _entries(c)

    got = _both(run)
    assert got["port"] == got["jax"]
    assert any(got["port"][1]) and not all(got["port"][1])


def test_generation_eviction_under_tiny_capacity_matches_jax():
    rng = np.random.default_rng(2)
    ops = [(int(k), int(h)) for k, h in zip(rng.integers(0, 4, 300),
                                            rng.integers(0, 40, 300))]

    def run(mod):
        c = mod.EvalCache(capacity=8, stripes=2)
        seen = []
        for op, h in ops:
            if op == 0:
                c.advance_generation()
            elif op == 1:
                seen.append(c.probe(h))
            else:
                c.insert(h, h * 3)
        return seen, c.stats(), _entries(c)

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1]["evictions"] > 0 and len(got["port"][2][0]) <= 8


def test_touched_entry_outlives_its_stale_peers():
    c = eval_cache.EvalCache(capacity=8, stripes=1)
    for h in range(6):
        c.insert(h, h)
    c.advance_generation()
    assert c.probe(3) == 3
    for h in range(100, 104):
        c.insert(h, h)
    assert c.stats()["evictions"] > 0 and len(c) <= 8
    assert c.probe(3) == 3, "touched entry evicted before stale peers"


def test_thread_smoke():
    c = eval_cache.EvalCache(capacity=4096, stripes=4)
    errs = []

    def writer(base):
        try:
            for i in range(500):
                c.insert(base + i, i)
                c.probe(base + (i * 7) % 500)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(b * 10_000,))
               for b in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(c) <= 4096
    assert c.stats()["insertions"] == 2000


@pytest.mark.parametrize("seed", range(4))
def test_mixed_operations_match_jax(seed):
    """Random runs of every operation on a small striped cache — block
    inserts that fill a stripe halfway through (eviction inside a
    block), keys repeated within a block, block and single probes,
    snapshot-style loads with their own generations, generation ticks —
    leave the port's native table and the JAX package's dict table with
    the same answers, counters and entries."""
    rng = np.random.default_rng(100 + seed)
    cap, stripes = int(rng.integers(4, 64)), int(rng.integers(1, 9))
    keyspace = cap * int(rng.integers(2, 6))  # more keys than room
    ops = []
    for _ in range(150):
        n = int(rng.integers(1, 40))
        ops.append((int(rng.integers(0, 6)),
                    rng.integers(0, keyspace, n).astype(np.uint64)
                    * np.uint64(0x9E3779B97F4A7C15),
                    rng.integers(-900, 900, n).astype(np.int32),
                    rng.integers(0, 6, n)))

    def run(mod):
        c = mod.EvalCache(capacity=cap, stripes=stripes)
        seen = []
        for op, h, v, g in ops:
            if op == 0:
                seen.append(c.advance_generation())
            elif op == 1:
                c.insert_block(h, v)
            elif op == 2:
                vals, mask = c.probe_block(h)
                seen.append((vals[mask].tolist(), mask.tolist()))
            elif op == 3:
                c.insert(int(h[0]), int(v[0]))
            elif op == 4:
                seen.append(c.probe(int(h[-1])))
            else:
                c.load_entries(h, v, g)
        return seen, c.stats(), _entries(c)

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1]["evictions"] > 0


@pytest.mark.parametrize("seed", range(2))
def test_bound_records_match_jax_one_by_one_and_in_blocks(seed):
    """Deeper-entry-wins inserts, single probes and block probes on a
    small bounds cache: the port's ``insert_bounds_block`` (the
    harvest's one call) equals the JAX package's per-record
    ``insert_bound`` loop, and so does its own single insert."""
    rng = np.random.default_rng(200 + seed)
    cap, stripes = int(rng.integers(4, 40)), int(rng.integers(1, 5))
    ucis = [None, "e2e4", "a7a8q", "e1g1"]
    steps = []
    for _ in range(120):
        n = int(rng.integers(1, 12))
        keys = (rng.integers(0, 50, n).astype(np.uint64)
                * np.uint64(0x9E3779B97F4A7C15))
        cols = [rng.integers(-200, 200, n), rng.integers(-200, 200, n),
                rng.integers(0, 6, n), rng.integers(0, 5, n),
                rng.integers(0, 1 << 21, n)]
        steps.append((int(rng.integers(0, 4)), keys, cols,
                      [ucis[int(i)] for i in rng.integers(0, 4, n)]))

    def run(mod, block):
        c = mod.BoundsCache(capacity=cap, stripes=stripes)
        seen = []
        for op, keys, cols, us in steps:
            if op == 0:
                seen.append(c.advance_generation())
            elif op == 1 and block:
                c.insert_bounds_block(keys, *cols, us)
            elif op == 1:
                for i in range(len(keys)):
                    c.insert_bound(int(keys[i]), *(int(col[i])
                                                   for col in cols),
                                   uci=us[i])
            elif op == 2:
                seen.append([a.tolist() for a in c.probe_bounds_block(keys)])
            else:
                seen.append(c.probe_bound(int(keys[0])))
        return seen, c.stats()

    ref = run(jax_cache, False)
    assert run(eval_cache, False) == ref
    assert run(eval_cache, True) == ref
    assert ref[1]["evictions"] > 0
    with pytest.raises(ValueError):
        eval_cache.BoundsCache(capacity=8).insert_bound(
            1, 0, 0, 1, eval_cache.BOUND_EXACT, 0, uci="not-a-move")


def test_miss_history_matches_jax():
    rng = np.random.default_rng(3)
    records = [(int(g), int(h), int(p)) for g, h, p in zip(
        rng.integers(0, 3, 60), rng.integers(0, 40, 60),
        rng.integers(40, 80, 60))]

    def run(mod):
        mh = mod.MissHistory(window=128)
        rates = []
        for g, h, p in records:
            mh.record(g, hits=min(h, p), probes=p)
            rates.append([mh.hit_rate(x) for x in range(4)])
        return rates

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0][3] is None  # below the minimum sample


def test_bounds_cache_deeper_entry_wins_and_block_layout_match_jax():
    def run(mod):
        c = mod.BoundsCache(capacity=64)
        out = [
            c.insert_bound(5, 100, 90, 6, mod.BOUND_EXACT, 123, uci="e2e4"),
            c.insert_bound(5, -4, 0, 3, mod.BOUND_LOWER, 7),
            c.probe_bound(5),
            c.insert_bound(5, 1, 1, 6, mod.BOUND_UPPER, 9),
            c.insert_bound(5, 7, 8, 9, mod.BOUND_LOWER, 11, uci="d2d4"),
            c.probe_bound(5),
            c.insert_bound(6, 1, 1, 1, mod.BOUND_NONE, 0),
            c.insert_bound(6, 1, 1, 1, 4, 0),
            c.probe_bound(6),
        ]
        c.insert_bound(10, -50, -40, 4, mod.BOUND_UPPER, 0x155)
        c.insert_bound(30, 900, 800, 7, mod.BOUND_LOWER, 0x2AA)
        block = c.probe_bounds_block(np.array([10, 20, 30], np.uint64))
        out.append([(a.dtype.str, a.tolist()) for a in block])
        out.append(c.stats())
        return out

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][5] == (7, 8, 9, eval_cache.BOUND_LOWER, 11, "d2d4")
    assert got["port"][9][4][1][1] == eval_cache.MOVE_NONE_BITS


def test_hatches_and_capacity_env(monkeypatch):
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    assert eval_cache.get_cache() is None
    assert eval_cache.get_bounds_cache() is None
    assert eval_cache.bounds_disabled()
    monkeypatch.delenv("FISHNET_NO_EVAL_CACHE")
    monkeypatch.setenv("FISHNET_NO_BOUNDS", "1")
    assert eval_cache.get_bounds_cache() is None
    monkeypatch.setenv("FISHNET_NO_BOUNDS", "0")
    monkeypatch.setenv("FISHNET_EVAL_CACHE_CAPACITY", "256")
    eval_cache.reset_cache()
    c = eval_cache.get_cache()
    assert c is not None and c is eval_cache.get_cache()
    assert c._stripe_cap * c._n_stripes >= 256
    assert eval_cache.get_bounds_cache() is not None


def test_net_fingerprint_matches_jax(tmp_path):
    w = NnueWeights.random(seed=5)
    p = tmp_path / "net.nnue"
    w.save(p)
    assert eval_cache.net_fingerprint(str(p)) == \
        jax_cache.net_fingerprint(str(p)) == w.fingerprint()
    assert NnueWeights.random(seed=6).fingerprint() != w.fingerprint()


# -- snapshots across packages ----------------------------------------------


def _fill(mod, n=40):
    c = mod.get_cache()
    for h in range(1, n):
        c.insert(h * 0x9E3779B9, h)
    c.advance_generation()
    c.insert(0xFEED, 123)
    return c.stats()["generation"]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_snapshot_reads_across_packages(tmp_path, monkeypatch, writer,
                                        reader):
    """A snapshot written by either package restores in the other:
    entries and the generation clock. A JAX snapshot's AZ section is
    skipped by the port, which keeps the file and its NNUE entries."""
    snap = tmp_path / "cache.npz"
    w, r = PACKAGES[writer], PACKAGES[reader]
    monkeypatch.setenv(w.SNAPSHOT_ENV, str(snap))
    w.reset_cache()
    gen = _fill(w)
    if writer == "jax":
        az = jax_cache.get_az_cache()
        az.insert(0xA2, (np.ones(16, np.float16), np.float32(0.5)))
        assert w.save_snapshot(fingerprint=42, az_fingerprint=7) == str(snap)
        with np.load(snap) as data:
            assert "az_hashes" in data.files
    else:
        assert w.save_snapshot(fingerprint=42) == str(snap)
    w.reset_cache()
    r.reset_cache()
    assert r.load_snapshot(fingerprint=42) is True
    assert snap.exists()
    c = r.get_cache()
    assert c.probe(0xFEED) == 123 and c.probe(7 * 0x9E3779B9) == 7
    assert len(c) == 40 and c.stats()["generation"] >= gen
    r.reset_cache()


def test_snapshot_fingerprint_mismatch_and_corrupt_file_discard(
        tmp_path, monkeypatch):
    snap = tmp_path / "cache.npz"
    monkeypatch.setenv(eval_cache.SNAPSHOT_ENV, str(snap))
    eval_cache.get_cache().insert(0xBEEF, 9)
    assert eval_cache.save_snapshot(fingerprint=1) == str(snap)
    eval_cache.reset_cache()
    assert eval_cache.load_snapshot(fingerprint=2) is False
    assert not snap.exists(), "mismatched snapshot must be deleted"
    assert eval_cache.get_cache().probe(0xBEEF) is None

    snap.write_bytes(b"not a zip archive at all")
    eval_cache.reset_cache()
    assert eval_cache.load_snapshot(fingerprint=0) is False
    assert not snap.exists(), "corrupt snapshot must be deleted"


def test_snapshot_disabled_without_env(monkeypatch):
    monkeypatch.delenv(eval_cache.SNAPSHOT_ENV, raising=False)
    assert eval_cache.snapshot_path() is None
    eval_cache.get_cache().insert(1, 1)
    assert eval_cache.save_snapshot(fingerprint=0) is None
    assert eval_cache.load_snapshot(fingerprint=0) is False


# -- the copy-source fan-in of a position-keyed fused dispatch ---------------


def _random_plan(rng, n, tab_rows):
    """A group's entries: anchors (plain fulls, full seeds, persistent
    deltas, each table row stored once) with in-batch deltas after them."""
    rows = list(rng.permutation(tab_rows))
    plan, anchor = [], None
    while len(plan) < n:
        kind = int(rng.integers(0, 4))
        if kind == 3 and anchor is not None:
            plan.append(("inbatch", anchor, int(rng.integers(0, 2))))
            continue
        if kind == 0 or not rows:
            plan.append(("full",))
        elif kind == 1:
            plan.append(("store", int(rows.pop())))
        else:
            plan.append(("pers", int(rows.pop()), int(rng.integers(0, 2))))
        anchor = len(plan) - 1
    return plan


def _compact(seg, drops, refs, tier):
    """The service's rewrite of a segment whose ``drops`` left the wire:
    kept entries keep their rows, each dropped one becomes one sentinel
    row and takes its planner code."""
    n, parent = seg["n"], seg["parent"]
    code = parent[:n].astype(np.int64)
    delta = (code >= 0) | ((code <= -2) & ((((-code - 2) >> 1) & 1) != 0))
    old = np.where(delta, 1, 4)
    off_old = np.cumsum(old) - old
    lens = old.copy()
    lens[drops] = 1
    starts = np.cumsum(lens) - lens
    new_rows = int(starts[-1] + lens[-1])
    within = np.arange(new_rows) - np.repeat(starts, lens)
    stream = np.full((tier, 2, 8), spec.NUM_FEATURES, np.uint16)
    stream[:new_rows] = seg["packed"][np.repeat(off_old, lens) + within]
    stream[starts[drops], :, 4:] = spec.DELTA_BASE + spec.NUM_FEATURES
    stream[starts[drops], :, :4] = spec.NUM_FEATURES
    new_parent = parent.copy()
    new_parent[drops] = refs
    return stream, new_parent, new_rows


@pytest.fixture(scope="module")
def nets():
    return (torch_eval.params_from_weights(NnueWeights.random(seed=5), CPU),
            jax_eval.params_from_weights(JaxWeights.random(seed=5)))


@pytest.mark.parametrize("k_segs", [2, 4])
@pytest.mark.parametrize("rung", ["xla", "host-material"])
def test_copy_source_fan_in_matches_jax(nets, rung, k_segs):
    """K groups' streams, their positions drawn from a small pool so they
    repeat across segments, some known to the cache; the position-keyed
    planner drops duplicates (persistent ones included) and cache hits,
    the stream is rewritten as the service rewrites it, and the fan-in
    from the planner's pairs runs in the plain version: the values and
    every group's anchor and PSQT tables equal the JAX package's
    evaluate_packed_anchored_segmented(copy_src=...)."""
    params, jparams = nets
    rng = np.random.default_rng(40 + k_segs)
    size, tab_rows = 12, 10
    tier = 4 * size + 4
    segs, hashes, hits = [], [], []
    for _ in range(k_segs):
        seg = _make_segment(_random_plan(rng, 10, tab_rows), size, tab_rows,
                            rng)
        segs.append(seg)
        # Half the positions from a pool of 6 (they repeat), half unique.
        hashes.append(np.where(rng.random(size) < 0.5,
                               rng.integers(1, 7, size),
                               rng.integers(100, 1 << 40, size)
                               ).astype(np.uint64))
        mask = rng.random(size) < 0.3
        hits.append((mask, rng.integers(-900, 900, size).astype(np.int32)))
    lens = [np.where(ft_gather.is_delta(torch.from_numpy(s["parent"])).numpy(),
                     1, 4) for s in segs]
    offsets = [np.cumsum(n) - n for n in lens]
    drops, refs, pairs, fills = ft_gather.plan_segment_dedup(
        [s["parent"] for s in segs], [s["buckets"] for s in segs], offsets,
        [s["n"] for s in segs], [s["packed"] for s in segs], None,
        hashes=hashes, cache_hits=hits)
    pers_drops = sum(int((segs[k]["parent"][drops[k]] <= -2).sum())
                     for k in range(k_segs))
    assert pairs and fills and pers_drops > 0, "the case lacks a drop kind"
    streams, parents, seg_rows = [], [], []
    for k, seg in enumerate(segs):
        stream, parent, rows = _compact(seg, np.asarray(drops[k], np.int64),
                                        np.asarray(refs[k], np.int32), tier)
        streams.append(stream)
        parents.append(parent)
        seg_rows.append(rows)
    copy_src = np.arange(k_segs * size, dtype=np.int32)
    for dk, di, sk, si in pairs:
        copy_src[dk * size + di] = sk * size + si
    packed = np.concatenate(streams)
    parent = np.concatenate(parents)
    buckets = np.concatenate([s["buckets"] for s in segs])
    mat = np.concatenate([s["mat"] for s in segs])
    seg_rows = np.array(seg_rows, np.int32)
    material = rung == "host-material"
    tabs = np.stack([s["tab"] for s in segs])
    ptabs = np.stack([s["ptab"] for s in segs])

    ref_v, ref_t, ref_pt = map(np.asarray, jax_eval.evaluate_packed_anchored_segmented(
        jparams, jnp.asarray(packed), jnp.asarray(buckets),
        jnp.asarray(parent), jnp.asarray(mat) if material else None,
        jnp.asarray(tabs), jnp.asarray(seg_rows), jnp.asarray(ptabs),
        use_pallas=False, copy_src=jnp.asarray(copy_src)))
    tab_t, ptab_t = torch.from_numpy(tabs.copy()), torch.from_numpy(
        ptabs.copy())
    values, _, _ = torch_eval.evaluate_packed_anchored_segmented(
        params, torch.from_numpy(packed.view(np.int16)),
        torch.from_numpy(buckets), torch.from_numpy(parent),
        torch.from_numpy(mat) if material else None, tab_t,
        torch.from_numpy(seg_rows), ptab_t, torch.from_numpy(copy_src))
    assert np.array_equal(values.numpy(), ref_v)
    assert np.array_equal(tab_t.numpy(), ref_t)
    assert np.array_equal(ptab_t.numpy(), ref_pt)


# -- the service --------------------------------------------------------------


def _analyses(results):
    return [(r.best_move, r.depth, r.nodes,
             tuple((l.multipv, l.depth, l.is_mate, l.value, tuple(l.pv))
                   for l in r.lines)) for r in results]


def _gated_smoke(svc, fens, nodes=160):
    """``tests/test_eval_cache.py``'s gated run: every search submitted
    before the driver steps; returns (analyses, counter deltas)."""
    try:
        svc.set_prefetch(0, adaptive=False)
        before = svc.counters()

        async def go():
            tasks = [asyncio.ensure_future(svc.search(fen, [], nodes=nodes))
                     for fen in fens]
            await asyncio.sleep(0.3)
            svc.gate.set()
            return await asyncio.gather(*tasks)

        results = asyncio.run(go())
        after = svc.counters()
    finally:
        svc.gate.set()
        svc.close()
    return _analyses(results), {k: after[k] - before.get(k, 0)
                                for k in after}


def _port(seed=7, **kw):
    return _gated(SearchService)(weights=NnueWeights.random(seed=seed),
                                 device="cpu", **{**GATED_KW, **kw})


def _jax(seed=7, **kw):
    return _gated(jax_service.SearchService)(
        weights=JaxWeights.random(seed=seed), backend="jax",
        **{**GATED_KW, **kw})


NEW_COUNTERS = ("cache_prewire_hits", "cache_skipped_dispatches",
                "position_dedup", "bounds_seeded", "bounds_harvested",
                "cache_entries", "cache_evictions", "bounds_harvest_errors")


@pytest.mark.parametrize("rung", [None, "host-material"])
def test_cache_off_cold_warm_match_each_other_and_jax(monkeypatch, rung):
    """Cache off, cold and warm (a fresh service over the surviving
    cache) give the same analyses, equal to the JAX service's cold run;
    the warm run answers batches before the wire and skips dispatches."""
    fens = _SMOKE_FENS[:4]
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    off, c_off = _gated_smoke(_port(psqt_path=rung), fens)
    assert eval_cache.get_cache() is None
    assert all(c_off[k] == 0 for k in NEW_COUNTERS)
    monkeypatch.delenv("FISHNET_NO_EVAL_CACHE")
    cold, c_cold = _gated_smoke(_port(psqt_path=rung), fens)
    warm, c_warm = _gated_smoke(_port(psqt_path=rung), fens)
    ref, _ = _gated_smoke(_jax(psqt_path=rung), fens)
    assert cold == off == warm == ref
    assert c_cold["eval_steps"] == c_off["eval_steps"]
    assert c_warm["cache_prewire_hits"] > 0
    assert c_warm["cache_skipped_dispatches"] > 0
    assert c_warm["dispatches"] < c_cold["dispatches"]
    assert c_cold["cache_entries"] > 0 and set(NEW_COUNTERS) <= set(c_warm)


def test_prewire_counts_equal_jax_per_group(monkeypatch):
    """FISHNET_NO_COALESCE=1, one driver thread: the per-group dispatch
    loop probes the same batches in both packages, so a cold and a warm
    run count the same pre-wire hits and skipped dispatches."""
    monkeypatch.setenv("FISHNET_NO_COALESCE", "1")
    fens = _SMOKE_FENS[:3]
    runs = {}
    for name, make in (("port", _port), ("jax", _jax)):
        runs[name] = [_gated_smoke(make(), fens) for _ in range(2)]
    for (p_out, p_c), (j_out, j_c) in zip(runs["port"], runs["jax"]):
        assert p_out == j_out
        for key in ("cache_prewire_hits", "cache_skipped_dispatches",
                    "eval_steps", "dispatches"):
            assert p_c[key] == j_c[key], (key, p_c[key], j_c[key])
    assert runs["port"][1][1]["cache_skipped_dispatches"] > 0


def test_cross_group_position_dedup_fan_out(monkeypatch):
    """One position searched in every group: the fused dispatches drop
    the repeats by position — persistent anchor codes among them, whose
    table rows the fan-in stores — and the analyses equal the dedup-off,
    cache-off run and the JAX service's."""
    fens = [_SMOKE_FENS[0]] * 8
    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "4")
    planned = []
    plan = port_service.plan_segment_dedup

    def recorder(parents, *args, **kwargs):
        out = plan(parents, *args, **kwargs)
        if kwargs.get("hashes") is not None:
            planned.append(sum(int((np.asarray(parents[k])[d] <= -2).sum())
                               for k, d in enumerate(out[0])))
        return out

    monkeypatch.setattr(port_service, "plan_segment_dedup", recorder)
    out, c = _gated_smoke(_port(), fens, nodes=200)
    assert len(set(out)) == 1, "duplicate searches diverged"
    assert c["position_dedup"] > 0 and c["fused_dispatches"] >= 1
    assert sum(planned) > 0, "no persistent anchor code was dropped"
    ref, jc = _gated_smoke(_jax(), fens, nodes=200)
    assert out == ref and jc["position_dedup"] > 0

    monkeypatch.setenv("FISHNET_NO_DEDUP", "1")
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    plain, c2 = _gated_smoke(_port(), fens, nodes=200)
    assert plain == out
    assert c2["position_dedup"] == 0


def _sequential(svc, nodes=220):
    """tests/test_bounds_plane.py's two searches, one after the other."""
    svc.set_prefetch(0, adaptive=False)

    async def go():
        out = []
        for moves in ([], ["e2e4", "e7e5"]):
            out.append(await svc.search(STARTPOS, moves, nodes=nodes))
        return out

    try:
        return _analyses(asyncio.run(go())), svc.counters()
    finally:
        svc.close()


def test_bounds_harvest_then_seed_matches_jax(monkeypatch):
    """The bounds tier on: a cold service harvests its PV records, a
    fresh service over the warm tier seeds them — the same analyses and
    the same harvested and seeded counts as the JAX package's sequence,
    and the same again when the sequence is repeated."""
    monkeypatch.setenv("FISHNET_NO_BOUNDS", "0")
    kw = dict(pool_slots=8, batch_capacity=64, tt_bytes=8 << 20,
              pipeline_depth=2, driver_threads=1)
    runs = []
    for make, reset in (
            (lambda: SearchService(weights=NnueWeights.random(seed=3),
                                   device="cpu", **kw), eval_cache),
            (lambda: jax_service.SearchService(
                weights=JaxWeights.random(seed=3), backend="jax", **kw),
             jax_cache),
            (lambda: SearchService(weights=NnueWeights.random(seed=3),
                                   device="cpu", **kw), eval_cache)):
        reset.reset_cache()
        cold, c1 = _sequential(make())
        bcache = reset.get_bounds_cache()
        assert bcache is not None and len(bcache) > 0
        warm, c2 = _sequential(make())
        runs.append((cold, warm, c1["bounds_harvested"], c1["bounds_seeded"],
                     c2["bounds_harvested"], c2["bounds_seeded"]))
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][2] > 0 and runs[0][3] == 0 and runs[0][5] > 0


def test_snapshot_warm_restart_resolves_its_first_batch_before_the_wire(
        tmp_path, monkeypatch):
    """Run, save the snapshot, lose the process cache, load it: the next
    service's first batch resolves before the wire, its analyses equal
    the cold run's, and it dispatches less."""
    snap = tmp_path / "cache.npz"
    monkeypatch.setenv(eval_cache.SNAPSHOT_ENV, str(snap))
    fp = NnueWeights.random(seed=13).fingerprint()
    fens = _SMOKE_FENS[:4]
    cold, c_cold = _gated_smoke(_port(seed=13), fens)
    assert eval_cache.save_snapshot(fingerprint=fp) == str(snap)
    eval_cache.reset_cache()
    assert eval_cache.load_snapshot(fingerprint=fp) is True

    svc = _port(seed=13)
    first = []
    probe = svc._probe_batch

    def recorder(g, n, hash_ptr, dctx=None):
        out = probe(g, n, hash_ptr, dctx)
        first.append(bool(out[2].all()))
        return out

    svc._probe_batch = recorder
    warm, c_warm = _gated_smoke(svc, fens)
    assert warm == cold
    assert first[0], "the first batch after the restart went to the wire"
    assert c_warm["cache_prewire_hits"] > 0
    assert c_warm["dispatches"] < c_cold["dispatches"]


def test_run_cli_loads_and_saves_the_snapshot(tmp_path):
    """``python -m fishnet_tpu_torch run`` with FISHNET_EVAL_CACHE_SNAPSHOT
    set loads the file at start (fingerprint 0: dev-mode random weights)
    and writes it again after the client stops."""
    import os
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    snap = tmp_path / "cache.npz"
    eval_cache.get_cache().insert(0xFEED, 123)
    assert eval_cache.save_snapshot(str(snap), fingerprint=0) == str(snap)
    mtime = snap.stat().st_mtime_ns
    root = Path(__file__).resolve().parent.parent
    with FakeServer() as server:
        job = server.lichess.add_analysis_job(moves="e2e4 e7e5")
        proc = subprocess.Popen(
            [sys.executable, "-m", "fishnet_tpu_torch", "run", "--device",
             "cpu", "--engine", "mock", "--no-conf", "--no-stats-file",
             "--endpoint", server.endpoint, "--key", VALID_KEY, "--cores",
             "1", "--max-backoff", "1"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, OMP_NUM_THREADS="1",
                                FISHNET_EVAL_CACHE_SNAPSHOT=str(snap)))
        try:
            deadline = time.monotonic() + 120
            while job not in server.lichess.analyses:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.05)
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert "Restored 1 eval-cache entries from snapshot." in out
    assert snap.stat().st_mtime_ns > mtime
    eval_cache.reset_cache()
    assert eval_cache.load_snapshot(str(snap), fingerprint=0)
    assert eval_cache.get_cache().probe(0xFEED) == 123


def test_queue_ticks_the_generation_per_completed_batch():
    """Each completed batch advances the process cache's generation."""
    cache = eval_cache.get_cache()
    gen0 = cache.stats()["generation"]

    async def go():
        with FakeServer() as server:
            jobs = [server.lichess.add_analysis_job(moves=m)
                    for m in ("e2e4 e7e5", "d2d4 d7d5 c2c4")]
            client = Client(endpoint=server.endpoint, key=VALID_KEY, cores=2,
                            engine_factory=MockEngineFactory(),
                            logger=Logger(verbose=0), max_backoff=0.2)
            await client.start()
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 20
            while (not all(j in server.lichess.analyses for j in jobs)
                   and loop.time() < deadline):
                await asyncio.sleep(0.02)
            await client.stop()
            return all(j in server.lichess.analyses for j in jobs)

    assert asyncio.run(go())
    assert cache.stats()["generation"] == gen0 + 2


def test_prefetch_steering_follows_the_hit_rate_as_jax(monkeypatch):
    """FISHNET_CACHE_PREFETCH=1: a high hit rate pins the pool's
    speculation budget to 0, a low one restores the adaptive policy,
    with the JAX service's hysteresis; without the variable there is no
    steering."""
    monkeypatch.setenv("FISHNET_CACHE_PREFETCH", "1")
    kw = dict(pool_slots=4, batch_capacity=64, tt_bytes=1 << 20)
    svcs = {"port": SearchService(weights=NnueWeights.random(seed=1),
                                  device="cpu", **kw),
            "jax": jax_service.SearchService(
                weights=JaxWeights.random(seed=1), backend="jax", **kw)}
    rates = [(10, 100), (70, 100), (50, 100), (20, 100), (90, 100)]
    try:
        got = {}
        for name, svc in svcs.items():
            assert svc._cache_steer
            seen = []
            for hits, probes in rates:
                svc._miss_hist = type(svc._miss_hist)()
                svc._miss_hist.record(0, hits, probes)
                svc._steer_prefetch(0)
                seen.append((svc._steer_state.get(0),
                             svc.counters()["prefetch_budget"]))
            got[name] = seen
    finally:
        for svc in svcs.values():
            svc.close()
    assert got["port"] == got["jax"]
    assert [s[0] for s in got["port"]] == [None, True, True, False, True]
    assert got["port"][1][1] == 0
    monkeypatch.delenv("FISHNET_CACHE_PREFETCH")
    svc = SearchService(weights=NnueWeights.random(seed=1), device="cpu",
                        **kw)
    svc.close()
    assert not svc._cache_steer


def test_position_tier_is_refused_until_ported(monkeypatch, tmp_path):
    """FISHNET_POSITION_TIER=1 attaches the fleet position tier where the
    JAX service attaches it: with the eval cache on; with
    FISHNET_NO_EVAL_CACHE=1 the service holds no tier."""
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
            svc = SearchService(weights=NnueWeights.random(seed=1),
                                device="cpu", pool_slots=4, batch_capacity=64)
            svc.close()
            assert (svc._postier is not None) == attached
            assert (svc._postier is position_tier.get_tier()) == attached
        assert position_tier.stats().get("attach.fleet", 0) >= 1
    finally:
        position_tier.reset_tier()
