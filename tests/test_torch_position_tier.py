"""The port's fleet position tier (fishnet_tpu_torch.cluster.position_tier)
and its hooks, against the JAX package's, on the CPU.

The counterparts of tests/test_position_tier.py's ten tests (segment
units, owner scopes, fingerprint isolation, the shared generation clock,
the graceful attach fallbacks, torn-slot safety under real writer
processes, SIGKILL-while-writing recovery, the service's tier-warmed
parity, and the two-process cross-process-hit smoke) and of the two tier
tests of tests/test_bounds_plane.py (the bounds slots' deeper-wins and
torn-slot reads). Then across the packages: the same inserts give
byte-identical segment files, each package reads the segment the other
wrote with the same values and scopes, a JAX and a port writer race on
one segment, the salts are equal for the same net, and a tier-on port
service equals the tier-on JAX service on the same seeded inputs (and
leaves the same segment behind). The NNUE is integer arithmetic: no
tolerance."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from fishnet_tpu.cluster import position_tier as jax_tier
from fishnet_tpu.search import eval_cache as jax_cache
from fishnet_tpu_torch.cluster import position_tier
from fishnet_tpu_torch.models.az import AzConfig, init_az_params
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.resilience.faults import FaultPlan
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.eval_cache import (
    BOUND_EXACT,
    BOUND_LOWER,
    BOUND_NONE,
    BOUND_UPPER,
    MOVE_NONE_BITS,
)

ROOT = Path(__file__).resolve().parents[1]
TIERS = {"port": position_tier, "jax": jax_tier}
TINY = AzConfig(channels=16, blocks=2, value_hidden=16)


def _val_of(key: int) -> int:
    """Deterministic value-from-key: any value a reader accepts can be
    checked against its key, so a torn or interleaved write that slipped
    past the seqlock and checksum would show as a wrong value."""
    return int((key * 2654435761) & 0x7FFFFFFF) - (1 << 30)


def _window_keys(n: int) -> np.ndarray:
    return np.array([(i * 0x9E3779B97F4A7C15) & ((1 << 64) - 1) or 1
                     for i in range(n)], dtype=np.uint64)


@pytest.fixture(autouse=True)
def fresh_caches():
    """The port's process-wide caches and both packages' tiers, reset
    around each test; the JAX tier's process-lifetime counters and its
    registry collector are put back as they were, since the JAX tier
    tests that may run next in this process read them as totals (a
    fleet hit counted here would be one there)."""
    with jax_tier._count_lock:
        counts = dict(jax_tier._counts)
    token = jax_tier._collector_token
    eval_cache.reset_cache()
    position_tier.reset_tier()
    jax_tier.reset_tier()
    yield
    eval_cache.reset_cache()
    position_tier.reset_tier()
    jax_tier.reset_tier()
    with jax_tier._count_lock:
        jax_tier._counts.clear()
        jax_tier._counts.update(counts)
    if token is None and jax_tier._collector_token is not None:
        from fishnet_tpu.telemetry.registry import REGISTRY

        REGISTRY.unregister_collector(jax_tier._collector_token)
        jax_tier._collector_token = None


@pytest.fixture
def tier_env(tmp_path, monkeypatch):
    seg = tmp_path / "tier.seg"
    monkeypatch.setenv("FISHNET_POSITION_TIER", "1")
    monkeypatch.setenv("FISHNET_POSITION_TIER_PATH", str(seg))
    monkeypatch.setenv("FISHNET_POSITION_TIER_CAPACITY", "4096")
    monkeypatch.setenv("FISHNET_POSITION_TIER_AZ_CAPACITY", "32")
    monkeypatch.setenv("FISHNET_POSITION_TIER_BOUNDS_CAPACITY", "1024")
    position_tier.reset_tier()
    return seg


# -- units ----------------------------------------------------------------------


def test_tier_nnue_roundtrip_exact_and_owner_scope(tier_env):
    tier = position_tier.get_tier()
    assert tier is not None
    keys = np.array([0x1234, 0x9876, 0xDEADBEEF], dtype=np.uint64)
    vals = np.array([17, -250, 31000], dtype=np.int32)
    tier.insert_nnue_block(keys, vals)
    out = np.zeros(3, np.int32)
    mask = np.zeros(3, bool)
    before = position_tier.stats()
    assert tier.probe_nnue_block(keys, out, mask) == 3
    assert mask.all() and (out == vals).all(), "int32 evals must be exact"
    # Rows already filled (mask set) are never re-probed or clobbered.
    out2 = np.array([111, 0, 0], np.int32)
    mask2 = np.array([True, False, False])
    assert tier.probe_nnue_block(keys, out2, mask2) == 2
    assert out2[0] == 111
    st = position_tier.stats()
    # Same pid wrote the slots: the hits are scope=local, not fleet.
    assert st.get("hits.local.nnue", 0) - before.get("hits.local.nnue", 0) == 5
    assert st.get("hits.fleet.nnue", 0) == before.get("hits.fleet.nnue", 0)


def test_tier_az_roundtrip_exact_fp16(tier_env):
    tier = position_tier.get_tier()
    policy = (np.random.RandomState(3).randn(position_tier.AZ_POLICY_SIZE)
              .astype(np.float16))
    tier.insert_az(0x777, policy, 0.125)
    got = tier.probe_az(0x777)
    assert got is not None
    gpol, gval = got
    assert gval == 0.125
    assert gpol.dtype == np.float16 and (gpol == policy).all(), (
        "the fp16 policy payload must round-trip bit-exact")
    assert tier.probe_az(0x778) is None


def test_tier_fingerprint_mismatch_isolation(tier_env):
    """Keys are salted ``zobrist ^ net_fingerprint`` by the caller, so two
    processes serving different nets key disjoint regions."""
    tier = position_tier.get_tier()
    zobrist = 0xABCDEF0123456789
    fp_a, fp_b = 0x1111, 0x2222
    tier.insert_nnue_block(np.array([zobrist ^ fp_a], np.uint64),
                           np.array([555], np.int32))
    out = np.zeros(1, np.int32)
    mask = np.zeros(1, bool)
    assert tier.probe_nnue_block(np.array([zobrist ^ fp_b], np.uint64),
                                 out, mask) == 0
    assert not mask[0]
    assert tier.probe_nnue_block(np.array([zobrist ^ fp_a], np.uint64),
                                 out, mask) == 1
    assert out[0] == 555


def test_tier_generation_clock_shared(tier_env):
    tier = position_tier.get_tier()
    g0 = tier.generation()
    tier.advance_generation()
    # A second attach of the same segment sees the tick: the clock lives
    # in the shared header, not in any process.
    position_tier.reset_tier()
    assert position_tier.get_tier().generation() == g0 + 1


def test_tier_disabled_and_absent_fallbacks(tmp_path, monkeypatch):
    # Env off: no tier, no segment file.
    monkeypatch.setenv("FISHNET_POSITION_TIER", "0")
    monkeypatch.setenv("FISHNET_POSITION_TIER_PATH", str(tmp_path / "off.seg"))
    position_tier.reset_tier()
    assert position_tier.get_tier() is None
    assert not (tmp_path / "off.seg").exists()
    # Env on but the path cannot be created: the local fallback, counted.
    monkeypatch.setenv("FISHNET_POSITION_TIER", "1")
    monkeypatch.setenv("FISHNET_POSITION_TIER_PATH",
                       str(tmp_path / "no" / "such" / "dir" / "x"))
    position_tier.reset_tier()
    before = position_tier.stats().get("attach.local", 0)
    assert position_tier.get_tier() is None
    assert position_tier.stats().get("attach.local", 0) == before + 1


def test_tier_corrupt_segment_rejected(tmp_path, monkeypatch):
    """A file that is not a tier segment (foreign magic) falls back to
    process-local; it is never read as slots."""
    seg = tmp_path / "garbage.seg"
    seg.write_bytes(b"\x00" * 64 + os.urandom(8192))
    monkeypatch.setenv("FISHNET_POSITION_TIER", "1")
    monkeypatch.setenv("FISHNET_POSITION_TIER_PATH", str(seg))
    position_tier.reset_tier()
    assert position_tier.get_tier() is None


# -- the bounds slots (tests/test_bounds_plane.py) --------------------------------


def _tier_probe(tier, keys):
    n = len(keys)
    cols = (np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.full(n, MOVE_NONE_BITS, np.uint32))
    hits = tier.probe_bounds_block(np.asarray(keys, np.uint64), *cols)
    return hits, cols


def test_tier_bounds_roundtrip_and_deeper_wins(tier_env):
    tier = position_tier.get_tier()
    assert tier is not None
    tier.insert_bound(0xABC, -77, 12, 9, BOUND_LOWER, 0x1234)
    hits, (vals, evs, deps, bnds, movs) = _tier_probe(tier, [0xABC, 0xDEF])
    assert hits == 1
    assert (vals[0], evs[0], deps[0], bnds[0], movs[0]) == (
        -77, 12, 9, BOUND_LOWER, 0x1234)
    assert bnds[1] == BOUND_NONE
    # A shallower same-key insert is refused; the deep record survives.
    tier.insert_bound(0xABC, 5, 5, 3, BOUND_EXACT, 1)
    _, (vals, _, deps, bnds, _) = _tier_probe(tier, [0xABC])
    assert (vals[0], deps[0], bnds[0]) == (-77, 9, BOUND_LOWER)
    # A deeper insert replaces.
    tier.insert_bound(0xABC, 31, 30, 12, BOUND_EXACT, 0x777)
    _, (vals, _, deps, bnds, movs) = _tier_probe(tier, [0xABC])
    assert (vals[0], deps[0], bnds[0], movs[0]) == (31, 12, BOUND_EXACT, 0x777)
    # A block insert skips miss-marked rows.
    tier.insert_bounds_block(
        np.array([0x111, 0x222], np.uint64),
        np.array([10, 20], np.int32), np.array([1, 2], np.int32),
        np.array([4, 4], np.int32),
        np.array([BOUND_NONE, BOUND_UPPER], np.int32),
        np.array([0, 0], np.uint32))
    hits, (_, _, _, bnds, _) = _tier_probe(tier, [0x111, 0x222])
    assert hits == 1 and bnds[0] == BOUND_NONE and bnds[1] == BOUND_UPPER


def test_tier_bounds_torn_slot_reads_as_miss(tier_env):
    """A clobbered payload (checksum mismatch) and a writer dead
    mid-write (odd seq) both read as misses, never as a value."""
    tier = position_tier.get_tier()
    tier.insert_bound(0x51, 400, 350, 8, BOUND_EXACT, 0x99)
    tier.insert_bound(0x52, -60, -50, 5, BOUND_UPPER, 0x11)
    assert _tier_probe(tier, [0x51, 0x52])[0] == 2

    def slot_of(key):
        for idx in range(len(tier._bounds)):
            if int(tier._bounds[idx]["key"]) == key:
                return idx
        raise AssertionError(f"key {key:#x} not in the bounds region")

    tier._bounds[slot_of(0x51)]["value"] ^= 0xFF
    tier._bounds[slot_of(0x52)]["seq"] |= 1
    hits, (_, _, _, bnds, _) = _tier_probe(tier, [0x51, 0x52])
    assert hits == 0 and not bnds.any()


# -- writer processes ---------------------------------------------------------------

# Writer child: hammers an overlapping key range with values derived from
# the key, so the parent can check every hit it reads while the writers
# race. argv: the package whose tier writes, base, n, rounds.
_WRITER = r"""
import importlib, sys
import numpy as np

pt = importlib.import_module(sys.argv[1] + ".cluster.position_tier")
base, n, rounds = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
tier = pt.get_tier()
assert tier is not None, "writer failed to attach"
keys = np.array([((base + i) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1) or 1
                 for i in range(n)], dtype=np.uint64)
vals = np.array([int((int(k) * 2654435761) & 0x7FFFFFFF) - (1 << 30)
                 for k in keys], dtype=np.int32)
print("ready", flush=True)
for _ in range(rounds):
    tier.insert_nnue_block(keys, vals)
print("done", flush=True)
"""


def _spawn_writer(package: str, n: int, rounds: int) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.Popen(
        [sys.executable, "-c", _WRITER, package, "0", str(n), str(rounds)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("writers", [("fishnet_tpu_torch", "fishnet_tpu_torch"),
                                     ("fishnet_tpu_torch", "fishnet_tpu")])
def test_tier_multiprocess_writers_never_serve_torn_values(tier_env, writers):
    """Two real writer processes (two of the port's, or one of each
    package's) hammer an overlapping window while this process reads:
    every hit carries the value derived from its key (a torn read or an
    interleaved write is a miss, never a wrong value), and hits on
    sibling-written slots count scope=fleet."""
    n, rounds = 64, 200
    procs = [_spawn_writer(pkg, n, rounds) for pkg in writers]
    try:
        tier = position_tier.get_tier()
        keys = _window_keys(n)
        expected = np.array([_val_of(int(k)) for k in keys], np.int32)
        out = np.zeros(n, np.int32)
        fleet0 = position_tier.stats().get("hits.fleet.nnue", 0)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            mask = np.zeros(n, bool)
            if tier.probe_nnue_block(keys, out, mask):
                assert (out[mask] == expected[mask]).all(), (
                    "the tier served a value inconsistent with its key")
            if all(p.poll() is not None for p in procs):
                break
        for p in procs:
            stdout, stderr = p.communicate(timeout=30)
            assert p.returncode == 0, stderr
            assert "done" in stdout
        mask = np.zeros(n, bool)
        assert tier.probe_nnue_block(keys, out, mask) == n
        assert (out == expected).all()
        assert position_tier.stats().get("hits.fleet.nnue", 0) > fleet0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_tier_sigkill_while_writing_recovers(tier_env):
    """SIGKILL a writer mid-flight, fired through the fault-plan grammar's
    ``proc.kill`` site as the fleet supervisor polls it: the survivor
    reads only key-consistent values, and a later writer reclaims any
    slot the victim left mid-write (odd seq)."""
    plan = FaultPlan.parse("seed=3;proc.kill:nth=3:crash")
    n = 64
    victim = _spawn_writer("fishnet_tpu_torch", n, 100_000)
    try:
        assert victim.stdout.readline().strip() == "ready"
        while True:  # the supervisor's per-tick poll
            time.sleep(0.02)
            if plan.poll("proc.kill") is not None:
                victim.send_signal(signal.SIGKILL)
                break
        victim.communicate(timeout=30)
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.communicate()
    assert victim.returncode == -signal.SIGKILL
    tier = position_tier.get_tier()
    keys = _window_keys(n)
    expected = np.array([_val_of(int(k)) for k in keys], np.int32)
    out = np.zeros(n, np.int32)
    mask = np.zeros(n, bool)
    hits = tier.probe_nnue_block(keys, out, mask)
    assert (out[mask] == expected[mask]).all(), "post-kill torn value"
    tier.insert_nnue_block(keys, expected)
    mask = np.zeros(n, bool)
    assert tier.probe_nnue_block(keys, out, mask) == n, (
        f"dead writer's slots not reclaimed (first pass served {hits})")
    assert (out == expected).all()


# -- across the packages -------------------------------------------------------------


def _fill(tier):
    """The same NNUE, AZ and bounds inserts, whichever package's tier."""
    keys = _window_keys(200)
    tier.insert_nnue_block(keys, np.array([_val_of(int(k)) for k in keys],
                                          np.int32))
    rng = np.random.RandomState(5)
    for key in (0x777, 0x778, 0x12345):
        tier.insert_az(key, rng.randn(tier.az_policy_size).astype(np.float16),
                       float(np.float32(rng.randn())))
    tier.insert_bound(0xABC, -77, 12, 9, BOUND_LOWER, 0x1234)
    tier.insert_bound(0xABD, 31, 30, 12, BOUND_EXACT, 0x777)
    tier.advance_generation()
    tier.insert_bound(0xABE, 5, 4, 2, BOUND_UPPER, 9)


def _read(tier):
    keys = _window_keys(210)
    out = np.zeros(len(keys), np.int32)
    mask = np.zeros(len(keys), bool)
    tier.probe_nnue_block(keys, out, mask)
    az = []
    for key in (0x777, 0x778, 0x12345, 0x999):
        got = tier.probe_az(key)
        az.append(None if got is None
                  else (got[0].view(np.uint16).tolist(), got[1]))
    _, cols = _tier_probe(tier, [0xABC, 0xABD, 0xABE, 0xABF])
    return (out.tolist(), mask.tolist(), az, [c.tolist() for c in cols],
            tier.generation())


def test_same_inserts_give_byte_identical_segments(tier_env, tmp_path):
    """The segment format is the JAX one byte for byte: header, NNUE, AZ
    and bounds slots, seqlocks, checksums and the generation clock."""
    segs = {}
    for name, mod in TIERS.items():
        segs[name] = tmp_path / f"{name}.seg"
        tier = mod._attach(str(segs[name]))
        try:
            _fill(tier)
        finally:
            tier.close()
    data = {name: path.read_bytes() for name, path in segs.items()}
    assert data["port"][:8] == (0x46_4E_50_54_49_45_52_31).to_bytes(8, "little")
    assert len(data["port"]) == len(data["jax"]) == (
        4096 + 4096 * 32 + 32 * jax_tier._az_slot_dtype(4672).itemsize
        + 1024 * 48)
    assert data["port"] == data["jax"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_segment(tier_env, tmp_path, writer):
    """A segment one package wrote, read by both: the same values, and
    the same scopes (written under another owner: every hit is fleet)."""
    path = str(tmp_path / "shared.seg")
    w = TIERS[writer]._attach(path)
    w._owner = (os.getpid() + 1) & 0xFFFFFFFF  # a sibling process's slots
    try:
        _fill(w)
    finally:
        w.close()
    got, scopes = {}, {}
    for name, mod in TIERS.items():
        before = mod.stats()
        tier = mod._attach(path)
        try:
            got[name] = _read(tier)
        finally:
            tier.close()
        after = mod.stats()
        scopes[name] = {k: after[k] - before.get(k, 0) for k in after
                        if k.startswith(("hits.", "misses."))
                        and after[k] != before.get(k, 0)}
    assert got["port"] == got["jax"]
    assert scopes["port"] == scopes["jax"]
    assert scopes["port"]["hits.fleet.nnue"] == 200
    assert scopes["port"]["hits.fleet.az"] == 3
    assert scopes["port"]["hits.fleet.bounds"] == 3
    assert not any(k.startswith("hits.local") for k in scopes["port"])


def test_salts_equal_jax_for_the_same_net(tmp_path):
    """The tier keys entries ``zobrist ^ net fingerprint``: the port's NNUE
    and AZ salts are the JAX salts for the same net, so a segment written
    by one package serves the other."""
    from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
    from fishnet_tpu_torch.search.az_plane import AzDispatchPlane
    from fishnet_tpu_torch.search.mcts import MctsConfig
    from fishnet_tpu_torch.search.service import SearchService

    path = tmp_path / "net.nnue"
    NnueWeights.random(seed=3).save(str(path))
    assert (eval_cache.net_fingerprint(str(path))
            == jax_cache.net_fingerprint(str(path)))
    assert JaxWeights.load(str(path)).fingerprint() == (
        eval_cache.net_fingerprint(str(path)))
    svc = SearchService(weights=NnueWeights.load(str(path)), device="cpu",
                        pool_slots=4, batch_capacity=64)
    svc.close()
    assert int(svc._cache_salt) == jax_cache.net_fingerprint(str(path))
    params = init_az_params(0, TINY)  # the JAX .npz layout, as numpy
    assert (eval_cache.az_net_fingerprint(params)
            == jax_cache.az_net_fingerprint(params))
    plane = AzDispatchPlane(params, MctsConfig(batch_capacity=64, az=TINY),
                            device="cpu")
    plane.close()
    assert plane._salt == jax_cache.az_net_fingerprint(params)


# -- the service ----------------------------------------------------------------------


def test_service_fleet_tier_parity_and_reuse(tier_env, monkeypatch, tmp_path):
    """The supervisor-respawn shape in one process, against the JAX
    service: a tier-off run, a tier-on cold run that fills the segment,
    and, after the process cache dies, a warm run off the tier; the port
    and the JAX service give the same analyses in every run, the warm
    run takes pre-wire hits and makes fewer dispatches than the cold
    one, and the cold runs leave the same segment bytes behind."""
    from test_torch_coalesce import _SMOKE_FENS
    from test_torch_eval_cache import _gated_smoke, _jax, _port

    fens = _SMOKE_FENS[:4]
    runs = {}
    for name, make, cache, tiers in (
            ("port", _port, eval_cache, position_tier),
            ("jax", _jax, jax_cache, jax_tier)):
        seg = tmp_path / f"{name}-service.seg"
        monkeypatch.setenv("FISHNET_POSITION_TIER", "0")
        tiers.reset_tier()
        cache.reset_cache()
        off, _ = _gated_smoke(make(), fens)
        monkeypatch.setenv("FISHNET_POSITION_TIER", "1")
        monkeypatch.setenv("FISHNET_POSITION_TIER_PATH", str(seg))
        tiers.reset_tier()
        cache.reset_cache()
        local0 = tiers.stats().get("hits.local.nnue", 0)
        cold, c_cold = _gated_smoke(make(), fens)
        cold_bytes = seg.read_bytes()
        cache.reset_cache()  # process death; the segment survives
        warm, c_warm = _gated_smoke(make(), fens)
        runs[name] = (off, cold, warm, cold_bytes)
        assert cold == off, f"{name}: the tier-on cold run changed analyses"
        assert warm == off, f"{name}: the tier-warmed run changed analyses"
        assert c_warm["cache_prewire_hits"] > 0
        assert c_warm["dispatches"] < c_cold["dispatches"]
        assert tiers.stats().get("hits.local.nnue", 0) > local0
        tiers.reset_tier()
        cache.reset_cache()
    assert runs["port"][:3] == runs["jax"][:3]
    assert runs["port"][3] == runs["jax"][3]


# Driver child: a SearchService on the CPU against the shared segment,
# printing (analyses, tier stats) as one JSON line. Sequential searches
# keep the schedule the same in both processes.
_DRIVER = r"""
import asyncio, json
from fishnet_tpu_torch.cluster import position_tier
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.search.service import SearchService

FENS = [
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
    "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 2 3",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
    "4rrk1/pp1n3p/3q2pQ/2p1pb2/2PP4/2P3N1/P2B2PP/4RRK1 b - - 7 19",
]

svc = SearchService(weights=NnueWeights.random(seed=7), device="cpu",
                    pool_slots=8, batch_capacity=256, tt_bytes=8 << 20,
                    pipeline_depth=4, driver_threads=1)
svc.set_prefetch(0, adaptive=False)


async def go():
    out = []
    for fen in FENS:
        r = await svc.search(fen, [], nodes=160)
        out.append([r.best_move, r.depth,
                    [[l.multipv, l.depth, l.is_mate, l.value, list(l.pv)]
                     for l in r.lines]])
    return out


analyses = asyncio.run(go())
counters = svc.counters()
svc.close()
print(json.dumps({"analyses": analyses, "stats": position_tier.stats(),
                  "dispatches": counters["dispatches"]}))
"""


def _run_driver(seg: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               FISHNET_POSITION_TIER="1",
               FISHNET_POSITION_TIER_PATH=str(seg),
               FISHNET_POSITION_TIER_CAPACITY="4096")
    proc = subprocess.run([sys.executable, "-c", _DRIVER], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fleet_cache_two_process_smoke(tmp_path):
    """Process A pays the evals and fills the shared segment; process B,
    another pid, replays the same traffic and takes fleet-scope hits,
    with the same analyses and fewer dispatches."""
    seg = tmp_path / "fleet.seg"
    a = _run_driver(seg)
    b = _run_driver(seg)
    assert b["analyses"] == a["analyses"], (
        "cross-process tier reuse changed analyses")
    assert b["stats"].get("hits.fleet.nnue", 0) > 0, b["stats"]
    assert a["stats"].get("hits.fleet.nnue", 0) == 0, a["stats"]
    assert a["stats"].get("attach.fleet", 0) == 1
    assert b["dispatches"] < a["dispatches"]
