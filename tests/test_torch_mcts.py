"""The port's batched PUCT MCTS (fishnet_tpu_torch.search.mcts) against the
JAX package's MctsPool, on the CPU, bit for bit.

Both pools get the same deterministic numpy evaluator through
``evaluator=`` (logits and values a fixed function of the uint8 wire
planes), so every tree decision — selection, virtual loss, the adaptive
leaf width, backups, the expansion memo, subtree reuse, the result's
ranking — must come out the same: best move, visits, value, root
visits and PV of every search, and the pools' counters. Then the port's
versions of the JAX pool tests of ``tests/test_az_mcts.py`` on the
port's own forward (a seeded TINY net through the shared plane)."""

import numpy as np
import pytest
import torch

from fishnet_tpu.search import mcts as jax_mcts
from fishnet_tpu_torch.chess.board import Board
from fishnet_tpu_torch.models.az import AzConfig, init_az_params
from fishnet_tpu_torch.models.az_encoding import POLICY_SIZE
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search import mcts

STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
MATE_FEN = "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1"
TINY = AzConfig(channels=16, blocks=2, value_hidden=16)
OPENINGS = [[], ["e2e4"], ["d2d4"], ["g1f3"], ["e2e4", "c7c5"],
            ["e2e4", "e7e5"], ["d2d4", "d7d5"], ["d2d4", "g8f6"]]


@pytest.fixture(autouse=True)
def fresh_port_cache():
    """The port's process-wide caches, reset around each test (the
    conftest resets only the JAX package's)."""
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ProjectionEval:
    """A deterministic evaluator: logits and values are fixed random
    projections of the uint8 planes (so the priors differ by position),
    float32, the same bits for both packages. Counts its calls."""

    def __init__(self, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self._w = (rng.standard_normal((8 * 8 * 19, POLICY_SIZE)) * 0.02).astype(np.float32)
        self._v = (rng.standard_normal(8 * 8 * 19) * 0.02).astype(np.float32)
        self.calls = 0
        self.rows = 0

    def warmup(self, cap):
        pass

    def evaluate(self, planes_u8, n, keys=None):
        self.calls += 1
        self.rows += n
        x = planes_u8[:n].reshape(n, -1).astype(np.float32)
        return x @ self._w, np.tanh(x @ self._v).astype(np.float32)

    def close(self):
        pass


def harvest_all(pool, sids):
    while pool.active() > 0:
        pool.step()
    out = []
    for sid in sids:
        r = pool.harvest(sid)
        out.append((r.best_move, r.visits, r.value, r.cp, r.depth,
                    tuple(r.root_visits), tuple(r.pv),
                    tuple((l.multipv, l.move, l.value, tuple(l.pv)) for l in r.lines)))
    return out


def workload(pool, kind):
    """Runs one of the comparison workloads; returns every result."""
    if kind == "concurrent":
        sids = [pool.submit(STARTPOS, list(OPENINGS[i % 8]), 80 + 8 * i,
                            multipv=1 + i % 3) for i in range(8)]
        return harvest_all(pool, sids)
    if kind == "reuse":
        # A game advancing one and two plies: the later submits rebase
        # the harvested trees.
        out = []
        game = ["e2e4", "e7e5", "g1f3", "b8c6", "f1b5"]
        for ply in (0, 1, 3, 4, 5):
            out += harvest_all(pool, [pool.submit(STARTPOS, game[:ply], 120)])
        return out
    if kind == "memo":
        out = harvest_all(pool, [pool.submit(STARTPOS, ["d2d4"], 150)])
        # A transposition and the same position again, from another tree.
        out += harvest_all(pool, [pool.submit(STARTPOS, ["g1f3", "g8f6", "d2d4"], 90),
                                  pool.submit(STARTPOS, ["d2d4", "g8f6", "g1f3"], 90)])
        return out
    if kind == "forced":
        return harvest_all(pool, [pool.submit("4k3/8/8/8/8/7P/2q5/K7 w - - 0 1", [], 60),
                                  pool.submit("k7/8/2K5/8/8/8/8/1R6 b - - 0 1", [], 40),
                                  pool.submit(MATE_FEN, [], 200)])
    raise ValueError(kind)


CFG_KW = {
    "concurrent": dict(batch_capacity=64),
    "reuse": dict(batch_capacity=32, leaves_per_step=4),
    "memo": dict(batch_capacity=48),
    "forced": dict(batch_capacity=32, leaves_per_step=8, adaptive_leaves=False),
}


@pytest.mark.parametrize("hatch", [None, "FISHNET_NO_EXPANSION_MEMO",
                                   "FISHNET_NO_SUBTREE_REUSE"])
@pytest.mark.parametrize("kind", sorted(CFG_KW))
def test_pool_equals_jax_with_the_same_evaluator(kind, hatch, monkeypatch):
    if hatch is not None:
        monkeypatch.setenv(hatch, "1")
    results, counters = [], []
    for module in (mcts, jax_mcts):
        ev = ProjectionEval(seed=3)
        pool = module.MctsPool({}, module.MctsConfig(**CFG_KW[kind]), evaluator=ev)
        try:
            results.append(workload(pool, kind))
            c = pool.counters()
            counters.append({k: c[k] for k in (
                "visits", "collisions", "evals", "steps", "reuse_hits",
                "memo_hits", "memo_entries", "fill_ema")} | {"rows": ev.rows})
        finally:
            pool.close()
    assert results[0] == results[1]
    assert counters[0] == counters[1]
    assert counters[0]["visits"] > 0
    if kind == "reuse" and hatch != "FISHNET_NO_SUBTREE_REUSE":
        assert counters[0]["reuse_hits"] > 0
    if kind == "memo" and hatch != "FISHNET_NO_EXPANSION_MEMO":
        assert counters[0]["memo_hits"] > 0
    if kind == "forced":
        assert counters[0]["collisions"] > 0


@pytest.mark.parametrize("clock", [0, 57, 99])
def test_planes_and_keys_on_the_wire_equal_jax(clock):
    """The pool's uint8 batch (plane 17 carries the clock x100, clipped
    before the cast) and its unsalted keys, step by step."""
    fen = f"8/8/8/4k3/8/8/4P3/4K3 w - - {clock} 70"
    seen = []

    class Spy(ProjectionEval):
        def evaluate(self, planes_u8, n, keys=None):
            seen.append((planes_u8[:n].copy(), list(keys)))
            return super().evaluate(planes_u8, n, keys)

    for module in (mcts, jax_mcts):
        pool = module.MctsPool({}, module.MctsConfig(batch_capacity=32), evaluator=Spy())
        harvest_all(pool, [pool.submit(fen, [], 20)])
        pool.close()
    half = len(seen) // 2
    assert half > 0 and len(seen) == 2 * half
    for (p, pk), (j, jk) in zip(seen[:half], seen[half:]):
        np.testing.assert_array_equal(p, j)
        assert pk == jk
    assert seen[0][0][0, 0, 0, 17] == clock
    board = Board(fen)
    assert seen[0][1][0] == eval_cache.az_position_key(board.zobrist_hash(), clock)


# -- the JAX package's pool tests, on the port's own forward --------------------


@pytest.fixture(scope="module")
def pool():
    eval_cache.reset_cache()
    p = mcts.MctsPool(init_az_params(1, TINY), mcts.MctsConfig(batch_capacity=64, az=TINY),
                      device="cpu")
    yield p
    p.close()
    eval_cache.reset_cache()


def run_pool(pool, sids):
    for _ in range(10_000):
        pool.step()
        if pool.active() == 0:
            break
    return {sid: pool.harvest(sid) for sid in sids}


def test_mcts_finds_mate_in_one(pool):
    sid = pool.submit(MATE_FEN, [], visits=400)
    result = run_pool(pool, [sid])[sid]
    assert result.best_move == "d1d8"
    assert result.value > 0.8
    assert result.pv[0] == "d1d8"


def test_mcts_terminal_root(pool):
    sid = pool.submit(
        "rnb1kbnr/pppp1ppp/8/4p3/6Pq/5P2/PPPPP2P/RNBQKBNR w KQkq - 1 3", [], visits=64)
    result = run_pool(pool, [sid])[sid]
    assert result.best_move is None
    assert result.value == -1.0


def test_mcts_concurrent_searches(pool):
    sids = [pool.submit(STARTPOS, ["e2e4"], visits=48),
            pool.submit(STARTPOS, [], visits=48),
            pool.submit(MATE_FEN, [], visits=200)]
    results = run_pool(pool, sids)
    assert all(r.best_move for r in results.values())
    assert results[sids[2]].best_move == "d1d8"
    assert all(r.visits > 0 for r in results.values())


def test_mcts_forced_move_no_duplicate_expansion(pool):
    sid = pool.submit("k7/8/2K5/8/8/8/8/1R6 b - - 0 1", [], visits=24)
    result = run_pool(pool, [sid])[sid]
    assert result.best_move == "a8a7"
    assert result.visits >= 24


def test_mcts_avoids_stalemate_draw(pool):
    sid = pool.submit("7k/5Q2/5K2/8/8/8/8/8 w - - 0 1", [], visits=300)
    result = run_pool(pool, [sid])[sid]
    board = Board("7k/5Q2/5K2/8/8/8/8/8 w - - 0 1")
    board.push_uci(result.best_move)
    assert board.outcome() != Board.STALEMATE
