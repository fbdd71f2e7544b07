"""The port's self-play (fishnet_tpu_torch.train.selfplay) against the JAX
package's, on the CPU, and the closed AZ training loop on the port's
shared plane.

Both packages' pools get one deterministic numpy evaluator through
``evaluator=`` (tests/test_torch_mcts.py's ``ProjectionEval``), so every
tree is the same, and the temperature moves come from the same numpy
seed: the games must be the same move for move and record for record
(planes, visit policy, side to move, outcome), and so the batches. Then
the port's versions of tests/test_selfplay.py over the port's own
shared plane (a seeded TINY net)."""

import numpy as np
import pytest
import torch

from fishnet_tpu.search import mcts as jax_mcts
from fishnet_tpu.train import selfplay as jax_selfplay
from fishnet_tpu_torch.models.az import AzConfig, init_az_params
from fishnet_tpu_torch.models.az_encoding import INPUT_PLANES, POLICY_SIZE
from fishnet_tpu_torch.search import eval_cache, mcts
from fishnet_tpu_torch.train import AzTrainer, selfplay
from fishnet_tpu_torch.train.selfplay import SelfPlayConfig, play_games, selfplay_batch
from test_torch_mcts import ProjectionEval

TINY = AzConfig(channels=16, blocks=2, value_hidden=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_port_cache():
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


def _games(module, sp, cfg, seed):
    pool = module.MctsPool({}, module.MctsConfig(batch_capacity=64),
                           evaluator=ProjectionEval(seed=4))
    try:
        return sp.play_games(pool, cfg, seed=seed)
    finally:
        pool.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_play_games_equal_jax_with_one_injected_evaluator(seed):
    cfg = SelfPlayConfig(games=4, visits=24, max_plies=30, temperature_moves=6)
    got = _games(mcts, selfplay, cfg, seed)
    want = _games(jax_mcts, jax_selfplay,
                  jax_selfplay.SelfPlayConfig(games=4, visits=24, max_plies=30,
                                              temperature_moves=6), seed)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.moves == w.moves and g.outcome_white == w.outcome_white
        assert len(g.records) == len(w.records) == len(g.moves)
        for r, q in zip(g.records, w.records):
            assert r.stm_white == q.stm_white
            assert np.array_equal(r.planes, q.planes)
            assert np.array_equal(r.policy, q.policy)
    batch = selfplay.games_to_batch(got)
    ref = jax_selfplay.games_to_batch(want)
    for k in ref:
        assert batch[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(batch[k], ref[k], err_msg=k)
    # The temperature moves were sampled: the games differ from each other.
    assert len({tuple(g.moves[:6]) for g in got}) > 1


@pytest.fixture(scope="module")
def pool():
    """A seeded TINY net on the port's shared plane, on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = mcts.MctsPool(init_az_params(7, TINY),
                      mcts.MctsConfig(batch_capacity=128, az=TINY), device="cpu")
    yield p
    p.close()
    torch.set_num_threads(threads)


def test_selfplay_games_complete(pool):
    games = play_games(pool, SelfPlayConfig(games=4, visits=12, max_plies=24), seed=0)
    assert len(games) == 4
    for g in games:
        assert g.outcome_white in (-1.0, 0.0, 1.0)
        assert 1 <= len(g.records) <= 24
        assert len(g.moves) == len(g.records)
    assert pool.counters()["dispatch"]["dispatches"] > 0  # the shared plane


def test_selfplay_batch_shapes_and_targets(pool):
    batch = selfplay_batch(pool, SelfPlayConfig(games=3, visits=12, max_plies=16), seed=1)
    n = batch["planes"].shape[0]
    assert batch["planes"].shape == (n, 8, 8, INPUT_PLANES)
    assert batch["policy_target"].shape == (n, POLICY_SIZE)
    assert batch["value_target"].shape == (n,)
    np.testing.assert_allclose(batch["policy_target"].sum(axis=1), 1.0, atol=1e-5)
    assert set(np.unique(batch["value_target"])) <= {-1.0, 0.0, 1.0}


def test_no_game_gives_an_empty_batch():
    batch = selfplay.games_to_batch([])
    assert batch["planes"].shape == (0, 8, 8, INPUT_PLANES)
    assert batch["policy_target"].shape == (0, POLICY_SIZE)


def test_closed_training_loop(pool):
    """generate -> train: one generation of self-play feeds AzTrainer and
    the loss falls when overfitting that generation."""
    batch = selfplay_batch(pool, SelfPlayConfig(games=3, visits=12, max_plies=12), seed=2)
    trainer = AzTrainer(cfg=TINY, learning_rate=3e-3, device="cpu")
    state = trainer.init(seed=0)
    losses = []
    for _ in range(15):
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"])
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
