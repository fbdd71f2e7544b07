"""The port's NNUE data pipeline (fishnet_tpu_torch.train.data: playouts,
teacher labels) and ``Board.nnue_features`` against the JAX package's,
on the CPU, exactly: the same seed gives the same playouts FEN for FEN,
the same position the same features, and the same net and positions the
same label batch bit for bit.

Labels: a shared transposition table makes concurrent searches depend
on their interleaving, so the cross-package comparison searches one
position at a time (one pool slot, prefetch pinned to 0) on the native
scalar evaluator of each package; the port's batched CPU service
(``chip_smoke.gated_service``: 64 slots, one driver thread parked until
every search is queued, as the chip's train phase runs it) must give the
same batch."""

import asyncio

import numpy as np
import pytest
import torch

from chip_smoke import gated_labels, gated_service
from fishnet_tpu.chess.board import Board as JaxBoard
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.search.service import SearchService as JaxService
from fishnet_tpu.train.data import label_positions as jax_label_positions
from fishnet_tpu.train.data import playout_positions as jax_playout_positions
from fishnet_tpu_torch.chess.board import Board, UnsupportedVariantError
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.protocol.types import Variant
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.train import NetConfig, Trainer
from fishnet_tpu_torch.train.data import label_positions, playout_positions

_COMMON = dict(batch_capacity=64, tt_bytes=8 << 20)


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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_playout_positions_equal_jax(seed):
    got = playout_positions(n_games=3, max_plies=40, seed=seed)
    assert got == jax_playout_positions(n_games=3, max_plies=40, seed=seed)
    assert got and all(score in (0.0, 0.5, 1.0) for _fen, score in got)


def test_nnue_features_equal_jax_on_50_playout_positions():
    positions = playout_positions(n_games=4, max_plies=40, seed=5)[:50]
    assert len(positions) == 50
    for fen, _score in positions:
        idx, bucket = Board(fen).nnue_features()
        ref_idx, ref_bucket = JaxBoard(fen).nnue_features()
        assert idx.dtype == np.int32 and idx.shape == (2, 32)
        np.testing.assert_array_equal(idx, ref_idx, err_msg=fen)
        assert bucket == ref_bucket, fen
        assert (idx <= spec.NUM_FEATURES).all()


def test_nnue_features_refuse_variants():
    board = Board("rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
                  variant=Variant.ATOMIC)
    with pytest.raises(UnsupportedVariantError):
        board.nnue_features()


def _labels(service, positions, nodes):
    service.set_prefetch(0, adaptive=False)
    try:
        return asyncio.run(label_positions(service, positions, nodes))
    finally:
        service.close()


def test_label_positions_equal_jax_bit_for_bit():
    positions = jax_playout_positions(n_games=2, max_plies=16, seed=1)[:12]
    jax_svc = JaxService(weights=JaxWeights.random(seed=0), pool_slots=1,
                         backend="scalar", **_COMMON)
    jax_svc.set_prefetch(0, adaptive=False)
    try:
        want = asyncio.run(jax_label_positions(jax_svc, positions, nodes=400))
    finally:
        jax_svc.close()
    weights = NnueWeights.random(seed=0)
    scalar = _labels(SearchService(weights=weights, pool_slots=1,
                                   backend="scalar", **_COMMON), positions, 400)
    batched = gated_service(weights, "cpu", pool_slots=64, pipeline_depth=2,
                            **_COMMON)
    try:
        got = gated_labels(batched, positions, 400)
        counters = batched.counters()
    finally:
        batched.close()
    assert counters["dispatches"] > 0
    for batch in (scalar, got):
        assert set(batch) == set(want)
        for k in want:
            assert batch[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    n = want["indices"].shape[0]
    assert n == len(positions) and want["indices"].shape == (n, 2, 32)
    assert np.all(np.abs(got["score_cp"]) <= 30000)
    assert set(np.unique(got["outcome"])) <= {0.0, 0.5, 1.0}


def test_labelled_batch_feeds_the_full_spec_trainer():
    positions = playout_positions(n_games=2, max_plies=14, seed=3)[:6]
    batch = _labels(SearchService(weights=NnueWeights.random(seed=0),
                                  pool_slots=8, backend="scalar", **_COMMON),
                    positions, 200)
    assert batch["indices"].shape[0] == len(positions)
    trainer = Trainer(cfg=NetConfig(), device="cpu")
    state, metrics = trainer.step(trainer.init(seed=0), batch)
    assert np.isfinite(metrics["loss"]) and state.step == 1


def test_no_position_gives_an_empty_batch():
    batch = _labels(SearchService(weights=NnueWeights.random(seed=0),
                                  pool_slots=8, backend="scalar", **_COMMON),
                    [], 100)
    assert batch["indices"].shape == (0, 2, 32)
    assert batch["indices"].dtype == np.int32
    assert batch["score_cp"].shape == batch["outcome"].shape == (0,)
