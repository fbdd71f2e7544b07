"""The port's AZ model family (fishnet_tpu_torch.models.az_encoding,
fishnet_tpu_torch.models.az, the board's move counters and the AZ cache
key's fingerprint) against the JAX package's, on the CPU.

The encodings, the board counters and the fingerprint are exact: the
same legal moves, planes and bytes give the same integers. The forward
is compared on the same ``.npz`` and the same uint8 wire planes through
both packages' wire wrappers (the JAX one is the jitted wrapper of
``fishnet_tpu/search/mcts.py``), within a stated tolerance: both compute
in bfloat16 and round the same ops, but a conv or matmul sums its
products in another order in XLA than in PyTorch, so a logit may differ
by a few bf16 steps. Tolerance: ``|port - jax| <= 2**-5 * max(1,
max|jax|)`` for the logits and for the values — a bf16 step is 2**-8 of
the value's magnitude, and 13 chained rounded layers may each move a
result by one."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.chess.board import Board as JaxBoard
from fishnet_tpu.models import az as jax_az
from fishnet_tpu.models import az_encoding as jax_enc
from fishnet_tpu.search import eval_cache as jax_cache
from fishnet_tpu_torch.chess.board import Board
from fishnet_tpu_torch.models import az, az_encoding
from fishnet_tpu_torch.search import eval_cache

TINY = az.AzConfig(channels=16, blocks=2, value_hidden=16)
JAX_TINY = jax_az.AzConfig(channels=16, blocks=2, value_hidden=16)
STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
TOLERANCE = 2.0 ** -5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small forwards: torch's intra-op threads cost more than they give
    beside other test processes (ROADMAP C8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_positions(seed: int, games: int = 6, plies: int = 40):
    """FENs of seeded random games (both colours to move, captures,
    promotions, castling and en passant as they come)."""
    rng = random.Random(seed)
    fens = []
    for _ in range(games):
        board = Board(STARTPOS)
        for _ in range(plies):
            moves = board.legal_moves()
            if not moves or board.outcome() != Board.ONGOING:
                break
            fens.append(board.fen())
            board.push_uci(rng.choice(moves))
    return fens


def trained_like(cfg: az.AzConfig, seed: int) -> dict:
    """Seeded parameters with every leaf live: the dev-mode draw plus
    small biases and a nonzero value head (a fresh init has zero biases
    and a zero fc2, which would hide the bias rounding and the value
    path)."""
    rng = np.random.default_rng(seed)
    params = az.init_az_params(seed, cfg)
    for name, arr in params.items():
        if not arr.any():
            params[name] = (rng.standard_normal(arr.shape) * 0.05).astype(np.float32)
    return params


def wire_planes(rng, n: int) -> np.ndarray:
    x = rng.integers(0, 2, (n, 8, 8, 19)).astype(np.uint8)
    x[..., 17] = rng.integers(0, 101, (n, 1, 1))
    return x


def jax_wire_forward(params: dict, planes_u8: np.ndarray, cfg):
    """The JAX package's dispatch wrapper (``mcts.py:543-547``)."""
    def forward(p, x_u8):
        x = x_u8.astype(jnp.float32)
        x = x.at[..., 17].multiply(1.0 / 100.0)
        logits, values = jax_az.az_forward(p, x, cfg)
        return logits.astype(jnp.float16), values

    p = {k: jnp.asarray(v) for k, v in params.items()}
    logits, values = jax.jit(forward)(p, planes_u8)
    return np.asarray(logits), np.asarray(values)


# -- encodings ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_move_indices_equal_jax_over_random_games(seed):
    fens = random_positions(seed)
    assert {f.split()[1] for f in fens} == {"w", "b"}
    for fen in fens:
        board = Board(fen)
        moves = board.legal_moves()
        white = board.turn() == "w"
        got = az_encoding.legal_policy_indices(moves, white)
        ref = jax_enc.legal_policy_indices(moves, white)
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        assert len(set(got.tolist())) == len(moves), fen
        for m in moves:
            assert az_encoding.move_to_index(m, white) == jax_enc.move_to_index(m, white)


@pytest.mark.parametrize("bad", ["P@e4", "a7b8k", "e2e2", "a1h3"])
def test_move_outside_the_encoding_raises_like_jax(bad):
    with pytest.raises(ValueError):
        jax_enc.move_to_index(bad, True)
    with pytest.raises(ValueError):
        az_encoding.move_to_index(bad, True)


PLANE_FENS = [
    STARTPOS,
    "rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR b KQkq e3 0 1",
    "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w Kq - 37 40",
    "8/8/8/4k3/8/8/4P3/4K3 w - - 99 120",
    "8/8/8/4k3/8/8/4P3/4K3 b - - 300 400",  # clock above 255
    "4k3/8/8/8/8/8/8/4K2R w K - 255 200",
    "bqnb1rkr/pp3ppp/3ppn2/2p5/5P2/P2P4/NPP1P1PP/BQ1BNRKR w HFhf - 2 9",
    "rnbqkbnr/ppp1p1pp/8/3pPp2/8/8/PPPP1PPP/RNBQKBNR w KQkq f6 0 3",
]


@pytest.mark.parametrize("fen", PLANE_FENS)
def test_board_planes_equal_jax(fen):
    got = az_encoding.board_planes(fen)
    ref = jax_enc.board_planes(fen)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fen", PLANE_FENS[:6])
def test_board_move_counters_equal_jax(fen):
    board, ref = Board(fen), JaxBoard(fen)
    assert board.halfmove_clock() == ref.halfmove_clock() == int(fen.split()[4])
    assert board.fullmove_number() == ref.fullmove_number() == int(fen.split()[5])
    for m in board.legal_moves()[:3]:
        after, ref_after = board.copy(), ref.copy()
        after.push_uci(m)
        ref_after.push_uci(m)
        assert after.halfmove_clock() == ref_after.halfmove_clock()
        assert after.fullmove_number() == ref_after.fullmove_number()


# -- parameters ----------------------------------------------------------------


@pytest.mark.parametrize("cfg", [TINY, az.AzConfig(),
                                 az.AzConfig(channels=32, blocks=3,
                                             value_hidden=64)])
def test_init_shapes_equal_jax_and_config_round_trips(cfg):
    jcfg = jax_az.AzConfig(channels=cfg.channels, blocks=cfg.blocks,
                           value_hidden=cfg.value_hidden)
    ref = jax.eval_shape(lambda: jax_az.init_az_params(jax.random.PRNGKey(0), jcfg))
    params = az.init_az_params(7, cfg)
    assert {k: v.shape for k, v in params.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == np.float32 for v in params.values())
    # Biases and the value head's last layer start at zero, kernels are
    # He-scaled, as in the reference.
    assert not params["stem_b"].any() and not params["value_fc2_w"].any()
    std = params["res0_w1"].std() if cfg.blocks else params["stem_w"].std()
    assert abs(std / np.sqrt(2.0 / (9 * cfg.channels)) - 1) < 0.1
    assert az.az_config_from_params(params) == cfg
    assert jax_az.az_config_from_params(params) == jcfg
    # A seed is a seed: the same draw twice, another draw for another seed.
    again = az.init_az_params(7, cfg)
    assert all(np.array_equal(params[k], again[k]) for k in params)
    assert not np.array_equal(params["stem_w"], az.init_az_params(8, cfg)["stem_w"])


def _broken(kind):
    params = az.init_az_params(0, TINY)
    if kind == "missing":
        del params["policy_b"]
    elif kind == "shape":
        params["res1_w2"] = np.zeros((3, 3, 16, 8), np.float32)
    elif kind == "extra":
        params["extra"] = np.zeros(3, np.float32)
    elif kind == "gap":
        del params["res0_w1"]
    return params


@pytest.mark.parametrize("kind", ["missing", "shape", "extra", "gap"])
def test_config_from_bad_params_raises_like_jax(kind):
    params = _broken(kind)
    with pytest.raises(ValueError):
        jax_az.az_config_from_params(params)
    with pytest.raises(ValueError):
        az.az_config_from_params(params)
    with pytest.raises(ValueError):
        az.params_from_jax(params)


def test_weight_carry_puts_hwio_kernels_in_oihw(tmp_path):
    params = trained_like(TINY, 3)
    path = tmp_path / "net.npz"
    np.savez(path, **params)
    for net in (az.params_from_jax(params), az.params_from_jax(str(path))):
        assert net.cfg == TINY
        w = net.stem_w.detach().numpy()
        assert w.shape == (16, 19, 3, 3)
        # out c, in i, row h, column w <- HWIO [h, w, i, c]
        assert w[5, 7, 2, 1] == params["stem_w"][2, 1, 7, 5]
        np.testing.assert_array_equal(
            net.policy_w.detach().numpy()[:, :, 0, 0], params["policy_w"][0, 0].T)
        np.testing.assert_array_equal(net.value_fc1_w.detach().numpy(),
                                      params["value_fc1_w"])
        np.testing.assert_array_equal(net.res1_b2.detach().numpy(), params["res1_b2"])


def test_value_to_centipawns_equals_jax():
    for v in np.linspace(-1.2, 1.2, 97):
        assert az.value_to_centipawns(float(v)) == jax_az.value_to_centipawns(float(v))
    assert az.value_to_centipawns(0.0) == 0


# -- the cache key's fingerprint (ROADMAP C4) -----------------------------------


@pytest.mark.parametrize("cfg", [TINY, az.AzConfig()])
def test_fingerprint_equals_jax_on_the_same_npz(cfg, tmp_path):
    path = tmp_path / "net.npz"
    np.savez(path, **trained_like(cfg, 5))
    port_params = az.load_az_params(str(path))
    with np.load(path) as data:
        jax_params = {k: jnp.asarray(data[k]) for k in data.files}
    fp = eval_cache.az_net_fingerprint(port_params)
    assert fp == jax_cache.az_net_fingerprint(jax_params)
    assert fp == jax_cache.az_net_fingerprint(port_params)
    # The key is the sorted dict, not its insertion order.
    reordered = dict(reversed(list(port_params.items())))
    assert eval_cache.az_net_fingerprint(reordered) == fp
    other = dict(port_params, stem_b=port_params["stem_b"] + 1)
    assert eval_cache.az_net_fingerprint(other) != fp
    for zob, clock in ((0x1234ABCD, 7), (0xFFFFFFFFFFFFFFFF, 300), (0, 0)):
        assert (eval_cache.az_position_key(zob, clock)
                == jax_cache.az_position_key(zob, clock))


# -- the forward ---------------------------------------------------------------


@pytest.mark.parametrize("cfg,jcfg", [(TINY, JAX_TINY),
                                      (az.AzConfig(), jax_az.AzConfig())],
                         ids=["tiny", "default"])
def test_forward_equals_jax_within_tolerance(cfg, jcfg, tmp_path):
    path = tmp_path / "net.npz"
    np.savez(path, **trained_like(cfg, 9))
    params = az.load_az_params(str(path))
    rng = np.random.default_rng(11)
    planes = wire_planes(rng, 48)
    ref_logits, ref_values = jax_wire_forward(params, planes, jcfg)
    net = az.params_from_jax(str(path))
    logits, values = az.wire_forward(net, torch.from_numpy(planes))
    assert logits.dtype == torch.float16 and values.dtype == torch.float32
    assert tuple(logits.shape) == (48, az_encoding.POLICY_SIZE)
    logits = logits.float().numpy()
    values = values.numpy()
    ref_logits = ref_logits.astype(np.float32)
    scale = max(1.0, float(np.abs(ref_logits).max()))
    assert np.abs(logits - ref_logits).max() <= TOLERANCE * scale
    assert np.abs(values - ref_values).max() <= TOLERANCE
    assert np.abs(values).max() > 0.05  # the value head is live
    # Most logits are the same bits: the ops and their roundings agree.
    assert (logits == ref_logits).mean() > 0.5
    # az_forward on float planes is the same tower.
    x = planes.astype(np.float32)
    x[..., 17] *= np.float32(1.0 / 100.0)
    f_logits, f_values = az.az_forward(net, torch.from_numpy(x))
    np.testing.assert_array_equal(f_logits.half().float().numpy(), logits)
    np.testing.assert_array_equal(f_values.numpy(), values)
