"""The port's NNUE evaluator (fishnet_tpu_torch.nnue.torch_eval) against
the JAX package's (fishnet_tpu.nnue.jax_eval) and the C++ scalar oracle,
bit for bit, on the same NnueWeights.random(seed) net."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fishnet_tpu.nnue import jax_eval
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue import torch_eval
from fishnet_tpu_torch.nnue.weights import NnueWeights


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's small CPU gathers gain
    nothing from more, and under the parallel tier-1 run torch's default
    pool starves other test processes' wall-clock budgets (ROADMAP C8,
    C10)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CPU = torch.device("cpu")


def _pers_code(aid, is_delta, swap=0):
    return -(2 + ((aid << 2) | (2 if is_delta else 0) | swap))


@pytest.fixture(scope="module")
def nets():
    """The same seed through both packages' NnueWeights.random."""
    w = NnueWeights.random(seed=5)
    jw = JaxWeights.random(seed=5)
    return w, jw, torch_eval.params_from_weights(w, CPU), \
        jax_eval.params_from_weights(jw)


def test_random_weights_draw_the_same_net(nets):
    w, jw, _, _ = nets
    for name in ("ft_weight", "ft_bias", "ft_psqt", "l1_weight", "l1_bias",
                 "l2_weight", "l2_bias", "out_weight", "out_bias"):
        assert np.array_equal(getattr(w, name), getattr(jw, name)), name
    assert w.fingerprint() == jw.fingerprint()


def test_weights_save_load_roundtrip_reads_jax_files(nets, tmp_path):
    _, jw, _, _ = nets
    path = tmp_path / "net.nnue"
    jw.save(path)
    loaded = NnueWeights.load(path)
    assert loaded.fingerprint() == jw.fingerprint()


def test_params_from_numpy_carries_jax_params_over(nets):
    _, _, params, jparams = nets
    carried = torch_eval.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU
    )
    assert set(carried) == set(params) == set(jparams)
    for k in params:
        assert carried[k].dtype == params[k].dtype, k
        assert torch.equal(carried[k], params[k]), k


def test_params_from_numpy_pins_tf32_off(nets, monkeypatch):
    """The head's float32 integer products are exact only without TF32;
    building the parameters turns it off, whatever it was before."""
    _, _, params, _ = nets
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    torch_eval.params_from_numpy(
        {k: v.numpy() for k, v in params.items()}, CPU)
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _random_boards(n, seed):
    from fishnet_tpu.chess import Board

    random.seed(seed)
    boards = []
    while len(boards) < n:
        b = Board()
        for _ in range(random.randrange(4, 70)):
            if b.outcome() != 0:
                break
            b.push_uci(random.choice(b.legal_moves()))
        boards.append(b)
    return boards


@pytest.mark.parametrize("host_material", [False, True])
def test_evaluate_batch_matches_jax_and_cpp_oracle(nets, tmp_path,
                                                   host_material):
    from fishnet_tpu.nnue.cpp_oracle import CppNnue

    w, jw, params, jparams = nets
    boards = _random_boards(12, seed=99)
    idx = np.stack([b.nnue_features()[0] for b in boards]).astype(np.int32)
    buckets = np.array([b.nnue_features()[1] for b in boards], np.int32)
    net = tmp_path / "oracle.nnue"
    w.save(net)
    cpp = np.array([CppNnue(net).evaluate(b) for b in boards], np.int32)
    material = None
    if host_material:
        psqt = w.ft_psqt.astype(np.int64)
        acc = np.zeros((len(boards), 2, 8), np.int64)
        for i in range(len(boards)):
            for p in range(2):
                for f in idx[i, p]:
                    if f < spec.NUM_FEATURES:
                        acc[i, p] += psqt[f]
        sel = acc[np.arange(len(boards)), :, buckets]
        d = sel[:, 0] - sel[:, 1]
        material = np.where(d >= 0, d // 2, -((-d) // 2)).astype(np.int32)
    port = torch_eval.evaluate_batch(
        params, torch.from_numpy(idx), torch.from_numpy(buckets),
        material=None if material is None else torch.from_numpy(material),
    ).numpy()
    ref = np.asarray(jax_eval.evaluate_batch(
        jparams, jnp.asarray(idx), jnp.asarray(buckets),
        material=None if material is None else jnp.asarray(material),
    ))
    assert port.dtype == np.int32
    assert np.array_equal(port, ref)
    assert np.array_equal(port, cpp)


def test_evaluate_batch_with_in_batch_deltas_matches_jax(nets):
    _, _, params, jparams = nets
    rng = np.random.default_rng(8)
    B = 12
    idx = np.full((B, 2, 32), spec.NUM_FEATURES, np.int32)
    parent = np.full((B,), -1, np.int32)
    for s in range(0, B, 4):
        idx[s, :, :28] = rng.integers(0, spec.NUM_FEATURES, (2, 28))
        for e in range(s + 1, s + 4):
            parent[e] = (s << 1) | int(rng.integers(0, 2))
            idx[e, :, :2] = rng.integers(0, spec.NUM_FEATURES, (2, 2))
            idx[e, :, 4:6] = spec.DELTA_BASE + rng.integers(
                0, spec.NUM_FEATURES, (2, 2))
            idx[e, :, 6:8] = spec.DELTA_BASE + spec.NUM_FEATURES
    buckets = rng.integers(0, 8, (B,)).astype(np.int32)
    port = torch_eval.evaluate_batch(
        params, torch.from_numpy(idx), torch.from_numpy(buckets),
        torch.from_numpy(parent),
    ).numpy()
    ref = np.asarray(jax_eval.evaluate_batch(
        jparams, jnp.asarray(idx), jnp.asarray(buckets), jnp.asarray(parent)
    ))
    assert np.array_equal(port, ref)
    # Persistent codes without material or tables raise (JAX raises on
    # concrete codes too; its traced poison has no eager counterpart).
    parent[4] = _pers_code(1, True)
    with pytest.raises(ValueError, match="persistent anchor codes"):
        torch_eval.evaluate_batch(
            params, torch.from_numpy(idx), torch.from_numpy(buckets),
            torch.from_numpy(parent),
        )


def _wire_batch(rng, B=10, A=4):
    """A packed wire batch with every entry kind and padding; the rows
    between the sentinel block and the tier end are deliberately out of
    table bounds (stale buffer rows), to prove the n_rows clamp."""
    tier = 4 * B + 4
    packed = np.full((tier, 2, 8), spec.NUM_FEATURES, np.uint16)
    parent = np.full((B,), -1, np.int32)
    kinds = [("store_full", 0), ("inbatch", 0), ("inbatch", 0),
             ("pers", 3), ("inbatch", 3), ("full", 0), ("inbatch", 5),
             ("pers_swap", 2)]
    rows = 0
    for e, (kind, a) in enumerate(kinds):
        if kind in ("store_full", "full"):
            packed[rows: rows + 4, :, :7] = rng.integers(
                0, spec.NUM_FEATURES, (4, 2, 7))
            parent[e] = _pers_code(a, False) if kind == "store_full" else -1
            rows += 4
        else:
            packed[rows, :, :2] = rng.integers(0, spec.NUM_FEATURES, (2, 2))
            packed[rows, :, 4:6] = spec.DELTA_BASE + rng.integers(
                0, spec.NUM_FEATURES, (2, 2))
            packed[rows, :, 6:8] = spec.DELTA_BASE + spec.NUM_FEATURES
            if kind == "inbatch":
                parent[e] = (a << 1) | int(rng.integers(0, 2))
            else:
                parent[e] = _pers_code(a, True, swap=int(kind == "pers_swap"))
            rows += 1
    packed[rows + 4:] = 60000  # stale rows past the sentinel block
    buckets = rng.integers(0, 8, (B,)).astype(np.int32)
    tab = rng.integers(-3000, 3000, (A, 2, spec.L1)).astype(np.int32)
    ptab = rng.integers(-2000, 2000, (A, 2, 8)).astype(np.int32)
    material = rng.integers(-400, 400, (B,)).astype(np.int32)
    return packed, buckets, parent, rows, tab, ptab, material


@pytest.mark.parametrize("host_material", [False, True])
def test_evaluate_packed_anchored_matches_jax(nets, host_material):
    _, _, params, jparams = nets
    rng = np.random.default_rng(6)
    packed, buckets, parent, rows, tab, ptab, material = _wire_batch(rng)
    mat = material if host_material else None
    jv, jtab, jptab = jax_eval.evaluate_packed_anchored(
        jparams, jnp.asarray(packed), jnp.asarray(buckets),
        jnp.asarray(parent), None if mat is None else jnp.asarray(mat),
        jnp.asarray(tab), jnp.asarray(np.array([rows], np.int32)),
        jnp.asarray(ptab),
    )
    ttab, tptab = torch.from_numpy(tab.copy()), torch.from_numpy(ptab.copy())
    pv, ptab_out, pptab_out = torch_eval.evaluate_packed_anchored(
        params, torch.from_numpy(packed.view(np.int16)),
        torch.from_numpy(buckets), torch.from_numpy(parent),
        None if mat is None else torch.from_numpy(mat), ttab, rows, tptab,
    )
    # The tables are updated in place and handed back.
    assert ptab_out is ttab and pptab_out is tptab
    assert np.array_equal(pv.numpy(), np.asarray(jv))
    assert np.array_equal(ttab.numpy(), np.asarray(jtab))
    assert np.array_equal(tptab.numpy(), np.asarray(jptab))
    # Stores happened (rows 0, 2 and 3) and the rest stayed.
    assert not np.array_equal(ttab.numpy()[0], tab[0])
    assert np.array_equal(ttab.numpy()[1], tab[1])


def test_expand_packed_matches_jax_and_numpy_twin():
    rng = np.random.default_rng(9)
    packed, _, parent, rows, _, _, _ = _wire_batch(rng)
    offsets = torch_eval.derive_offsets_np(parent, rows)
    port = torch_eval.expand_packed(
        torch.from_numpy(packed.view(np.int16)), torch.from_numpy(offsets),
        torch.from_numpy(parent),
    ).numpy()
    ref = np.asarray(jax_eval.expand_packed(
        jnp.asarray(packed), jnp.asarray(offsets), jnp.asarray(parent)
    ))
    assert np.array_equal(port, ref)
    assert np.array_equal(
        port, torch_eval.expand_packed_np(packed, offsets, parent)
    )


def test_numpy_twins_match_jax():
    codes = np.array([-1, 0, 3, -2, -4, -5, -(2 + (5 << 2) + 3), 7], np.int32)
    assert np.array_equal(torch_eval.is_delta_np(codes),
                          jax_eval.is_delta_np(codes))
    assert np.array_equal(torch_eval.anchor_ids_np(codes),
                          jax_eval.anchor_ids_np(codes))
    for n_rows in (3, 100):
        assert np.array_equal(torch_eval.derive_offsets_np(codes, n_rows),
                              jax_eval.derive_offsets_np(codes, n_rows))


def test_trunc_div_truncates_toward_zero():
    a = torch.tensor([-7, -1, 0, 1, 7], dtype=torch.int32)
    got = torch_eval._trunc_div(a, 2)
    assert got.tolist() == [-3, 0, 0, 0, 3]
    assert got.dtype == torch.int32


@pytest.mark.parametrize("host_material", [False, True])
def test_evaluate_packed_anchored_with_given_offsets_matches_jax(
        nets, host_material):
    """The serving call: the pool's row offsets passed in (padding at the
    sentinel block) instead of derived; same values and tables as the
    JAX package, which derives them."""
    _, _, params, jparams = nets
    rng = np.random.default_rng(16)
    packed, buckets, parent, rows, tab, ptab, material = _wire_batch(rng)
    mat = material if host_material else None
    jv, jtab, jptab = jax_eval.evaluate_packed_anchored(
        jparams, jnp.asarray(packed), jnp.asarray(buckets),
        jnp.asarray(parent), None if mat is None else jnp.asarray(mat),
        jnp.asarray(tab), jnp.asarray(np.array([rows], np.int32)),
        jnp.asarray(ptab),
    )
    offsets = jax_eval.derive_offsets_np(parent, rows)
    ttab, tptab = torch.from_numpy(tab.copy()), torch.from_numpy(ptab.copy())
    pv, _, _ = torch_eval.evaluate_packed_anchored(
        params, torch.from_numpy(packed.view(np.int16)),
        torch.from_numpy(buckets), torch.from_numpy(parent),
        None if mat is None else torch.from_numpy(mat), ttab, rows, tptab,
        offsets=torch.from_numpy(offsets),
    )
    assert np.array_equal(pv.numpy(), np.asarray(jv))
    assert np.array_equal(ttab.numpy(), np.asarray(jtab))
    assert np.array_equal(tptab.numpy(), np.asarray(jptab))
