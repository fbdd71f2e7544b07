"""The port's NNUE training (fishnet_tpu_torch.train: model, Trainer)
against the JAX package's (fishnet_tpu.train), on the CPU.

Both packages start from the same parameters (the JAX trainer's init,
carried through ``params_from_jax``) and take the same seeded batches.
Tolerances, from the JAX package's own sharded-vs-single bound
(``tests/test_train.py``: rtol 2e-4, atol 2e-6):

* the forward and every gradient: rtol 2e-4, atol 2e-6 — the port sums
  a row's products in ``embedding_bag``'s order, XLA in its own, so a
  float32 result moves in its last bits;
* one Adam step: Adam's first update is ~lr x sign(g), so an entry whose
  gradient is rounding noise (its sign not the same in both packages)
  moves by up to 2 x lr; such entries must be at most 1% of a
  parameter's (MAX_SIGN_FLIP_SHARE; the test prints the share), the
  rest within rtol 2e-4, atol 2e-6;
* 10 steps: every loss within rtol 1e-4, the centipawn metrics within
  rtol 1e-4, atol 0.002 cp (a mean near zero), the parameters within
  rtol 2e-4, atol 2e-5;
* ``clip_params`` and ``quantize``: exact (byte for byte).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.train import NetConfig as JaxNetConfig
from fishnet_tpu.train import Trainer as JaxTrainer
from fishnet_tpu.train import model as jax_model
from fishnet_tpu_torch.nnue.torch_eval import evaluate_batch, params_from_weights
from fishnet_tpu_torch.train import NetConfig, Trainer, clip_params, forward, init_params, quantize
from fishnet_tpu_torch.train import model

TINY = NetConfig(num_features=256, max_active=8, l1=32, l2=15, l3=32)
JAX_TINY = JaxNetConfig(num_features=256, max_active=8, l1=32, l2=15, l3=32)
RTOL, ATOL = 2e-4, 2e-6
MAX_SIGN_FLIP_SHARE = 0.01


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread, as every port test holds (ROADMAP C8,
    C10)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fake_batch(rng, n, cfg):
    """The JAX tests' seeded batch, as numpy arrays."""
    indices = np.full((n, 2, cfg.max_active), cfg.num_features, dtype=np.int32)
    for b in range(n):
        k = int(rng.integers(2, cfg.max_active + 1))
        for p in range(2):
            indices[b, p, :k] = np.sort(rng.choice(cfg.num_features, k, replace=False))
    return {
        "indices": indices,
        "buckets": rng.integers(0, 8, n, dtype=np.int32),
        "score_cp": rng.normal(0, 150, n).astype(np.float32),
        "outcome": rng.choice([0.0, 0.5, 1.0], n).astype(np.float32),
    }


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def both_trainers(seed, lr=1e-3):
    """The JAX trainer's init and the port's trainer started from the
    same parameters."""
    jt = JaxTrainer(cfg=JAX_TINY, learning_rate=lr)
    js = jt.init(seed=seed)
    params = {k: np.asarray(v) for k, v in js.params.items()}
    pt = Trainer(cfg=TINY, learning_rate=lr, device="cpu")
    return jt, js, pt, pt.init(params=params), params


def assert_close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def test_init_draw_shapes_equal_jax_and_carry_round_trips():
    params = init_params(3, TINY)
    ref = jax_model.init_params(jax.random.PRNGKey(0), JAX_TINY)
    assert list(params) == list(ref)
    for k in ref:
        assert params[k].shape == ref[k].shape and params[k].dtype == np.float32, k
    assert np.array_equal(params["ft_b"], np.asarray(ref["ft_b"]))
    # The bounds of the uniform draws.
    assert np.abs(params["ft_w"]).max() <= 0.05
    assert np.abs(params["l1_w"]).max() <= np.sqrt(1.0 / TINY.l1)
    assert not np.array_equal(params["ft_w"], init_params(4, TINY)["ft_w"])
    net = model.params_from_jax(params, TINY)
    back = model.params_to_jax(net)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="shape"):
        model.params_from_jax(params, NetConfig(num_features=128, max_active=8,
                                                l1=32, l2=15, l3=32))


def test_forward_shapes_and_padding():
    net = model.params_from_jax(init_params(0, TINY), TINY)
    batch = fake_batch(np.random.default_rng(0), 4, TINY)
    idx = torch.from_numpy(batch["indices"])
    out = forward(net, idx, torch.from_numpy(batch["buckets"]), TINY)
    assert out.shape == (4,) and bool(torch.isfinite(out).all())
    # Any padding value >= num_features is a no-op.
    idx2 = torch.where(idx >= TINY.num_features, idx + 1000, idx)
    out2 = forward(net, idx2, torch.from_numpy(batch["buckets"]), TINY)
    assert torch.equal(out, out2)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_and_gradients_equal_jax(seed):
    jt, js, pt, ps, params = both_trainers(seed)
    batch = fake_batch(np.random.default_rng(10 + seed), 64, TINY)
    ref = np.asarray(jax_model.forward(js.params, jnp.asarray(batch["indices"]),
                                       jnp.asarray(batch["buckets"]), JAX_TINY))
    got = forward(ps.params, torch.from_numpy(batch["indices"]),
                  torch.from_numpy(batch["buckets"]), TINY).detach().numpy()
    assert_close(got, ref, RTOL, ATOL, "forward")

    (loss_j, _), grads_j = jax.value_and_grad(jt._loss, has_aux=True)(
        js.params, jax_batch(batch))
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_p, _ = pt.loss(ps.params, data)
    loss_p.backward()
    assert_close(loss_p.item(), float(loss_j), RTOL, 0, "loss")
    for k in params:
        assert_close(ps.params[k].grad.numpy(), np.asarray(grads_j[k]), RTOL, ATOL, k)


def test_first_adam_step_equals_jax_but_for_sign_flips():
    jt, js, pt, ps, params = both_trainers(2, lr=1e-3)
    batch = fake_batch(np.random.default_rng(12), 64, TINY)
    _, grads_j = jax.value_and_grad(jt._loss, has_aux=True)(js.params, jax_batch(batch))
    js, _ = jt.step(js, jax_batch(batch))
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    ps, _ = pt.step(ps, data)
    shares = {}
    for k in params:
        gj = np.asarray(grads_j[k])
        gp = ps.params[k].grad.numpy()
        flip = np.sign(gj) != np.sign(gp)
        shares[k] = float(flip.mean())
        got, want = ps.params[k].detach().numpy(), np.asarray(js.params[k])
        assert np.abs(got - want)[flip].max(initial=0.0) <= 2 * 1e-3 * (1 + 1e-5), k
        assert_close(got[~flip], want[~flip], RTOL, ATOL, k)
    print("sign-flipped gradient entries, share by parameter:", shares)
    assert max(shares.values()) <= MAX_SIGN_FLIP_SHARE, shares


def test_ten_step_losses_and_params_equal_jax():
    jt, js, pt, ps, params = both_trainers(0, lr=5e-3)
    batch = fake_batch(np.random.default_rng(1), 128, TINY)
    jb = jax_batch(batch)
    for i in range(10):
        js, mj = jt.step(js, jb)
        ps, mp = pt.step(ps, batch)
        assert_close(mp["loss"], float(mj["loss"]), 1e-4, 0, f"step {i} loss")
        for key in ("pred_cp_mean", "pred_cp_abs"):  # centipawns
            assert_close(mp[key], float(mj[key]), 1e-4, 2e-3, f"step {i} {key}")
    assert ps.step == int(js.step) == 10
    for k in params:
        assert_close(ps.params[k].detach().numpy(), np.asarray(js.params[k]),
                     RTOL, 2e-5, k)


def test_train_step_reduces_loss():
    trainer = Trainer(cfg=TINY, learning_rate=5e-3, device="cpu")
    state = trainer.init(seed=0)
    batch = fake_batch(np.random.default_rng(1), 128, TINY)
    losses = []
    for _ in range(30):
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"])
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]
    assert state.step == 30


def test_clip_params_equals_jax():
    rng = np.random.default_rng(5)
    params = {k: (v + rng.normal(0, 3, v.shape)).astype(np.float32)
              for k, v in init_params(5, TINY).items()}
    net = model.params_from_jax(params, TINY)
    clip_params(net)
    ref = jax_model.clip_params({k: jnp.asarray(v) for k, v in params.items()})
    for k in params:
        assert np.array_equal(net[k].detach().numpy(), np.asarray(ref[k])), k
    assert np.abs(net["l1_w"].detach().numpy()).max() == np.float32(model.HIDDEN_WEIGHT_CLIP)
    assert np.abs(net["out_w"].detach().numpy()).max() == np.float32(model.OUT_WEIGHT_CLIP)


def full_spec_params(seed):
    """Full-spec parameters with every quantizer exercised: the draw plus
    seeded PSQT rows, biases and a few weights past the integer ranges."""
    rng = np.random.default_rng(seed)
    params = init_params(seed, NetConfig())
    params["ft_psqt"] = (rng.standard_normal(params["ft_psqt"].shape) * 0.02).astype(np.float32)
    for k in ("l1_b", "l2_b", "out_b"):
        params[k] = (rng.standard_normal(params[k].shape) * 0.1).astype(np.float32)
    params["l1_w"][0, 0, :4] = [3.0, -3.0, 0.5 / 64, -1.5 / 64]  # clip, ties
    params["ft_w"][7, :2] = [400.0, -400.0]
    return params


def test_quantize_is_byte_identical_to_jax(tmp_path):
    params = full_spec_params(6)
    got = quantize(model.params_from_jax(params), NetConfig())
    want = jax_model.quantize(params, JaxNetConfig())
    got.save(str(tmp_path / "port.nnue"))
    want.save(str(tmp_path / "jax.nnue"))
    assert (tmp_path / "port.nnue").read_bytes() == (tmp_path / "jax.nnue").read_bytes()
    assert quantize(params).fingerprint() == got.fingerprint()  # numpy in, too
    assert JaxWeights.load(str(tmp_path / "port.nnue")).fingerprint() == want.fingerprint()
    with pytest.raises(ValueError, match="full-spec"):
        quantize(init_params(0, TINY), TINY)


def test_quantized_eval_tracks_the_float_forward():
    """The JAX package's statistical bound (tests/test_train.py, full
    spec, untrained weights): slope 0.8-1.25, correlation > 0.95, mean
    error <= 60 cp, of the port's integer eval (the plain version of the
    FT gather) against its float forward x 600."""
    cfg = NetConfig()
    params = init_params(4, cfg)
    params["ft_psqt"] = (np.random.default_rng(5).standard_normal(
        params["ft_psqt"].shape) * 0.02).astype(np.float32)
    net = model.params_from_jax(params, cfg)
    qparams = params_from_weights(quantize(net, cfg), "cpu")
    rng = np.random.default_rng(5)
    n = 32
    indices = np.full((n, 2, cfg.max_active), cfg.num_features, dtype=np.int32)
    for b in range(n):
        k = int(rng.integers(8, cfg.max_active + 1))
        for p in range(2):
            indices[b, p, :k] = np.sort(rng.choice(cfg.num_features, k, replace=False))
    buckets = rng.integers(0, 8, n, dtype=np.int32)
    idx, bk = torch.from_numpy(indices), torch.from_numpy(buckets)
    float_cp = forward(net, idx, bk, cfg).detach().numpy() * model.NNUE2SCORE
    int_cp = evaluate_batch(qparams, idx, bk).numpy()
    err = np.abs(float_cp - int_cp)
    corr = np.corrcoef(float_cp, int_cp)[0, 1]
    slope = float(np.polyfit(float_cp, int_cp, 1)[0])
    assert 0.8 <= slope <= 1.25, slope
    assert corr > 0.95, (corr, float_cp[:5], int_cp[:5])
    assert float(err.mean()) <= 60.0, err.mean()


def test_export_quantizes_the_trained_state():
    trainer = Trainer(device="cpu")
    state = trainer.init(params=full_spec_params(7))
    assert trainer.export(state).fingerprint() == jax_model.quantize(
        full_spec_params(7), JaxNetConfig()).fingerprint()


def test_trainers_raise_without_a_gpu(monkeypatch):
    from fishnet_tpu_torch.train import AzTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg=TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AzTrainer()
