"""The port's AZ trainer (fishnet_tpu_torch.train.AzTrainer, on
``models/az.py:train_forward``) against the JAX package's, on the CPU.

Both compute the tower in bfloat16 with float32 master parameters, and
round the same ops, but sum a conv's products in other orders, so they
agree within bf16 rounding, not bit for bit. Tolerances:

* the loss of one forward: within 2**-8 of its magnitude (one bf16
  step);
* 10 AdamW steps: every loss within 2**-7 of its magnitude;
* the first step's gradients, in norm: conv and fc weights within 2%;
  biases within 25%. A bias gradient sums the bf16 cotangent over the
  batch and the 64 squares; XLA on the CPU accumulates that sum in
  bf16, which moves the policy bias's gradient by ~11% of its norm
  against the exact sum, while the port's stays within 1% of it (the
  last test checks the port's against the exact float64 sum).

The export writes the JAX-layout ``.npz``: both packages load it, with
equal fingerprints, and the reloaded net equals the trained one bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.models import az as jax_az
from fishnet_tpu.search import eval_cache as jax_cache
from fishnet_tpu.train import AzTrainer as JaxAzTrainer
from fishnet_tpu_torch.models.az import (
    AzConfig,
    az_config_from_params,
    az_forward,
    jax_layout,
    load_az_params,
    params_from_jax,
    train_forward,
)
from fishnet_tpu_torch.models.az_encoding import INPUT_PLANES, POLICY_SIZE
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.train import AzTrainer

TINY = AzConfig(channels=16, blocks=2, value_hidden=16)
JAX_TINY = jax_az.AzConfig(channels=16, blocks=2, value_hidden=16)
MATE_FEN = "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1"


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


def make_batch(rng, batch):
    """The JAX tests' seeded batch (tests/test_az_trainer.py), numpy."""
    planes = rng.normal(0, 1, (batch, 8, 8, INPUT_PLANES)).astype(np.float32)
    pol = np.zeros((batch, POLICY_SIZE), np.float32)
    for b in range(batch):
        idx = rng.choice(POLICY_SIZE, size=8, replace=False)
        w = rng.random(8).astype(np.float32)
        pol[b, idx] = w / w.sum()
    values = rng.uniform(-1, 1, batch).astype(np.float32)
    return {"planes": planes, "policy_target": pol, "value_target": values}


def live_params(seed):
    """The JAX trainer's init with every zero leaf given small seeded
    values (zero biases and a zero fc2 would hide the bias rounding and
    the value path), as a JAX-layout dict of numpy arrays."""
    params = {k: np.array(v) for k, v in
              JaxAzTrainer(cfg=JAX_TINY).init(seed=seed).params.items()}
    rng = np.random.default_rng(seed)
    for k, v in params.items():
        if not v.any():
            params[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
    return params


def rel_norm(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_first_gradients_within_bf16_tolerance(seed):
    params = live_params(seed)
    batch = make_batch(np.random.default_rng(seed), 16)
    jt = JaxAzTrainer(cfg=JAX_TINY)
    grads_j, mj = jax.grad(jt._loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    pt = AzTrainer(cfg=TINY, device="cpu")
    state = pt.init(params=params)
    loss, mp = pt.loss(state.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for key in ("loss", "policy_loss", "value_loss"):
        want = float(mj[key])
        assert abs(mp[key].item() - want) <= 2.0 ** -8 * max(1.0, abs(want)), key
    for k, p in state.params.named_parameters():
        grad = p.grad.numpy()
        if grad.ndim == 4:
            grad = grad.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        bound = 0.02 if k.rsplit("_", 1)[1].startswith("w") else 0.25
        assert rel_norm(grad, np.asarray(grads_j[k])) <= bound, k


def test_ten_step_losses_within_bf16_tolerance():
    params = {k: np.array(v) for k, v in
              JaxAzTrainer(cfg=JAX_TINY).init(seed=0).params.items()}
    batch = make_batch(np.random.default_rng(0), 8)
    jt = JaxAzTrainer(cfg=JAX_TINY, learning_rate=3e-3)
    js = jt.init(seed=0)
    pt = AzTrainer(cfg=TINY, learning_rate=3e-3, device="cpu")
    ps = pt.init(params=params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for i in range(10):
        js, mj = jt.step(js, jb)
        ps, mp = pt.step(ps, batch)
        want = float(mj["loss"])
        assert abs(mp["loss"] - want) <= 2.0 ** -7 * max(1.0, abs(want)), (i, mp, mj)
        losses.append(mp["loss"])
    assert ps.step == 10 and losses[-1] < losses[0]


def test_train_forward_equals_the_serving_forward():
    net = params_from_jax(live_params(3))
    x = torch.from_numpy(make_batch(np.random.default_rng(3), 8)["planes"])
    with torch.no_grad():
        got = train_forward(net, x)
    want = az_forward(net, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bias_gradient_is_the_exact_sum_of_its_bf16_cotangent():
    pt = AzTrainer(cfg=TINY, device="cpu")
    state = pt.init(params=live_params(1))
    batch = make_batch(np.random.default_rng(1), 16)
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = train_forward(state.params, data["planes"])
    loss, _ = pt.loss(state.params, data)
    loss.backward()
    # d loss / d logits, rounded to bf16 as the tower's output is, then
    # summed exactly over the batch and the squares.
    g = (torch.softmax(logits.detach().double(), -1)
         - data["policy_target"].double()) / 16
    exact = g.to(torch.bfloat16).double().reshape(16, 64, 73).sum((0, 1))
    got = state.params.policy_b.grad.double()
    assert rel_norm(got.numpy(), exact.numpy()) <= 0.01


def test_training_overfits_small_batch():
    trainer = AzTrainer(cfg=TINY, learning_rate=3e-3, device="cpu")
    state = trainer.init(seed=0)
    batch = make_batch(np.random.default_rng(0), 8)
    losses = []
    for _ in range(30):
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"])
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, losses[::10]
    assert state.step == 30


def test_export_loads_in_both_packages_with_equal_fingerprints(tmp_path):
    trainer = AzTrainer(cfg=TINY, device="cpu")
    state = trainer.init(params=live_params(2))
    state, _ = trainer.step(state, make_batch(np.random.default_rng(2), 8))
    path = tmp_path / "az.npz"
    trainer.export(state, str(path))
    port = load_az_params(str(path))
    with np.load(path) as data:
        jax_params = {k: jnp.asarray(data[k]) for k in data.files}
    assert set(port) == set(jax_params)
    assert jax_az.az_config_from_params(jax_params) == JAX_TINY
    assert az_config_from_params(port) == TINY
    assert eval_cache.az_net_fingerprint(port) == jax_cache.az_net_fingerprint(
        {k: np.asarray(v) for k, v in jax_params.items()})
    # HWIO on disk: the stem kernel is [3, 3, 19, C].
    assert port["stem_w"].shape == (3, 3, INPUT_PLANES, TINY.channels)
    # The reloaded net is the trained net, bit for bit.
    x = torch.from_numpy(make_batch(np.random.default_rng(4), 8)["planes"])
    got = az_forward(params_from_jax(port), x)
    want = az_forward(state.params, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_exported_net_drives_the_mcts_pool(tmp_path):
    """The export drives the port's MctsPool (the JAX test's mate-in-one
    after training it zero steps)."""
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    trainer = AzTrainer(cfg=TINY, device="cpu")
    state = trainer.init(seed=2)
    path = tmp_path / "az.npz"
    trainer.export(state, str(path))
    pool = MctsPool(load_az_params(str(path)),
                    MctsConfig(batch_capacity=64, az=TINY), device="cpu")
    try:
        sid = pool.submit(MATE_FEN, [], visits=200)
        for _ in range(5000):
            pool.step()
            if pool.active() == 0:
                break
        assert pool.harvest(sid).best_move == "d1d8"
    finally:
        pool.close()


def test_config_recovered_from_export_shapes(tmp_path):
    cfg = AzConfig(channels=24, blocks=3, value_hidden=20)
    trainer = AzTrainer(cfg=cfg, device="cpu")
    path = tmp_path / "az24.npz"
    trainer.export(trainer.init(seed=3), str(path))
    assert az_config_from_params(load_az_params(str(path))) == cfg
    with pytest.raises(ValueError, match="params are a"):
        AzTrainer(cfg=TINY, device="cpu").init(params=load_az_params(str(path)))
