"""The port's training checkpoints (fishnet_tpu_torch.train.checkpoint) on
the CPU: a restored run continues bit for bit, for both trainers — the
port's version of tests/test_checkpoint.py without its sharded mesh
(the mesh slice). The format is the port's own ``torch.save`` file; an
orbax checkpoint of the JAX package does not load (the exported nets
are the cross-package format)."""

import numpy as np
import pytest
import torch

from fishnet_tpu_torch.models.az import AzConfig, jax_layout
from fishnet_tpu_torch.train import AzTrainer, NetConfig, Trainer
from fishnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from fishnet_tpu_torch.train.model import params_to_jax

TINY_NNUE = NetConfig(num_features=512, max_active=8, l1=64, l2=15, l3=32)
TINY_AZ = AzConfig(channels=16, blocks=2, value_hidden=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nnue_batch(rng, cfg, batch):
    indices = np.full((batch, 2, cfg.max_active), cfg.num_features, np.int32)
    for b in range(batch):
        for p in range(2):
            indices[b, p, :4] = rng.choice(cfg.num_features, 4, replace=False)
    return {
        "indices": indices,
        "buckets": rng.integers(0, 8, batch).astype(np.int32),
        "score_cp": rng.normal(0, 100, batch).astype(np.float32),
        "outcome": rng.choice([0.0, 0.5, 1.0], batch).astype(np.float32),
    }


def az_batch(rng, batch):
    planes = rng.integers(0, 2, (batch, 8, 8, 19)).astype(np.float32)
    pol = np.zeros((batch, 4672), np.float32)
    for b in range(batch):
        idx = rng.choice(4672, size=8, replace=False)
        pol[b, idx] = 1.0 / 8
    return {"planes": planes, "policy_target": pol,
            "value_target": rng.uniform(-1, 1, batch).astype(np.float32)}


def _trainer(kind):
    if kind == "nnue":
        return (Trainer(cfg=TINY_NNUE, device="cpu"),
                nnue_batch(np.random.default_rng(0), TINY_NNUE, 8), params_to_jax)
    return (AzTrainer(cfg=TINY_AZ, device="cpu"),
            az_batch(np.random.default_rng(0), 8), jax_layout)


def _opt_tensors(opt):
    return [(i, k, v) for i, s in opt.state_dict()["state"].items()
            for k, v in sorted(s.items()) if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("kind", ["nnue", "az"])
def test_resume_at_5_equals_uninterrupted_10(tmp_path, kind):
    trainer, batch, carry = _trainer(kind)
    state = trainer.init(seed=0)
    for _ in range(10):
        state, _ = trainer.step(state, batch)
    reference = carry(state.params)
    ref_opt = _opt_tensors(state.opt_state)

    state = trainer.init(seed=0)
    for _ in range(5):
        state, _ = trainer.step(state, batch)
    save_checkpoint(tmp_path / "ckpt.pt", state)
    restored = restore_checkpoint(tmp_path / "ckpt.pt", trainer.init(seed=1))
    assert restored.step == 5
    for _ in range(5):
        restored, _ = trainer.step(restored, batch)
    assert restored.step == 10
    resumed = carry(restored.params)
    for k in reference:
        np.testing.assert_array_equal(reference[k], resumed[k], err_msg=k)
    got_opt = _opt_tensors(restored.opt_state)
    assert len(got_opt) == len(ref_opt) > 0
    for (i, k, a), (j, l, b) in zip(ref_opt, got_opt):
        assert (i, k) == (j, l) and torch.equal(a, b), (i, k)


@pytest.mark.parametrize("kind", ["nnue", "az"])
def test_round_trip_reproduces_every_tensor(tmp_path, kind):
    trainer, batch, carry = _trainer(kind)
    state = trainer.init(seed=2)
    for _ in range(3):
        state, _ = trainer.step(state, batch)
    path = tmp_path / "ckpt.pt"
    save_checkpoint(path, state)
    save_checkpoint(path, state)  # over an existing file
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt.pt"]
    template = trainer.init(seed=3)
    restored = restore_checkpoint(path, template)
    assert restored.params is template.params
    assert restored.opt_state is template.opt_state and restored.step == 3
    for (n, a), (m, b) in zip(state.params.named_parameters(),
                              restored.params.named_parameters()):
        assert n == m and torch.equal(a, b) and b.device == a.device, n
    for (i, k, a), (j, l, b) in zip(_opt_tensors(state.opt_state),
                                    _opt_tensors(restored.opt_state)):
        assert (i, k) == (j, l) and torch.equal(a, b), (i, k)


def test_restore_refuses_what_is_not_its_checkpoint(tmp_path):
    trainer, _batch, _carry = _trainer("nnue")
    bad = tmp_path / "bad.pt"
    torch.save({"params": {}}, bad)
    with pytest.raises(ValueError, match="not a fishnet_tpu_torch"):
        restore_checkpoint(bad, trainer.init(seed=0))
    save_checkpoint(tmp_path / "nnue.pt", trainer.init(seed=0))
    az, _b, _c = _trainer("az")
    with pytest.raises(ValueError, match="differ from the template"):
        restore_checkpoint(tmp_path / "nnue.pt", az.init(seed=0))
    other = Trainer(cfg=NetConfig(num_features=256, max_active=8, l1=64,
                                  l2=15, l3=32), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path / "nnue.pt", other.init(seed=0))
