"""The port's sharded trainers (``Trainer(mesh=)``, ``AzTrainer(mesh=)``
over ``fishnet_tpu_torch.parallel.mesh.Mesh``, ``train/sharding.py``)
and checkpoints across placements, on the CPU.

A mesh of ``[cpu] * n`` runs every shard on the CPU, so each sharded
step is the single-device step split over ``data x model``. Tolerances:

* NNUE, 3 sharded steps against 3 single-device steps (the JAX package's
  own sharded-vs-single bound, ``tests/test_train.py``): loss rtol 1e-4;
  parameters rtol 2e-4, atol 2e-6;
* NNUE, the port's 4x2 step against the JAX 4x2 step on the 8 virtual
  CPU devices of ``tests/conftest.py``: ``tests/test_torch_train.py``'s
  10-step bounds (loss rtol 1e-4; parameters rtol 2e-4, atol 2e-5);
* AZ, one sharded step against the port's single-device step: the AZ
  bounds of ``tests/test_torch_az_trainer.py`` (loss within 2**-8 of its
  magnitude; gradients in norm: weights 2%, biases 25%);
* two sharded runs, exports and checkpoint round trips: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.models import az as jax_az
from fishnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fishnet_tpu.train import NetConfig as JaxNetConfig
from fishnet_tpu.train import Trainer as JaxTrainer
from fishnet_tpu.train import az_trainer as jax_az_trainer
from fishnet_tpu.train import trainer as jax_trainer
from fishnet_tpu_torch.models.az import AzConfig, init_az_params, jax_layout
from fishnet_tpu_torch.parallel.mesh import factor_mesh, make_mesh
from fishnet_tpu_torch.train import (
    AzTrainer,
    NetConfig,
    ShardSpec,
    Trainer,
    az_batch_specs,
    az_param_spec,
    batch_specs,
    init_params,
    param_specs,
)
from fishnet_tpu_torch.train import trainer as trainer_mod
from fishnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from fishnet_tpu_torch.train.model import PARAM_NAMES, params_to_jax

from test_torch_az_trainer import make_batch as az_batch
from test_torch_train import fake_batch

CFG = NetConfig(num_features=256, max_active=8, l1=64, l2=15, l3=32)
JAX_CFG = JaxNetConfig(num_features=256, max_active=8, l1=64, l2=15, l3=32)
RTOL, ATOL = 2e-4, 2e-6
#: (data, model): factor_mesh(8), all data, all model.
SHAPES = [factor_mesh(8), (8, 1), (1, 2)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(data, model):
    return make_mesh(["cpu"] * (data * model), data=data, model=model)


def nnue_params(net):
    return {k: net[k].detach().cpu().numpy() for k in PARAM_NAMES}


def run_nnue(trainer, params, batch, steps=3):
    state = trainer.init(params=params)
    losses = []
    for _ in range(steps):
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"])
    return state, losses


# -- the specs -------------------------------------------------------------


def _jax_entries(spec):
    return tuple(spec)


def test_spec_dicts_equal_the_jax_dicts_key_by_key():
    ours, theirs = param_specs(), jax_trainer.param_specs()
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].partition(3) == _jax_entries(theirs[k]), k
    # ft_w, ft_b and l1_w cut as L1 pairs (module docstring).
    assert {k for k, s in ours.items() if s.paired} == {"ft_w", "ft_b", "l1_w"}
    for ours_b, theirs_b in ((batch_specs(), jax_trainer.batch_specs()),
                             (az_batch_specs(), jax_az_trainer.az_batch_specs())):
        assert list(ours_b) == list(theirs_b)
        for k in theirs_b:
            assert ours_b[k].partition(1) == _jax_entries(theirs_b[k]), k
    # AZ: the port's OIHW dimension 0 is the JAX HWIO dimension 3.
    params = jax_az.init_az_params(jax.random.PRNGKey(0), jax_az.AzConfig())
    for k, v in params.items():
        theirs_k = _jax_entries(jax_az_trainer.az_param_spec(k, v))
        ours_k = az_param_spec(k, v)
        if ours_k.axis is None:
            assert theirs_k == (), k
        else:
            hwio = (3, 2, 0, 1)[ours_k.dim]  # OIHW dim -> HWIO dim
            assert theirs_k == tuple(ours_k.axis if i == hwio else None
                                     for i in range(hwio + 1)), k
    assert ShardSpec().partition(2) == ()


# -- NNUE ------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_three_sharded_steps_equal_single_device(shape):
    params = init_params(3, CFG)
    batch = fake_batch(np.random.default_rng(2), 64, CFG)
    single, l_single = run_nnue(Trainer(cfg=CFG, learning_rate=1e-3,
                                        device="cpu"), params, batch)
    sharded, l_shard = run_nnue(Trainer(cfg=CFG, mesh=cpu_mesh(*shape),
                                        learning_rate=1e-3), params, batch)
    np.testing.assert_allclose(l_shard, l_single, rtol=1e-4)
    got, want = nnue_params(sharded.params), nnue_params(single.params)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert sharded.step == 3


def test_two_sharded_runs_give_the_same_bits():
    params = init_params(4, CFG)
    batch = fake_batch(np.random.default_rng(5), 64, CFG)
    runs = [run_nnue(Trainer(cfg=CFG, mesh=cpu_mesh(4, 2)), params, batch)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    for (n, a), (m, b) in zip(runs[0][0].params.named_parameters(),
                              runs[1][0].params.named_parameters()):
        assert n == m and torch.equal(a, b), n


def test_sharded_step_equals_the_jax_sharded_step():
    """The port's 4x2 step against the JAX 4x2 step (GSPMD on the 8
    virtual CPU devices), from the JAX trainer's init carried over."""
    mesh = jax_make_mesh()
    assert mesh.devices.shape == (4, 2)
    jt = JaxTrainer(cfg=JAX_CFG, mesh=mesh, learning_rate=1e-3)
    js = jt.init(seed=3)
    params = {k: np.asarray(v) for k, v in js.params.items()}
    batch = fake_batch(np.random.default_rng(2), 64, CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pt = Trainer(cfg=CFG, mesh=cpu_mesh(4, 2), learning_rate=1e-3)
    ps = pt.init(params=params)
    for i in range(3):
        js, mj = jt.step(js, jb)
        ps, mp = pt.step(ps, batch)
        np.testing.assert_allclose(mp["loss"], float(mj["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    got = nnue_params(ps.params)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(got[k], np.asarray(js.params[k]), rtol=RTOL,
                                   atol=2e-5, err_msg=k)


def test_a_contiguous_split_of_the_pairs_is_caught(monkeypatch):
    """The JAX spec read literally (contiguous L1 blocks, no pairs)
    separates column j from its partner j + L1/2: the step must then
    miss the single-device step, which the paired layout meets."""
    literal = {k: ShardSpec(s.axis, s.dim) for k, s in param_specs().items()}
    monkeypatch.setattr(trainer_mod, "param_specs", lambda: literal)
    params = init_params(3, CFG)
    batch = fake_batch(np.random.default_rng(2), 64, CFG)
    single, l_single = run_nnue(Trainer(cfg=CFG, device="cpu"), params, batch, 1)
    wrong, l_wrong = run_nnue(Trainer(cfg=CFG, mesh=cpu_mesh(1, 2)), params,
                              batch, 1)
    assert abs(l_wrong[0] - l_single[0]) > 1e-4 * abs(l_single[0])
    got, want = nnue_params(wrong.params), nnue_params(single.params)
    assert not np.allclose(got["l1_w"], want["l1_w"], rtol=RTOL, atol=ATOL)


def test_export_is_byte_identical_from_a_sharded_trainer():
    full = NetConfig()
    params = init_params(7, full)
    params["ft_psqt"] = (np.random.default_rng(8).standard_normal(
        params["ft_psqt"].shape) * 0.02).astype(np.float32)
    single = Trainer(cfg=full, device="cpu")
    sharded = Trainer(cfg=full, mesh=cpu_mesh(1, 2))
    a = single.export(single.init(params=params))
    b = sharded.export(sharded.init(params=params))
    for field in ("ft_weight", "ft_bias", "ft_psqt", "l1_weight", "l1_bias",
                  "l2_weight", "l2_bias", "out_weight", "out_bias"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


@pytest.mark.parametrize("kind,shape", [("nnue", (1, 3)), ("az", (1, 3)),
                                        ("batch", (3, 1))])
def test_an_indivisible_mesh_is_refused(kind, shape):
    mesh = cpu_mesh(*shape)
    if kind == "nnue":
        with pytest.raises(ValueError, match="32 L1 pairs cannot be split "
                                             "over a model axis of 3"):
            Trainer(cfg=CFG, mesh=mesh)
    elif kind == "az":
        with pytest.raises(ValueError, match="cannot be split over a model "
                                             "axis of 3"):
            AzTrainer(cfg=AzConfig(channels=16, blocks=2, value_hidden=16),
                      mesh=mesh)
    else:
        trainer = Trainer(cfg=CFG, mesh=mesh)
        state = trainer.init(seed=0)
        with pytest.raises(ValueError, match="batch of 64 rows cannot be "
                                             "split over a data axis of 3"):
            trainer.step(state, fake_batch(np.random.default_rng(0), 64, CFG))


# -- AZ --------------------------------------------------------------------


def live_az_params(seed, cfg):
    """``init_az_params`` with every zero leaf given small seeded values
    (zero biases and a zero fc2 would hide the bias and value paths)."""
    params = init_az_params(seed, cfg)
    rng = np.random.default_rng(seed + 100)
    for k, v in params.items():
        if not v.any():
            params[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
    return params


def _grads(state):
    net = state.params
    if hasattr(net, "gather"):
        return {name: net.gather(name, [p.grad for p in net.leaves(name)]).numpy()
                for name in net.names}
    return {name: p.grad.numpy() for name, p in net.named_parameters()}


@pytest.mark.parametrize("shape", [factor_mesh(8), (8, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_az_step_within_bf16_tolerance(shape):
    data, model = shape
    cfg = AzConfig(channels=8 * model, blocks=2, value_hidden=16)
    params = live_az_params(1, cfg)
    batch = az_batch(np.random.default_rng(1), 8 * data)
    single = AzTrainer(cfg=cfg, device="cpu")
    s1, m1 = single.step(single.init(params=params), batch)
    sharded = AzTrainer(cfg=cfg, mesh=cpu_mesh(*shape))
    s2, m2 = sharded.step(sharded.init(params=params), batch)
    for key in ("loss", "policy_loss", "value_loss"):
        assert abs(m2[key] - m1[key]) <= 2.0 ** -8 * max(1.0, abs(m1[key])), key
    g1, g2 = _grads(s1), _grads(s2)
    for k in g1:
        bound = 0.02 if k.rsplit("_", 1)[1].startswith("w") else 0.25
        rel = np.linalg.norm(g2[k] - g1[k]) / max(np.linalg.norm(g1[k]), 1e-30)
        assert rel <= bound, (k, rel)
    # The export gathers the slices: both packages load the .npz.
    exported = jax_layout(s2.params.full_module())
    assert set(exported) == set(params)
    assert all(exported[k].shape == params[k].shape for k in params)


# -- checkpoints across placements -----------------------------------------


def _setup(kind):
    if kind == "nnue":
        cfg = NetConfig(num_features=512, max_active=8, l1=64, l2=15, l3=32)
        batch = fake_batch(np.random.default_rng(0), 8, cfg)
        return (lambda mesh: Trainer(cfg=cfg, mesh=mesh, device="cpu"), batch,
                params_to_jax)
    cfg = AzConfig(channels=16, blocks=2, value_hidden=16)
    batch = az_batch(np.random.default_rng(0), 8)
    return (lambda mesh: AzTrainer(cfg=cfg, mesh=mesh, device="cpu"), batch,
            lambda net: jax_layout(net.full_module() if hasattr(net, "full_module")
                                   else net))


@pytest.mark.parametrize("kind", ["nnue", "az"])
@pytest.mark.parametrize("start", ["sharded", "single"])
def test_resume_across_placements_is_exact(tmp_path, kind, start):
    """Two steps on one placement, a checkpoint restored into the other
    placement and saved again, restored into the first, two more steps:
    bit for bit the uninterrupted four steps (the round trip through the
    other layout loses nothing). The middle state equals the saved one
    in every gathered parameter and optimizer tensor."""
    make, batch, carry = _setup(kind)
    mesh = cpu_mesh(2, 2)
    first, other = ((mesh, None) if start == "sharded" else (None, mesh))
    trainer = make(first)
    state = trainer.init(seed=0)
    for _ in range(4):
        state, _ = trainer.step(state, batch)
    reference = carry(state.params)

    state = trainer.init(seed=0)
    for _ in range(2):
        state, _ = trainer.step(state, batch)
    save_checkpoint(tmp_path / "a.pt", state)
    there = restore_checkpoint(tmp_path / "a.pt", make(other).init(seed=1))
    assert there.step == 2
    mid = carry(there.params)
    for k, v in carry(state.params).items():
        np.testing.assert_array_equal(mid[k], v, err_msg=k)
    save_checkpoint(tmp_path / "b.pt", there)
    a, b = (torch.load(tmp_path / n, weights_only=True) for n in ("a.pt", "b.pt"))
    for name, entry in a["optimizer"]["state"].items():
        for key, value in entry.items():
            assert torch.equal(torch.as_tensor(value),
                               torch.as_tensor(b["optimizer"]["state"][name][key])), (name, key)
    back = restore_checkpoint(tmp_path / "b.pt", trainer.init(seed=2))
    for _ in range(2):
        back, _ = trainer.step(back, batch)
    assert back.step == 4
    resumed = carry(back.params)
    for k in reference:
        np.testing.assert_array_equal(reference[k], resumed[k], err_msg=k)


def test_a_sharded_checkpoint_resumes_into_a_single_device_trainer(tmp_path):
    """Saved from a 2x2 trainer, restored into a single-device one: its
    next step matches the uninterrupted sharded run's at the NNUE
    sharded-vs-single bounds."""
    make, batch, carry = _setup("nnue")
    sharded = make(cpu_mesh(2, 2))
    state = sharded.init(seed=0)
    for _ in range(2):
        state, _ = sharded.step(state, batch)
    save_checkpoint(tmp_path / "s.pt", state)
    state, m_shard = sharded.step(state, batch)
    single = make(None)
    restored = restore_checkpoint(tmp_path / "s.pt", single.init(seed=9))
    restored, m_single = single.step(restored, batch)
    np.testing.assert_allclose(m_single["loss"], m_shard["loss"], rtol=1e-4)
    want, got = carry(state.params), carry(restored.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_a_format_1_checkpoint_restores_into_a_sharded_trainer(tmp_path):
    """Format 1 (the optimizer's own state_dict, one device) still
    reads, onto any placement."""
    make, batch, carry = _setup("nnue")
    single = make(None)
    state = single.init(seed=0)
    state, _ = single.step(state, batch)
    torch.save({
        "format": "fishnet_tpu_torch.train.checkpoint/1",
        "params": {n: p.detach().clone() for n, p in state.params.named_parameters()},
        "optimizer": state.opt_state.state_dict(),
        "step": state.step,
    }, tmp_path / "v1.pt")
    sharded = make(cpu_mesh(1, 2))
    restored = restore_checkpoint(tmp_path / "v1.pt", sharded.init(seed=5))
    assert restored.step == 1
    want, got = carry(state.params), carry(restored.params)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    save_checkpoint(tmp_path / "v2.pt", restored)
    v2 = torch.load(tmp_path / "v2.pt", weights_only=True)
    for i, (name, p) in enumerate(state.params.named_parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(v2["optimizer"]["state"][name][key],
                               state.opt_state.state[p][key]), (name, key)
