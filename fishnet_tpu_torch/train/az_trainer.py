"""Training step for the AlphaZero-style policy+value net on
``torch.optim``: the port of ``fishnet_tpu/train/az_trainer.py``, on one
device or sharded over the port's ``Mesh``.

Loss (the AlphaZero recipe): cross-entropy between the policy head and
MCTS visit-count targets (masked by the targets: an illegal move has a
zero target and contributes nothing; log-softmax over all 4672
logits), plus ``value_weight`` x the MSE between the value head and the
game outcome; weight decay comes from the optimizer,
``torch.optim.AdamW(lr=2e-3, weight_decay=1e-4)``, which decays every
parameter, biases included, as optax's ``adamw`` does.

The forward is ``models/az.py:train_forward``: the serving tower's bf16
arithmetic with float32 master parameters, autograd running through the
casts (the JAX trainer differentiates ``az_forward`` the same way). The
two packages sum a conv's products in other orders, so a step agrees
with the JAX one within bf16 rounding, not bit for bit.

``export(state, path)`` writes the JAX-layout ``.npz`` (HWIO kernels)
that both packages' ``--az-net-file`` load, with equal
``az_net_fingerprint``.

Sharding (``AzTrainer(mesh=...)``; ``mesh=None`` is the single-device
trainer, unchanged), split by hand as the NNUE trainer's
(``train/sharding.py``): ``az_param_spec`` splits the stem and residual
kernels over ``model`` by output channel; each model shard computes its
output channels of the conv over the full input, and the outputs are
concatenated in channel order on the replica's first device before the
bias, the ReLU and the next conv. The tower has no normalisation layer,
so the split is exact per channel. Biases and heads are replicated; the
batch is split over ``data`` (``az_batch_specs``), each slice's loss
weighted by its rows over ``B``, and the rows' gradients summed onto
each slice in row order. ``AdamW`` decays every slice. ``export``
gathers the slices into the JAX-layout ``.npz`` (equal
``az_net_fingerprint``). A conv's products sum in an order that depends
on its shapes, so a sharded step agrees with the single-device one
within bf16 rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

import torch.nn.functional as F

from fishnet_tpu_torch.device import DeviceLike
from fishnet_tpu_torch.models.az import (
    AzConfig,
    AzNet,
    _conv,
    _tower,
    init_az_params,
    jax_layout,
    params_from_jax,
    train_forward,
)
from fishnet_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from fishnet_tpu_torch.search.az_plane import configure_backends
from fishnet_tpu_torch.train.sharding import (
    REPLICATED,
    ShardSpec,
    ShardedParams,
    check_model_split,
    mesh_devices,
    split_batch,
)
from fishnet_tpu_torch.train.trainer import (
    TrainState,
    configure_device,
    configure_mesh,
    to_device,
)

__all__ = ["AzTrainState", "AzTrainer", "az_batch_specs", "az_param_spec"]

Batch = Dict[str, object]
# keys: planes float32 [B,8,8,19]; policy_target float32 [B,4672]
#       (normalized visit counts, zero off legal moves);
#       value_target float32 [B] in [-1, 1].

#: The AZ state has the NNUE state's fields: (AzNet, optimizer, step).
AzTrainState = TrainState


def az_param_spec(name: str, value=None) -> ShardSpec:
    """Split the stem and residual conv kernels' output channels over
    ``model`` (dimension 0 of the port's OIHW layout, 3 of the JAX
    HWIO); replicate biases and the small heads."""
    if name.endswith(("_w1", "_w2")) or name == "stem_w":
        return ShardSpec(MODEL_AXIS, 0)
    return REPLICATED


def az_batch_specs() -> Dict[str, ShardSpec]:
    return {
        "planes": ShardSpec(DATA_AXIS),
        "policy_target": ShardSpec(DATA_AXIS),
        "value_target": ShardSpec(DATA_AXIS),
    }


def _split_conv(x: torch.Tensor, w, b: torch.Tensor) -> torch.Tensor:
    """``models/az._conv`` over a kernel split by output channel: each
    shard's channels over the full input on its own device, concatenated
    in channel order on ``x``'s device, then the bias as its own op."""
    if not isinstance(w, list):
        return _conv(x, w, b)
    outs = [F.conv2d(x.to(part.device), part, padding=part.shape[-1] // 2)
            .to(x.device) for part in w]
    return torch.cat(outs, dim=1) + b.view(1, -1, 1, 1)


class AzTrainer:
    """Owns the net, the optimizer and the step, on one device
    (``cuda`` unless asked for the CPU; without a GPU that raises).
    ``optimizer`` builds the optimizer from the parameters."""

    def __init__(
        self,
        cfg: AzConfig = AzConfig(),
        mesh: Optional[Mesh] = None,
        learning_rate: float = 2e-3,
        value_weight: float = 1.0,
        optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                     torch.optim.Optimizer]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.value_weight = value_weight
        # The serving plane's settings: cuDNN's autotuner off and its
        # algorithms deterministic, TF32 off, so a step's bits depend on
        # its inputs alone.
        if mesh is None:
            self.device = configure_backends(configure_device(device))
        else:
            self.device = configure_mesh(mesh)
            for dev in mesh_devices(mesh):
                configure_backends(dev)
            for name, p in AzNet(cfg).named_parameters():
                check_model_split(name, p.shape, az_param_spec(name),
                                  mesh.shape[1])
        self._make_optimizer = optimizer or (
            lambda ps: torch.optim.AdamW(ps, lr=learning_rate, weight_decay=1e-4))

    def init(self, seed: int = 0,
             params: Optional[Mapping[str, np.ndarray]] = None) -> AzTrainState:
        """A fresh state: ``params`` (a JAX-layout dict) or
        ``init_az_params(seed)``, a new optimizer, step 0."""
        if params is None:
            params = init_az_params(seed, self.cfg)
        params = {k: np.array(v, np.float32) for k, v in params.items()}
        net = params_from_jax(params, None if self.mesh else self.device)
        if net.cfg != self.cfg:
            raise ValueError(f"params are a {net.cfg}, not {self.cfg}")
        if self.mesh is not None:
            full, cfg = net, self.cfg
            net = ShardedParams(lambda: AzNet(cfg),
                                {k: az_param_spec(k) for k in params}, self.mesh)
            for name, p in full.named_parameters():
                net.load_full(name, p.detach())
        net.requires_grad_(True)
        return AzTrainState(net, self._make_optimizer(net.parameters()), 0)

    def loss(self, net, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, value = train_forward(net, batch["planes"])
        return self._loss_terms(logits, value, batch)

    def _loss_terms(self, logits: torch.Tensor, value: torch.Tensor,
                    batch: Mapping[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        target = batch["policy_target"]
        logp = torch.log_softmax(logits, dim=-1)
        policy_loss = -torch.mean(torch.sum(target * logp, dim=-1))
        value_loss = torch.mean((value - batch["value_target"]) ** 2)
        loss = policy_loss + self.value_weight * value_loss
        return loss, {"loss": loss, "policy_loss": policy_loss,
                      "value_loss": value_loss}

    def step(self, state: AzTrainState, batch: Batch) -> Tuple[AzTrainState, Dict[str, float]]:
        """One optimizer step; returns the advanced state and the metrics
        ``loss``, ``policy_loss``, ``value_loss`` (floats, of the batch
        before the step)."""
        if self.mesh is not None:
            return self._sharded_step(state, batch)
        net, opt = state.params, state.opt_state
        data = to_device(batch, self.device)
        opt.zero_grad(set_to_none=True)
        loss, metrics = self.loss(net, data)
        loss.backward()
        opt.step()
        net._bf16 = None  # the serving forward's cast copies are stale
        names = list(metrics)
        with torch.no_grad():
            vals = torch.stack([metrics[k].detach() for k in names]).cpu().tolist()
        return AzTrainState(net, opt, state.step + 1), dict(zip(names, vals))

    def _sharded_step(self, state: AzTrainState, batch: Batch
                      ) -> Tuple[AzTrainState, Dict[str, float]]:
        net, opt = state.params, state.opt_state
        slices = split_batch(batch, self.mesh)
        rows = sum(len(s["value_target"]) for s in slices)
        opt.zero_grad(set_to_none=True)
        replicas, totals = [], None
        for d, data in enumerate(slices):
            rep = net.replica(d)
            replicas.append(rep)
            w = {name: ([t.to(torch.bfloat16) for t in parts] if net.split(name)
                        else parts[0].to(torch.bfloat16))
                 for name, parts in rep.items()}
            pol, v = _tower(net, data["planes"].to(torch.bfloat16), w, _split_conv)
            _, metrics = self._loss_terms(pol.float(), v.float(), data)
            share = len(data["value_target"]) / rows
            weighted = {k: m * share for k, m in metrics.items()}
            weighted["loss"].backward()
            part = torch.stack([weighted[k].detach() for k in
                                ("loss", "policy_loss", "value_loss")]).to(self.device)
            totals = part if totals is None else totals + part
        net.reduce_grads(replicas)
        opt.step()
        vals = totals.cpu().tolist()
        return (AzTrainState(net, opt, state.step + 1),
                dict(zip(("loss", "policy_loss", "value_loss"), vals)))

    def export(self, state: AzTrainState, path: str) -> None:
        """Save params as the JAX-layout ``.npz`` ``--az-net-file``
        consumes (both packages); a sharded net's slices gathered
        first."""
        net = state.params
        if isinstance(net, ShardedParams):
            net = net.full_module()
        np.savez(path, **jax_layout(net))
