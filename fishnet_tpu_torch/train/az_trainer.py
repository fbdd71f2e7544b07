"""Training step for the AlphaZero-style policy+value net on
``torch.optim``: the port of ``fishnet_tpu/train/az_trainer.py`` for one
device.

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

Left out against the JAX package: ``mesh=``, ``az_param_spec`` and
``az_batch_specs`` (sharding, the mesh slice).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from fishnet_tpu_torch.device import DeviceLike
from fishnet_tpu_torch.models.az import (
    AzConfig,
    init_az_params,
    jax_layout,
    params_from_jax,
    train_forward,
)
from fishnet_tpu_torch.search.az_plane import configure_backends
from fishnet_tpu_torch.train.trainer import TrainState, configure_device, to_device

__all__ = ["AzTrainState", "AzTrainer"]

Batch = Dict[str, object]
# keys: planes float32 [B,8,8,19]; policy_target float32 [B,4672]
#       (normalized visit counts, zero off legal moves);
#       value_target float32 [B] in [-1, 1].

#: The AZ state has the NNUE state's fields: (AzNet, optimizer, step).
AzTrainState = TrainState


class AzTrainer:
    """Owns the net, the optimizer and the step, on one device
    (``cuda`` unless asked for the CPU; without a GPU that raises).
    ``optimizer`` builds the optimizer from the parameters."""

    def __init__(
        self,
        cfg: AzConfig = AzConfig(),
        learning_rate: float = 2e-3,
        value_weight: float = 1.0,
        optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                     torch.optim.Optimizer]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg
        self.value_weight = value_weight
        # The serving plane's settings: cuDNN's autotuner off and its
        # algorithms deterministic, TF32 off, so a step's bits depend on
        # its inputs alone.
        self.device = configure_backends(configure_device(device))
        self._make_optimizer = optimizer or (
            lambda ps: torch.optim.AdamW(ps, lr=learning_rate, weight_decay=1e-4))

    def init(self, seed: int = 0,
             params: Optional[Mapping[str, np.ndarray]] = None) -> AzTrainState:
        """A fresh state: ``params`` (a JAX-layout dict) or
        ``init_az_params(seed)``, a new optimizer, step 0."""
        if params is None:
            params = init_az_params(seed, self.cfg)
        net = params_from_jax({k: np.array(v, np.float32)
                               for k, v in params.items()}, self.device)
        if net.cfg != self.cfg:
            raise ValueError(f"params are a {net.cfg}, not {self.cfg}")
        net.requires_grad_(True)
        return AzTrainState(net, self._make_optimizer(net.parameters()), 0)

    def loss(self, net, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, value = train_forward(net, batch["planes"])
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

    def export(self, state: AzTrainState, path: str) -> None:
        """Save params as the JAX-layout ``.npz`` ``--az-net-file``
        consumes (both packages)."""
        np.savez(path, **jax_layout(state.params))
