"""NNUE training step on ``torch.optim``: the port of
``fishnet_tpu/train/trainer.py`` for one device.

Loss (standard NNUE recipe): squared error in WDL space between
sigmoid(pred_cp / SIGMOID_SCALE) and an interpolation of the teacher
score and the game outcome. One step: forward, backward, Adam, then
``clip_params`` in place.

The API keeps the JAX package's shapes, so a test can drive both the
same way: ``init(seed) -> state``, ``step(state, batch) -> (state,
metrics)``, ``export(state) -> NnueWeights``. The state holds the
module and its optimizer, and ``step`` advances them in place (the JAX
step donates its input state too). ``init(params=...)`` starts from a
JAX-layout dict of numpy arrays, the weight carry.

On CUDA (the default device; without a GPU it raises) TF32 stays off
for the float32 matmuls, so a step on the card holds to the CPU's
within float32 rounding (ROADMAP C2). The FT gradient is a scatter-add
into the [F, L1] table (``embedding_bag``'s backward); whether its
order is fixed on the card is measured by ``chip_smoke.py``'s train
phase.

Left out against the JAX package: ``mesh=``, ``param_specs`` and
``batch_specs`` (sharding, the mesh slice).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fishnet_tpu_torch.device import DeviceLike, resolve_device
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.train import model as model_lib
from fishnet_tpu_torch.train.model import NNUE2SCORE, NetConfig

__all__ = ["Batch", "SIGMOID_SCALE", "TrainState", "Trainer", "to_device"]

SIGMOID_SCALE = 410.0  # cp -> expected-score squash

Batch = Dict[str, object]
# keys: indices int32 [B,2,A]; buckets int32 [B];
#       score_cp float32 [B] (teacher eval); outcome float32 [B] in {0,.5,1}
#       (numpy arrays or tensors)


class TrainState(NamedTuple):
    params: torch.nn.Module  # train.model.NnueNet or models.az.AzNet
    opt_state: torch.optim.Optimizer
    step: int


def to_device(batch: Mapping[str, object], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def configure_device(device: DeviceLike) -> torch.device:
    """The trainers' device (``cuda`` unless asked for the CPU; a CUDA
    request without a GPU raises), with TF32 off."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class Trainer:
    """Owns the model, the optimizer and the step, on one device.

    ``optimizer`` builds the optimizer from the parameters (default
    ``torch.optim.Adam(lr=learning_rate)``, optax's ``adam`` defaults:
    betas 0.9 / 0.999, eps 1e-8)."""

    def __init__(
        self,
        cfg: NetConfig = NetConfig(),
        learning_rate: float = 8e-4,
        wdl_lambda: float = 0.75,
        optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                     torch.optim.Optimizer]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg
        self.wdl_lambda = wdl_lambda
        self.device = configure_device(device)
        self._make_optimizer = optimizer or (
            lambda ps: torch.optim.Adam(ps, lr=learning_rate))

    def init(self, seed: int = 0,
             params: Optional[Mapping[str, np.ndarray]] = None) -> TrainState:
        """A fresh state: ``params`` (a JAX-layout dict) or
        ``init_params(seed)``, a new optimizer, step 0."""
        if params is None:
            params = model_lib.init_params(seed, self.cfg)
        net = model_lib.params_from_jax(params, self.cfg, self.device)
        return TrainState(net, self._make_optimizer(net.parameters()), 0)

    def loss(self, params: Mapping[str, torch.Tensor],
             batch: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, pred_cp) of ``batch`` (tensors on the device)."""
        pred_cp = model_lib.forward(params, batch["indices"], batch["buckets"],
                                    self.cfg) * NNUE2SCORE
        q = torch.sigmoid(pred_cp / SIGMOID_SCALE)
        t_score = torch.sigmoid(batch["score_cp"] / SIGMOID_SCALE)
        t = self.wdl_lambda * t_score + (1.0 - self.wdl_lambda) * batch["outcome"]
        return torch.mean(torch.square(q - t)), pred_cp

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, float]]:
        """One optimizer step on ``batch``; returns the advanced state and
        the metrics ``loss``, ``pred_cp_mean``, ``pred_cp_abs`` (floats,
        of the batch before the step)."""
        net, opt = state.params, state.opt_state
        data = to_device(batch, self.device)
        opt.zero_grad(set_to_none=True)
        loss, pred_cp = self.loss(net, data)
        loss.backward()
        opt.step()
        model_lib.clip_params(net)
        with torch.no_grad():
            stats = torch.stack([loss.detach(), pred_cp.mean(),
                                 pred_cp.abs().mean()]).cpu().tolist()
        metrics = dict(zip(("loss", "pred_cp_mean", "pred_cp_abs"), stats))
        return TrainState(net, opt, state.step + 1), metrics

    def export(self, state: TrainState) -> NnueWeights:
        """Quantize trained params into serving weights."""
        return model_lib.quantize(state.params, self.cfg)
