"""NNUE training step on ``torch.optim``: the port of
``fishnet_tpu/train/trainer.py``, on one device or sharded over the
port's ``Mesh``.

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

Sharding (``Trainer(mesh=...)``, a ``parallel.mesh.Mesh`` of
``data x model`` devices; ``mesh=None`` is the single-device trainer
above, unchanged). The JAX trainer annotates its step (GSPMD); here the
work is split by hand in one process (``train/sharding.py``), and a
sharded step computes the single-device step's numbers within float32
rounding (on the CPU within rtol 2e-4 / atol 2e-6 everywhere; on the
card cuBLAS sums a slice's products in an order chosen by its rows, so
an activation on a clamp's edge can round to the other side, and Adam,
an update of ~lr x g / |g|, carries such noise to up to 2 x lr in a few
entries whose gradient is small: PERF.md §6):

* **model axis.** ``param_specs()`` splits ``ft_w`` by column, ``ft_b``,
  and ``l1_w`` by its last (input) axis. Unlike the JAX layout, which
  cuts the L1 axis into contiguous blocks and lets GSPMD fetch each
  partner column, model shard ``m`` holds a block ``J_m`` of the PAIR
  indices ``[0, L1/2)``: the ``ft_w`` / ``ft_b`` columns ``J_m`` and
  ``L1/2 + J_m`` side by side in one contiguous ``[F, 2|J_m|]`` table
  (so ``embedding_bag``'s backward is the same scatter as one device's),
  and ``l1_w[..., J_m]`` beside ``l1_w[..., L1/2 + J_m]``. The forward
  multiplies column ``j`` by column ``j + L1/2``, so every pair stays on
  one device: each shard computes its partial L1 product, and the parts
  are summed on the replica's first device in shard order, where
  ``ft_psqt``, ``l1_b``, ``l2_*`` and ``out_*`` (replicated) finish the
  forward. ``L1/2`` must divide by ``model``;
* **data axis.** Row ``d`` of the grid takes batch slice ``d`` (in
  order, the JAX ``P("data")`` blocks); each slice's loss is weighted by
  its rows over ``B``, so the loss is the full batch's mean. The batch
  must divide by ``data``;
* **the step.** Each parameter slice lives once, on grid row 0; the
  other rows compute on copies, and their gradients are summed onto the
  slice in row order, so two sharded runs give the same bits. One
  ``torch.optim`` step runs over the slices (the Adam state beside each
  slice), then ``clip_params`` on each slice. ``export`` gathers the
  slices into the JAX layout: the ``NnueWeights`` are byte-identical to
  the single-device export of the same parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fishnet_tpu_torch.device import DeviceLike, resolve_device
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from fishnet_tpu_torch.train import model as model_lib
from fishnet_tpu_torch.train.model import NNUE2SCORE, NetConfig
from fishnet_tpu_torch.train.sharding import (
    REPLICATED,
    ShardSpec,
    ShardedParams,
    check_model_split,
    mesh_devices,
    split_batch,
)

__all__ = ["Batch", "SIGMOID_SCALE", "TrainState", "Trainer", "batch_specs",
           "param_specs", "to_device"]

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


def param_specs() -> Dict[str, ShardSpec]:
    """The placement spec of every parameter (the JAX ``PartitionSpec``
    dict's counterpart). Only tensors with an L1 dimension are split
    over ``model``, as L1 pairs; everything else is replicated."""
    return {
        "ft_w": ShardSpec(MODEL_AXIS, 1, paired=True),
        "ft_b": ShardSpec(MODEL_AXIS, 0, paired=True),
        "ft_psqt": REPLICATED,
        "l1_w": ShardSpec(MODEL_AXIS, 2, paired=True),
        "l1_b": REPLICATED,
        "l2_w": REPLICATED,
        "l2_b": REPLICATED,
        "out_w": REPLICATED,
        "out_b": REPLICATED,
    }


def batch_specs() -> Dict[str, ShardSpec]:
    """Every batch key is split over ``data`` on its first dimension."""
    return {
        "indices": ShardSpec(DATA_AXIS),
        "buckets": ShardSpec(DATA_AXIS),
        "score_cp": ShardSpec(DATA_AXIS),
        "outcome": ShardSpec(DATA_AXIS),
    }


def configure_device(device: DeviceLike) -> torch.device:
    """The trainers' device (``cuda`` unless asked for the CPU; a CUDA
    request without a GPU raises), with TF32 off."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def configure_mesh(mesh: Mesh) -> torch.device:
    """``configure_device`` for every device of ``mesh``; returns its
    first (the replicas' home)."""
    for dev in reversed(mesh_devices(mesh)):
        configure_device(dev)
    return mesh.grid[0][0]


class Trainer:
    """Owns the model, the optimizer and the step, on one device or
    sharded over ``mesh`` (``device`` is then the mesh's first).

    ``optimizer`` builds the optimizer from the parameters (default
    ``torch.optim.Adam(lr=learning_rate)``, optax's ``adam`` defaults:
    betas 0.9 / 0.999, eps 1e-8)."""

    def __init__(
        self,
        cfg: NetConfig = NetConfig(),
        mesh: Optional[Mesh] = None,
        learning_rate: float = 8e-4,
        wdl_lambda: float = 0.75,
        optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                     torch.optim.Optimizer]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.wdl_lambda = wdl_lambda
        self.device = (configure_device(device) if mesh is None
                       else configure_mesh(mesh))
        self._make_optimizer = optimizer or (
            lambda ps: torch.optim.Adam(ps, lr=learning_rate))
        if mesh is not None:  # refuse a model axis L1/2 cannot take
            for name, spec in param_specs().items():
                check_model_split(name, cfg.shapes()[name], spec, mesh.shape[1])

    def init(self, seed: int = 0,
             params: Optional[Mapping[str, np.ndarray]] = None) -> TrainState:
        """A fresh state: ``params`` (a JAX-layout dict) or
        ``init_params(seed)``, a new optimizer, step 0."""
        if params is None:
            params = model_lib.init_params(seed, self.cfg)
        if self.mesh is None:
            net = model_lib.params_from_jax(params, self.cfg, self.device)
        else:
            full = model_lib.params_from_jax(params, self.cfg)
            net = ShardedParams(lambda: model_lib.NnueNet(self.cfg),
                                param_specs(), self.mesh)
            for name in net.names:
                net.load_full(name, full[name].detach())
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
        if self.mesh is not None:
            return self._sharded_step(state, batch)
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

    # -- the sharded step -------------------------------------------------

    def _slice_loss(self, p: Mapping[str, List[torch.Tensor]],
                    data: Mapping[str, torch.Tensor],
                    row: Tuple[torch.device, ...]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, pred_cp) of one data row's slice: each model shard's
        partial L1 product over its pairs, summed in shard order on the
        row's first device, then the replicated head."""
        home = row[0]
        safe, mask = model_lib.feature_mask(data["indices"], self.cfg)
        y_all = None
        for m, (ft_w, ft_b, l1_w) in enumerate(zip(p["ft_w"], p["ft_b"], p["l1_w"])):
            dev = ft_w.device
            acc = ft_b + model_lib._bag_sum(ft_w, safe.to(dev), mask.to(dev))
            part = model_lib._einsum_bko(model_lib.pair_product(acc), l1_w).to(home)
            y_all = part if y_all is None else y_all + part
        rep = {k: v[0] for k, v in p.items()}
        y_all = y_all + rep["l1_b"][None]
        psqt = model_lib._bag_sum(rep["ft_psqt"], safe, mask)
        pred_cp = model_lib.head(rep, y_all, psqt, data["buckets"],
                                 self.cfg) * NNUE2SCORE
        q = torch.sigmoid(pred_cp / SIGMOID_SCALE)
        t_score = torch.sigmoid(data["score_cp"] / SIGMOID_SCALE)
        t = self.wdl_lambda * t_score + (1.0 - self.wdl_lambda) * data["outcome"]
        return torch.mean(torch.square(q - t)), pred_cp

    def _sharded_step(self, state: TrainState, batch: Batch
                      ) -> Tuple[TrainState, Dict[str, float]]:
        net, opt = state.params, state.opt_state
        slices = split_batch(batch, self.mesh)
        rows = sum(len(s["buckets"]) for s in slices)
        opt.zero_grad(set_to_none=True)
        replicas, losses, preds = [], [], []
        for d, data in enumerate(slices):
            rep = net.replica(d)
            replicas.append(rep)
            loss, pred_cp = self._slice_loss(rep, data, self.mesh.grid[d])
            weighted = loss * (len(data["buckets"]) / rows)
            weighted.backward()
            losses.append(weighted.detach().to(self.device))
            preds.append(pred_cp.detach().to(self.device))
        net.reduce_grads(replicas)
        opt.step()
        clip_sharded(net)
        with torch.no_grad():
            loss = losses[0]
            for part in losses[1:]:
                loss = loss + part
            pred_cp = torch.cat(preds)
            stats = torch.stack([loss, pred_cp.mean(),
                                 pred_cp.abs().mean()]).cpu().tolist()
        metrics = dict(zip(("loss", "pred_cp_mean", "pred_cp_abs"), stats))
        return TrainState(net, opt, state.step + 1), metrics

    def export(self, state: TrainState) -> NnueWeights:
        """Quantize trained params into serving weights (a sharded net's
        slices gathered into the JAX layout first)."""
        net = state.params
        if isinstance(net, ShardedParams):
            net = net.full_module()
        return model_lib.quantize(net, self.cfg)


def clip_sharded(net: ShardedParams) -> None:
    """``clip_params`` on every slice of the clipped weights."""
    with torch.no_grad():
        for name, bound in (("l1_w", model_lib.HIDDEN_WEIGHT_CLIP),
                            ("l2_w", model_lib.HIDDEN_WEIGHT_CLIP),
                            ("out_w", model_lib.OUT_WEIGHT_CLIP)):
            for leaf in net.leaves(name):
                leaf.clamp_(-bound, bound)
