"""Training subsystems on ``torch.optim``: NNUE (float model +
quantization export) and the AlphaZero-style policy+value family, both
with sharded trainers over the port's ``Mesh`` (``train/sharding.py``).
The port of ``fishnet_tpu/train/``; the placement specs are the port's
own ``ShardSpec`` values."""

from fishnet_tpu_torch.train.az_trainer import (
    AzTrainer,
    AzTrainState,
    az_batch_specs,
    az_param_spec,
)
from fishnet_tpu_torch.train.model import NetConfig, clip_params, forward, init_params, quantize
from fishnet_tpu_torch.train.sharding import ShardSpec
from fishnet_tpu_torch.train.trainer import Batch, Trainer, TrainState, batch_specs, param_specs

__all__ = [
    "AzTrainer",
    "AzTrainState",
    "Batch",
    "NetConfig",
    "ShardSpec",
    "Trainer",
    "TrainState",
    "az_batch_specs",
    "az_param_spec",
    "batch_specs",
    "clip_params",
    "forward",
    "init_params",
    "param_specs",
    "quantize",
]
