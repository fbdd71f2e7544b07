"""Training subsystems on ``torch.optim``: NNUE (float model +
quantization export) and the AlphaZero-style policy+value family, on one
device. The port of ``fishnet_tpu/train/`` without its sharding specs
(the mesh slice)."""

from fishnet_tpu_torch.train.az_trainer import AzTrainer, AzTrainState
from fishnet_tpu_torch.train.model import NetConfig, clip_params, forward, init_params, quantize
from fishnet_tpu_torch.train.trainer import Batch, Trainer, TrainState

__all__ = [
    "AzTrainer",
    "AzTrainState",
    "Batch",
    "NetConfig",
    "Trainer",
    "TrainState",
    "clip_params",
    "forward",
    "init_params",
    "quantize",
]
