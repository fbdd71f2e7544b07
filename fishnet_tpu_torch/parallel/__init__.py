"""Multi-device serving: the device list a service drives, the shard
router, and the sharded NNUE evaluators. See mesh.py for the design."""

from fishnet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    ShardedEvaluator,
    ShardedSegmentedEvaluator,
    ShardRouter,
    factor_mesh,
    make_mesh,
    pad_to_multiple,
    replicate_params,
    serving_devices,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "ShardRouter",
    "ShardedEvaluator",
    "ShardedSegmentedEvaluator",
    "factor_mesh",
    "make_mesh",
    "pad_to_multiple",
    "replicate_params",
    "serving_devices",
]
