"""AlphaZero-style policy+value residual network: the port of
``fishnet_tpu/models/az.py`` as a torch ``nn.Module``.

A conv tower over 8x8x19 input planes with two heads: a 73-plane policy
(4672 logits, az_encoding.py) and a tanh value in [-1, 1] from the side
to move's perspective; the net of the batched-PUCT MCTS engine
(BASELINE.json config 5). No batch norm at inference: pre-activation
residual blocks with a plain bias, so the forward is a chain of
conv + add + relu.

Parameters travel as the JAX package's dict of float32 numpy arrays
(``init_az_params``, ``.npz`` checkpoints): HWIO conv kernels, fc
weights as ``[in, out]``. ``params_from_jax`` carries such a dict onto
an ``AzNet`` (conv kernels to OIHW), ``jax_layout`` carries it back;
the dict itself stays the net's identity
(``search/eval_cache.az_net_fingerprint`` hashes it), so one ``.npz``
keys the same cache entries in both packages.

The forward keeps the reference's bf16 arithmetic op for op, so the two
packages differ only by accumulation order inside a conv or matmul:

* every conv and matmul runs in bfloat16 and rounds its output to
  bfloat16; its bias is added as a SEPARATE bf16 op (one more rounding,
  as ``out + b.astype(x.dtype)`` in JAX), never fused into the conv;
* relu, the residual add and tanh stay in bfloat16;
* the heads flatten in NHWC order: the policy index is
  ``(r*8+f)*73 + p`` and the value head's fc1 input is ``sq*4 + c``, so
  the NCHW activations are permuted to NHWC before both reshapes.

Dev-mode weights (``init_az_params``) come from a numpy seed at the
reference's shapes and scales; ``jax.random`` draws cannot be
reproduced, so cross-package parity always loads the same ``.npz``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fishnet_tpu_torch.models.az_encoding import INPUT_PLANES

Params = Dict[str, np.ndarray]

#: Plane 17 (the halfmove clock) rides the uint8 wire as clock/100 x 100.
CLOCK_PLANE = 17


@dataclass(frozen=True)
class AzConfig:
    channels: int = 64
    blocks: int = 6
    value_hidden: int = 128
    policy_planes: int = 73

    @property
    def policy_size(self) -> int:
        return 64 * self.policy_planes


def param_shapes(cfg: AzConfig = AzConfig()) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape in the JAX layout (HWIO kernels, fc
    weights ``[in, out]``), in the JAX package's key order."""
    c = cfg.channels
    shapes = {
        "stem_w": (3, 3, INPUT_PLANES, c),
        "stem_b": (c,),
        "policy_w": (1, 1, c, cfg.policy_planes),
        "policy_b": (cfg.policy_planes,),
        "value_w": (1, 1, c, 4),
        "value_b": (4,),
        "value_fc1_w": (4 * 64, cfg.value_hidden),
        "value_fc1_b": (cfg.value_hidden,),
        "value_fc2_w": (cfg.value_hidden, 1),
        "value_fc2_b": (1,),
    }
    for i in range(cfg.blocks):
        shapes[f"res{i}_w1"] = (3, 3, c, c)
        shapes[f"res{i}_b1"] = (c,)
        shapes[f"res{i}_w2"] = (3, 3, c, c)
        shapes[f"res{i}_b2"] = (c,)
    return shapes


def init_az_params(seed: int = 0, cfg: AzConfig = AzConfig()) -> Params:
    """Random float32 parameters from a numpy seed, at the reference's
    shapes and scales (He-normal kernels and fc1, zero biases and fc2)."""
    rng = np.random.default_rng(seed)
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name.rsplit("_", 1)[1].startswith("b") or name == "value_fc2_w":
            params[name] = np.zeros(shape, np.float32)
            continue
        fan_in = int(np.prod(shape[:-1]))  # k*k*cin, or fc1's 4*64
        scale = np.float32(np.sqrt(2.0 / fan_in))
        params[name] = (rng.standard_normal(shape, dtype=np.float32)
                        * scale).astype(np.float32)
    return params


def load_az_params(path: str) -> Params:
    """A ``.npz`` checkpoint as the JAX-layout dict of numpy arrays."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def az_config_from_params(params) -> AzConfig:
    """Recover the architecture a checkpoint was trained with: every
    AzConfig field follows from parameter shapes, so ``.npz``
    checkpoints carry no architecture metadata. Raises ValueError when
    the dict is not an AZ checkpoint or matches no AzConfig."""
    required = ("stem_b", "policy_b", "value_fc1_b")
    missing = [k for k in required if k not in params]
    if missing:
        raise ValueError(
            f"not an AZ checkpoint: missing parameter(s) {missing}; "
            f"got keys {sorted(params)[:8]}..."
        )
    blocks = 0
    while f"res{blocks}_w1" in params:
        blocks += 1
    cfg = AzConfig(
        channels=int(np.shape(params["stem_b"])[0]),
        blocks=blocks,
        value_hidden=int(np.shape(params["value_fc1_b"])[0]),
        policy_planes=int(np.shape(params["policy_b"])[0]),
    )
    expected = param_shapes(cfg)
    got = {k: tuple(np.shape(v)) for k, v in params.items()}
    if expected != got:
        diff = set(expected) ^ set(got) or {
            k for k in expected if expected[k] != got.get(k)
        }
        raise ValueError(
            f"AZ checkpoint does not match any {cfg}: mismatched keys {sorted(diff)}"
        )
    return cfg


def value_to_centipawns(v: float) -> int:
    """Map a [-1, 1] value-head output to centipawns for the fishnet
    protocol (the tan mapping family Lc0 uses for UCI output)."""
    v = float(np.clip(v, -0.9999, 0.9999))
    return int(round(111.7 * np.tan(1.5620688421 * v)))


def _torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """A JAX-layout array in the module's layout: HWIO kernels -> OIHW."""
    if arr.ndim == 4:
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    return arr


class AzNet(nn.Module):
    """The tower's parameters (float32, torch layout: OIHW kernels, fc
    weights ``[in, out]``). ``forward`` is :func:`az_forward`."""

    def __init__(self, cfg: AzConfig = AzConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        for name, shape in param_shapes(cfg).items():
            if len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=False))
        self._bf16: Optional[Dict[str, torch.Tensor]] = None

    def bf16_weights(self) -> Dict[str, torch.Tensor]:
        """The parameters cast to bfloat16 once (conv kernels in
        channels-last memory on the GPU, where cuDNN runs NHWC); dropped
        by :meth:`load_jax`."""
        if self._bf16 is None:
            out = {}
            for name, p in self.named_parameters():
                w = p.detach().to(torch.bfloat16)
                if w.dim() == 4 and w.is_cuda:
                    w = w.contiguous(memory_format=torch.channels_last)
                out[name] = w
            self._bf16 = out
        return self._bf16

    def load_jax(self, params: Params) -> "AzNet":
        """Copy a JAX-layout dict of numpy arrays into the parameters."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                arr = _torch_layout(name, np.asarray(params[name], np.float32))
                p.copy_(torch.from_numpy(arr))
        self._bf16 = None
        return self

    def forward(self, planes: torch.Tensor):
        return az_forward(self, planes)


def params_from_jax(params: Union[Params, str],
                    device: Union[str, torch.device, None] = None) -> AzNet:
    """The weight carry: a JAX-layout dict of numpy arrays (or a ``.npz``
    path) onto a new AzNet on ``device`` (resolved by the caller: the
    CPU unless given), its AzConfig read from the shapes."""
    if isinstance(params, str):
        params = load_az_params(params)
    net = AzNet(az_config_from_params(params)).load_jax(params)
    return net.to(device) if device is not None else net


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # "SAME" padding for the odd kernels (3x3 -> 1, 1x1 -> 0); the bias
    # is its own rounded bf16 op, as in the reference.
    out = F.conv2d(x, w, padding=w.shape[-1] // 2)
    return out + b.view(1, -1, 1, 1)


def _tower(net: AzNet, x: torch.Tensor, w: Optional[Dict[str, torch.Tensor]] = None,
           conv=_conv):
    """bf16 NHWC planes [B, 8, 8, 19] -> (flat policy logits [B, P],
    value [B]), both bf16; ``w`` the bf16 weights (default: the net's
    cached copies); ``conv`` runs the stem and residual convs (the
    sharded AZ trainer's splits them by output channel)."""
    if w is None:
        w = net.bf16_weights()
    x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels-last)
    x = torch.relu(conv(x, w["stem_w"], w["stem_b"]))
    for i in range(net.cfg.blocks):
        h = torch.relu(conv(x, w[f"res{i}_w1"], w[f"res{i}_b1"]))
        h = conv(h, w[f"res{i}_w2"], w[f"res{i}_b2"])
        x = torch.relu(x + h)
    pol = _conv(x, w["policy_w"], w["policy_b"])
    pol = pol.permute(0, 2, 3, 1).reshape(pol.shape[0], -1)
    v = torch.relu(_conv(x, w["value_w"], w["value_b"]))
    v = v.permute(0, 2, 3, 1).reshape(v.shape[0], -1)
    v = torch.relu(v @ w["value_fc1_w"] + w["value_fc1_b"])
    v = torch.tanh(v @ w["value_fc2_w"] + w["value_fc2_b"])
    return pol, v[:, 0]


def az_forward(net: AzNet, planes: torch.Tensor):
    """planes [B, 8, 8, 19] -> (policy_logits [B, 4672], value [B]),
    float32; the tower computes in bfloat16."""
    with torch.no_grad():
        pol, v = _tower(net, planes.to(torch.bfloat16))
        return pol.float(), v.float()


def train_forward(net: AzNet, planes: torch.Tensor):
    """The forward with gradients (the AZ trainer's): ``az_forward``'s
    arithmetic — every parameter cast to bfloat16, bf16 convs and
    matmuls, each bias its own bf16 op — with autograd running through
    the casts back to the float32 parameters, as ``jax.grad`` runs
    through ``astype``. planes float [B, 8, 8, 19] -> (policy_logits
    [B, 4672], value [B]), float32."""
    w = {name: p.to(torch.bfloat16) for name, p in net.named_parameters()}
    pol, v = _tower(net, planes.to(torch.bfloat16), w)
    return pol.float(), v.float()


def jax_layout(net: AzNet) -> Params:
    """The reverse of the weight carry: the net's parameters as the JAX
    package's dict of float32 numpy arrays (OIHW kernels back to HWIO),
    the layout an ``.npz`` for ``--az-net-file`` holds."""
    out: Params = {}
    for name, p in net.named_parameters():
        arr = p.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        out[name] = np.ascontiguousarray(arr, np.float32)
    return out


def wire_forward(net: AzNet, planes_u8: torch.Tensor):
    """The dispatch wire's forward (the reference's jitted wrapper around
    ``az_forward``): uint8 planes [B, 8, 8, 19], plane 17 carrying the
    halfmove clock x100 -> (fp16 logits [B, 4672], float32 values [B]).
    The clock plane is scaled by ``1.0 / 100.0`` in float32 before the
    bf16 cast, as the reference multiplies (never divides)."""
    with torch.no_grad():
        x = planes_u8.to(torch.float32)
        x[..., CLOCK_PLANE] *= 1.0 / 100.0
        pol, v = _tower(net, x.to(torch.bfloat16))
        return pol.float().to(torch.float16), v.float()
